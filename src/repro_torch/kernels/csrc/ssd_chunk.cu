// Mamba-2 SSD intra-chunk dual form:
//
//   y[q, p] = sum_{k <= q} exp(cum[q] - cum[k]) * (C_q . B_k) * xdt[k, p]
//
// per (batch, chunk, head), with cum the in-chunk inclusive cumsum of da.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk.py
// (ssd_intra_chunk, _kernel).  The TPU kernel holds the whole Q x Q decay
// and C.B^T tile in VMEM (256 KB of f32 at Q = 256), more than the 227 KB a
// Hopper block may use; here the (q, k) square is walked in 64 x 64 tiles
// and only the lower triangle of tiles is visited.
//
// What bounds it on an H100: operations.  Per (batch, chunk) the causal
// triangle holds Q(Q+1)/2 pairs; each costs 2P + 3 flops per head (decay
// and output) and 2N per group for the score C_q . B_k, which the H / G
// heads of a group share.  Against 2(Q P) floats of traffic per head that
// is ~33 flops a byte at Q = 256, P = N = 64, above the card's ridge.
//
// What the design does about it:
// - One block per (batch * chunk, group, slab of R heads of the group; the
//   wrapper picks R <= 8, the last slab of a group may hold fewer).  For a
//   64-row q tile the block computes the scores C_q . B_k^T of up to four
//   k tiles once into shared memory (64 x 256 f32), then every head of the
//   slab applies its own decay and causal mask to them and multiplies by
//   its xdt tile.  The score work is divided by R (zamba2: 56 heads a
//   group, R = 8); past four k tiles (Q > 256) the next four take the
//   shared scores' place and the heads add onto their earlier output.
// - Both products run on the tensor cores as 3xTF32: each f32 operand is
//   split into a TF32 head and a TF32 remainder (bit masks, no rounding
//   instructions) and three mma.sync m16n8k8 (lo.hi + hi.lo + hi.hi)
//   accumulate into f32: products within ~2^-19 of f32's, where the
//   reference holds this kernel at 1e-4.  Bound at the TF32 rate: three
//   products per f32 product at 495 TFLOP/s.
// - Operand tiles (C and B in 32-column chunks, or xdt with its 64 decay
//   sums) stream through two shared-memory stages by cp.async: the next
//   tile's copy runs while this one's products do.  The per-head in-chunk
//   cumsum is a warp scan at the block's start (one warp a head), kept in
//   a scratch row per (batch * chunk, head) that the wrapper allocates.
// - A decay is one exp2 of a difference of cumsums kept times log2(e);
//   only the diagonal tile of a q row has masked (k > q) entries, and they
//   are exact zeros before the split, so a later position never reaches an
//   earlier output, whatever its value.
// - 102 KB of shared memory and at most 128 registers a thread: two
//   blocks share an SM.
// What bounds it now is not the tensor cores (a third of the products
// takes as long) but the CUDA-core instructions that feed them, a decay
// and the splits a product, with 16 warps an SM to hide their latency
// (PERF.md).
//
// Layout:
//   xdt, y  f32 [BC, Q, H, P]        da, cum  f32 [BC, H, Q]
//   b, c    f32 [BC, Q, G, N]        head h reads group h / (H / G)
// P and N are multiples of 4 and the base pointers 16-byte aligned (the
// wrapper pads and copies), so every row starts on a 16-byte boundary.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kT = 64;          // q rows and k columns of a tile; xdt columns
constexpr int kNc = 32;         // state dimensions of a C / B chunk
constexpr int kSeg = 4;         // k tiles of shared scores
constexpr int kThreads = 256;   // 8 warps: 4 row groups of 16 x 2 halves of 32
constexpr int kLdCB = kNc + 4;  // row strides = 4 or 8 mod 32: the fragment
constexpr int kLdX = kT + 8;    // loads of a warp hit 32 distinct banks
constexpr int kLdS = kSeg * kT + 4;
constexpr int kStage = kT * kLdX + 2 * kT;  // floats: xdt + cum_k + cum_q
static_assert(2 * kT * kLdCB <= kStage, "a C / B chunk fits a stage");
// items in flight: a third stage would leave room for one block an SM, and
// two blocks an SM hide more latency than a deeper prefetch (PERF.md)
constexpr int kStages = 2;
constexpr size_t kSmem =
    sizeof(float) * ((size_t)kT * kLdS + kStages * kStage);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// x ~ hi + lo, both TF32 by truncation (two bit masks and a subtraction):
// hi keeps x's top 10 mantissa bits, lo the top 10 of the exact remainder,
// so hi + lo is within 2^-20 of x; a zero splits into two zeros
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma(float* d, const uint32_t* a,
                                    const uint32_t* b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[j] += a . b[j] for four 8-column blocks j in 3xTF32, small terms
// first; the three products of one accumulator are four mma apart, so a
// warp does not wait on its own accumulator
__device__ __forceinline__ void mma3x4(float* d, const uint32_t* ah,
                                       const uint32_t* al,
                                       const uint32_t (*bh)[2],
                                       const uint32_t (*bl)[2]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) mma(d + 4 * j, al, bh[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma(d + 4 * j, ah, bl[j]);
#pragma unroll
  for (int j = 0; j < 4; ++j) mma(d + 4 * j, ah, bh[j]);
}

// A 64-row tile of `cols` f32 columns (a multiple of 4) into shared memory
// with row stride `ld`; rows from `rows` on and columns from `valid_cols`
// on are zero-filled.
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          size_t stride, int rows, int cols,
                                          int valid_cols) {
  const int per_row = cols / 4;
  for (int i = threadIdx.x; i < kT * per_row; i += kThreads) {
    const int r = i / per_row, c = 4 * (i % per_row);
    const bool ok = r < rows && c < valid_cols;
    cp_async16(smem_u32(dst + r * ld + c),
               ok ? src + (size_t)r * stride + c : src, ok ? 16 : 0);
  }
}

// 64 consecutive f32 (zero from `valid` on)
__device__ __forceinline__ void load_vec(float* dst, const float* src,
                                         int valid) {
  const int i = threadIdx.x;
  if (i < kT) cp_async4(smem_u32(dst + i), i < valid ? src + i : src,
                        i < valid ? 4 : 0);
}

struct Dims {
  int Q, H, G, N, P, n_qt, n_nc, n_pc, nh;
};

// One unit of the block's pipeline: the score chunk (kt, nc) of q tile qt,
// or head hr's output chunk pc from k tile kt.  Items run q tile by q tile,
// segment (kSeg k tiles) by segment: first its scores, then every head's
// products over them.
struct Item {
  int qt, sg, kind, kt, nc, hr, pc;  // kind: 0 scores, 1 output
  __device__ int k_begin() const { return sg * kSeg; }
  __device__ int k_end() const { return min(qt + 1, sg * kSeg + kSeg); }
};

__device__ __forceinline__ bool advance(Item& it, const Dims& d) {
  if (it.kind == 0) {
    if (++it.nc < d.n_nc) return true;
    it.nc = 0;
    if (++it.kt < it.k_end()) return true;
    it.kind = 1;
    it.kt = it.k_begin();
    it.hr = it.pc = 0;
    return true;
  }
  if (++it.kt < it.k_end()) return true;
  it.kt = it.k_begin();
  if (++it.pc < d.n_pc) return true;
  it.pc = 0;
  if (++it.hr < d.nh) return true;
  it.hr = 0;
  it.kind = 0;
  if ((it.sg + 1) * kSeg <= it.qt) {
    ++it.sg;
  } else {
    it.sg = 0;
    if (++it.qt >= d.n_qt) return false;
  }
  it.kt = it.k_begin();
  return true;
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_intra_kernel(const float* __restrict__ xdt, const float* __restrict__ da,
                 const float* __restrict__ b, const float* __restrict__ c,
                 float* __restrict__ y, float* __restrict__ cum, int Q, int H,
                 int G, int N, int P, int R) {
  extern __shared__ __align__(16) float smem[];
  float* s_s = smem;                  // [kT][kLdS]  scores of a segment
  float* stage0 = s_s + kT * kLdS;    // 2 x kStage

  const int n_slab = (H / G + R - 1) / R;
  const int slab = blockIdx.x % n_slab;
  const int g = (blockIdx.x / n_slab) % G;
  const size_t bc = blockIdx.x / (n_slab * G);
  const int h0 = g * (H / G) + slab * R;
  Dims d;
  d.Q = Q; d.H = H; d.G = G; d.N = N; d.P = P;
  d.n_qt = (Q + kT - 1) / kT;
  d.n_nc = (N + kNc - 1) / kNc;
  d.n_pc = (P + kT - 1) / kT;
  d.nh = min(R, H / G - slab * R);

  const size_t xrow = (size_t)H * P, brow = (size_t)G * N;
  const float* xdt_bc = xdt + bc * Q * xrow;
  float* y_bc = y + bc * Q * xrow;
  const float* b_bc = b + bc * Q * brow + (size_t)g * N;
  const float* c_bc = c + bc * Q * brow + (size_t)g * N;
  float* cum_bc = cum + (bc * H + h0) * (size_t)Q;

  // cum = inclusive cumsum of da times log2(e) (a decay is then one exp2),
  // one warp per head: each lane sums a run of positions, an exclusive
  // shuffle scan gives the runs before it
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    for (int hr = warp; hr < d.nh; hr += kThreads / 32) {
      const float* dr = da + (bc * H + h0 + hr) * (size_t)Q;
      float* cr = cum_bc + (size_t)hr * Q;
      float run = 0.0f;
      for (int i = lo; i < hi; ++i) run += dr[i];
      float incl = run;
      for (int o = 1; o < 32; o <<= 1) {
        const float v = __shfl_up_sync(steam::kFull, incl, o);
        if (lane >= o) incl += v;
      }
      float acc = __shfl_up_sync(steam::kFull, incl, 1);
      if (lane == 0) acc = 0.0f;
      for (int i = lo; i < hi; ++i) {
        acc += dr[i];
        cr[i] = acc * kLog2e;
      }
    }
  }
  __syncthreads();

  auto issue = [&](const Item& it, float* st) {
    const int q0 = it.qt * kT, k0 = it.kt * kT;
    if (it.kind == 0) {
      const int n0 = it.nc * kNc;
      load_rows(st, kLdCB, c_bc + (size_t)q0 * brow + n0, brow, Q - q0, kNc,
                N - n0);
      load_rows(st + kT * kLdCB, kLdCB, b_bc + (size_t)k0 * brow + n0, brow,
                Q - k0, kNc, N - n0);
    } else {
      const int p0 = it.pc * kT;
      const int h = h0 + it.hr;
      load_rows(st, kLdX, xdt_bc + (size_t)k0 * xrow + (size_t)h * P + p0,
                xrow, Q - k0, kT, P - p0);
      const float* cr = cum_bc + (size_t)it.hr * Q;
      load_vec(st + kT * kLdX, cr + k0, Q - k0);
      load_vec(st + kT * kLdX + kT, cr + q0, Q - q0);
    }
  };

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gq = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = 32 * (warp >> 2);
  float sacc[16], yacc[16];

  // kStages - 1 items ahead of the one in work: item i's copies go to
  // stage i % kStages, issued once item i - 1 has left that stage
  Item cur = {0, 0, 0, 0, 0, 0, 0};
  Item pre = cur;
  bool more = true;
#pragma unroll
  for (int i = 0; i + 1 < kStages; ++i) {
    if (more) {
      issue(pre, stage0 + i * kStage);
      more = advance(pre, d);
    }
    cp_async_commit();
  }
  bool last = false;  // cur is the block's last item
  for (int i = 0; !last; ++i) {
    if (more) {
      issue(pre, stage0 + ((i + kStages - 1) % kStages) * kStage);
      more = advance(pre, d);
    }
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const float* sv = stage0 + (i % kStages) * kStage;
    const int kc = (cur.kt - cur.k_begin()) * kT;   // column in s_s
    if (cur.kind == 0) {
      // scores: s[q, k] += C_q[:, chunk] . B_k[:, chunk]
      const float* cs = sv;
      const float* bs = sv + kT * kLdCB;
      if (cur.nc == 0)
#pragma unroll
        for (int i = 0; i < 16; ++i) sacc[i] = 0.0f;
#pragma unroll
      for (int ks = 0; ks < kNc / 8; ++ks) {
        uint32_t ah[4], al[4];
        const float* ca = cs + (r0 + gq) * kLdCB + 8 * ks + t;
        split(ca[0], ah[0], al[0]);
        split(ca[8 * kLdCB], ah[1], al[1]);
        split(ca[4], ah[2], al[2]);
        split(ca[8 * kLdCB + 4], ah[3], al[3]);
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* bb = bs + (c0 + 8 * j + gq) * kLdCB + 8 * ks + t;
          split(bb[0], bh[j][0], bl[j][0]);
          split(bb[4], bh[j][1], bl[j][1]);
        }
        mma3x4(sacc, ah, al, bh, bl);
      }
      if (cur.nc == d.n_nc - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* at = s_s + (r0 + gq) * kLdS + kc + c0 + 8 * j + 2 * t;
          at[0] = sacc[4 * j];
          at[1] = sacc[4 * j + 1];
          at[8 * kLdS] = sacc[4 * j + 2];
          at[8 * kLdS + 1] = sacc[4 * j + 3];
        }
      }
    } else {
      // one head's output chunk: y[q, p] += (s[q, k] decay(q, k)) xdt[k, p]
      const float* xs = sv;
      const float* cum_k = sv + kT * kLdX;
      const float* cum_q = cum_k + kT;
      const int q_a = cur.qt * kT + r0 + gq;   // rows q_a and q_a + 8
      const int h = h0 + cur.hr;
      const int p_at = cur.pc * kT + c0 + 2 * t;
      float* y_at = y_bc + (size_t)q_a * xrow + (size_t)h * P + p_at;
      if (cur.kt == cur.k_begin()) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q_a + 8 * (e >> 1), p = p_at + 8 * j + (e & 1);
            // a later segment adds onto this thread's own earlier output
            yacc[4 * j + e] = cur.sg > 0 && q < Q && p < P
                ? y_at[(size_t)8 * (e >> 1) * xrow + 8 * j + (e & 1)] : 0.0f;
          }
      }
      const float cq[2] = {cum_q[r0 + gq], cum_q[r0 + gq + 8]};
      const int dk = cur.qt * kT - cur.kt * kT + r0 + gq;  // q - k at col 0
      const bool diag = cur.kt == cur.qt;   // the only tile with k > q
#pragma unroll
      for (int ks = 0; ks < kT / 8; ++ks) {
        uint32_t ah[4], al[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int rr = 8 * (e & 1), kk = 8 * ks + t + 4 * (e >> 1);
          const float a = s_s[(r0 + gq + rr) * kLdS + kc + kk] *
                          ex2(cq[e & 1] - cum_k[kk]);
          split(diag && kk > dk + rr ? 0.0f : a, ah[e], al[e]);
        }
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float* xb = xs + (8 * ks + t) * kLdX + c0 + 8 * j + gq;
          split(xb[0], bh[j][0], bl[j][0]);
          split(xb[4 * kLdX], bh[j][1], bl[j][1]);
        }
        mma3x4(yacc, ah, al, bh, bl);
      }
      if (cur.kt == cur.k_end() - 1) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = q_a + 8 * (e >> 1), p = p_at + 8 * j + (e & 1);
            if (q < Q && p < P)
              y_at[(size_t)8 * (e >> 1) * xrow + 8 * j + (e & 1)] =
                  yacc[4 * j + e];
          }
      }
    }
    __syncthreads();
    last = !advance(cur, d);
  }
}

}  // namespace

// R: heads of a group per block (the wrapper's choice, 1 <= R <= H / G);
// cum: f32 [BC, H, Q] scratch.
extern "C" int steam_ssd_intra_chunk(const float* xdt, const float* da,
                                     const float* b, const float* c,
                                     float* y, float* cum, int BC, int Q,
                                     int H, int G, int N, int P, int R,
                                     void* stream) {
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = (long long)BC * G * ((H / G + R - 1) / R);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  ssd_intra_kernel<<<(unsigned)blocks, kThreads, kSmem,
                     (cudaStream_t)stream>>>(xdt, da, b, c, y, cum, Q, H, G,
                                             N, P, R);
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_ssd_chunk_error_string)
