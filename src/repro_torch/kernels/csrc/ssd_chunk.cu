// Mamba-2 SSD intra-chunk dual form:
//
//   y[q, p] = sum_{k <= q} exp(cum[q] - cum[k]) * (C_q . B_k) * xdt[k, p]
//
// per (batch, chunk, head), with cum the in-chunk inclusive cumsum of da.
//
// Replaces the Pallas kernel src/repro/kernels/ssd_chunk.py
// (ssd_intra_chunk, _kernel).  The TPU kernel holds the whole Q x Q decay
// and C.B^T tile in VMEM (256 KB of f32 at Q = 256), which is more than the
// 227 KB a Hopper block may use; here the (q, k) square is walked in 64 x 64
// tiles and only the lower triangle of tiles is visited.
//
// What bounds it on an H100: operations.  Per (batch, chunk) the causal
// triangle holds Q(Q+1)/2 pairs; each costs 2P + 3 f32 flops per head
// (decay and output) and 2N per group for the score C_q . B_k, which the
// rep = H / G heads of a group share.  Against 2(Q P) floats of traffic
// per head that is ~33 flops a byte at Q = 256, P = N = 64, above the
// card's f32 ridge (67 TFLOP/s over 3.35 TB/s = 20).  This first version
// recomputes the score for every head, rep times the score work the
// function needs (zamba2: 56 heads a group).  Inputs are f32 and the
// reference holds this at 1e-4, so the products stay in f32 on the CUDA
// cores (TF32 tensor cores keep ~3 decimal digits).  The design keeps every
// operand tile in shared memory and 16 accumulators in each thread's
// registers (a 4 x 4 outer-product micro-tile), so each shared-memory load
// feeds four fused multiply-adds.
//
// Layout (one block per (batch * chunk, head)):
//   xdt, y  f32 [BC, Q, H, P]        da  f32 [BC, H, Q]
//   b, c    f32 [BC, Q, G, N]        head h reads group h / (H / G)
// B and C are read through the group index; nothing repeats them per head.
// Masked (k > q) entries are exact zeros, never exp of a large negative.
#include "common.cuh"

namespace {

constexpr int kTile = 64;     // q rows and k columns of one tile
constexpr int kNChunk = 32;   // state dimensions staged per pass
constexpr int kPTile = 64;    // head channels per pass
constexpr int kThreads = 256; // 16 x 16 threads, a 4 x 4 micro-tile each
constexpr int kLd = kTile + 1;  // padded row of a shared tile

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ xdt, const float* __restrict__ da,
                 const float* __restrict__ b, const float* __restrict__ c,
                 float* __restrict__ y, int Q, int H, int G, int N, int P) {
  extern __shared__ float smem[];
  float* cum = smem;                    // [Q]
  float* c_s = cum + Q;                 // [kNChunk][kLd]  C tile, transposed
  float* b_s = c_s + kNChunk * kLd;     // [kNChunk][kLd]  B tile, transposed
  float* x_s = b_s + kNChunk * kLd;     // [kTile][kLd]    xdt tile
  float* s_s = x_s + kTile * kLd;       // [kTile][kLd]    decayed scores

  const int h = blockIdx.x;
  const size_t bc = blockIdx.y;
  const int g = h / (H / G);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t xrow = (size_t)H * P;    // stride between positions
  const size_t brow = (size_t)G * N;
  const float* xdt_blk = xdt + bc * Q * xrow + (size_t)h * P;
  float* y_blk = y + bc * Q * xrow + (size_t)h * P;
  const float* b_blk = b + bc * Q * brow + (size_t)g * N;
  const float* c_blk = c + bc * Q * brow + (size_t)g * N;

  // cum = inclusive cumsum of da: each lane of warp 0 sums a run of
  // positions, a shuffle scan adds the runs before it
  const float* da_row = da + (bc * H + h) * (size_t)Q;
  for (int i = threadIdx.x; i < Q; i += kThreads) cum[i] = da_row[i];
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Q + 31) / 32;
    const int lo = min(lane * per, Q), hi = min(lo + per, Q);
    float run = 0.0f;
    for (int i = lo; i < hi; ++i) {
      run += cum[i];
      cum[i] = run;
    }
    float incl = run;
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(steam::kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const float before = incl - run;
    for (int i = lo; i < hi; ++i) cum[i] += before;
  }
  __syncthreads();

  for (int p0 = 0; p0 < P; p0 += kPTile) {
    for (int q0 = 0; q0 < Q; q0 += kTile) {
      float acc[4][4] = {};
      // causal: a k tile starting after the q tile's last row is all zero
      for (int k0 = 0; k0 <= q0; k0 += kTile) {
        float s[4][4] = {};
        for (int n0 = 0; n0 < N; n0 += kNChunk) {
          for (int i = threadIdx.x; i < kTile * kNChunk; i += kThreads) {
            const int r = i / kNChunk, n = i % kNChunk;
            const bool okn = n0 + n < N;
            c_s[n * kLd + r] = (okn && q0 + r < Q)
                ? c_blk[(size_t)(q0 + r) * brow + n0 + n] : 0.0f;
            b_s[n * kLd + r] = (okn && k0 + r < Q)
                ? b_blk[(size_t)(k0 + r) * brow + n0 + n] : 0.0f;
          }
          __syncthreads();
#pragma unroll 8
          for (int n = 0; n < kNChunk; ++n) {
            float cv[4], bv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) cv[i] = c_s[n * kLd + ty + 16 * i];
#pragma unroll
            for (int j = 0; j < 4; ++j) bv[j] = b_s[n * kLd + tx + 16 * j];
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
          }
          __syncthreads();
        }
        // decay and causal mask into shared memory, then the xdt tile
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int ql = ty + 16 * i, q = q0 + ql;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kl = tx + 16 * j, k = k0 + kl;
            s_s[ql * kLd + kl] =
                (k <= q && q < Q) ? s[i][j] * expf(cum[q] - cum[k]) : 0.0f;
          }
        }
        for (int i = threadIdx.x; i < kTile * kPTile; i += kThreads) {
          const int r = i / kPTile, p = i % kPTile;
          x_s[r * kLd + p] = (k0 + r < Q && p0 + p < P)
              ? xdt_blk[(size_t)(k0 + r) * xrow + p0 + p] : 0.0f;
        }
        __syncthreads();
#pragma unroll 8
        for (int k = 0; k < kTile; ++k) {
          float sv[4], xv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) sv[i] = s_s[(ty + 16 * i) * kLd + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) xv[j] = x_s[k * kLd + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[i][j] = fmaf(sv[i], xv[j], acc[i][j]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + tx + 16 * j;
          if (q < Q && p < P) y_blk[(size_t)q * xrow + p] = acc[i][j];
        }
      }
    }
  }
}

}  // namespace

extern "C" int steam_ssd_intra_chunk(const float* xdt, const float* da,
                                     const float* b, const float* c,
                                     float* y, int BC, int Q, int H, int G,
                                     int N, int P, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)Q + 2 * kNChunk * kLd + 2 * kTile * kLd);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_intra_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, BC);
  ssd_intra_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      xdt, da, b, c, y, Q, H, G, N, P);
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_ssd_chunk_error_string)
