// Flash attention, forward: online-softmax attention that never writes the
// [Sq, Sk] score matrix to device memory.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py
// (flash_attention, _kernel), with its conventions: q [B, Sq, H, D], k / v
// [B, Sk, KV, D] with H % KV == 0 (query head h reads kv head h / (H / KV));
// the causal mask is top-left aligned (column <= row, also when Sq != Sk);
// scores multiply by `scale` after the product and masked ones take -1e30;
// running max and sum and the output accumulator are f32 whatever the
// input type; the sum is clamped at 1e-30 before the division and the
// output takes q's type.  Any D <= 256 and any Sq, Sk: ragged tiles are
// masked, so no length has to be a multiple of the tile.
//
// What bounds it on an H100: operations.  Each (row, column) pair of the
// causal triangle costs 4 D flops (scores and output) against 2 bytes a
// value of bf16 traffic: at zamba2's D = 112 and 4 k tokens, ~1000 flops a
// byte, far above the card's ridge.  Two kernels, by input type.
//
// bf16 (flash_tc_kernel, the serving path) runs on Hopper's tensor cores,
// FA3-style:
// - A block takes 128 query rows of one (batch, head): two consumer
//   warpgroups of 64 rows each and one producer warpgroup.  setmaxnreg
//   moves registers from the producer (40 a thread) to the consumers (232),
//   whose accumulators need ~190 at D = 112.
// - The producer's one thread copies Q once and each 64-key K and V tile by
//   TMA into a ring of 4 stages (3 above DP = 128, 2 above 192), with a
//   full and an empty mbarrier per stage: no block-wide barrier in the
//   loop, and the warpgroups drift so one's softmax overlaps the other's
//   products.  The tensor maps come from cuTensorMapEncodeTiled, fetched
//   through cudaGetDriverEntryPoint (no -lcuda).
// - Tiles sit in shared memory 128-byte swizzled, in 64-column blocks
//   (one TMA box of 128-byte rows each; D = 112 is no multiple of 64, so
//   its second block carries 16 zero columns the products never read:
//   +14 % shared memory, +0 work).  The no-swizzle core-matrix layout
//   (D = 112 as 7 x 16) needs a TMA box per 16-byte column, seven times
//   the copy requests, and the consumers waited on them.
// - S = Q.K^T runs as wgmma with both operands in shared memory and f32
//   accumulators; O += P.V with P from registers.  The scores of tile
//   j + 1 are issued with the P.V of tile j, and the softmax of j + 1 runs
//   while that P.V does.  The reference multiplies f32 probabilities by V
//   in f32: P rounded once to bf16 misses the per-element tolerance (one
//   bf16 ulp + 1e-4) at S = 1024, so P is split into bf16 hi + lo and both
//   products accumulate into O: 6 D flops a pair on the tensor cores in
//   place of 4 D.
// - The online softmax keeps the reference's order (scores times scale,
//   -1e30 where masked, running max and sum in f32, sum clamped at 1e-30);
//   an unmasked tile folds the scale into one fused multiply-add before
//   exp2, and the output is rescaled only when a row's max moved.
// - Blocks run the q tiles of a (batch, head) together, longest first, so
//   the blocks in flight share a few heads' K and V in L2 (in head-major
//   order all 64 heads' K and V, 117 MB at zamba2's prefill, thrashed it).
// The wrapper pads D to a multiple of 8; ragged rows and columns arrive
// as zeros from TMA and are masked in the softmax; key tiles past the
// block's causal limit are never loaded.  What bounds it now: the
// softmax and the P split on the CUDA cores take longer a tile than the
// products (PERF.md), so the tensor cores idle between tiles.
//
// f32 (flash_kernel, the CUDA-core design): the f32 path must agree
// with the reference to 2e-5, which TF32 or bf16 tensor cores cannot, so
// its products stay on the CUDA cores: one block per (batch * head, 64-row
// q tile) walks 64-column k / v tiles held in shared memory as f32, skips
// the tiles the causal mask covers completely, and gives each thread a
// 4 x 4 micro-tile of scores and a 4-row slice of the output accumulator
// in registers; a row's 16 threads reduce its max and sum with shuffles.
#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBq = 64, kBk = 64;
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLq = kBq + 1, kLk = kBk + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// DJ: output columns per thread, D <= 16 * DJ
template <typename T, int DJ>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int H, int KV, int D, float scale, int causal) {
  extern __shared__ float smem[];
  float* q_s = smem;                  // [D][kLq]  q tile, transposed
  float* k_s = q_s + D * kLq;         // [D][kLk]  k tile, transposed
  float* v_s = k_s + D * kLk;         // [kBk][D + 1]
  float* p_s = v_s + kBk * (D + 1);   // [kBq][kLk] probabilities
  const int ldv = D + 1;

  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBq;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const size_t qrow = (size_t)H * D, kvrow = (size_t)KV * D;
  const T* qb = q + (size_t)b * Sq * qrow + (size_t)h * D;
  const T* kb = k + (size_t)b * Sk * kvrow + (size_t)kvh * D;
  const T* vb = v + (size_t)b * Sk * kvrow + (size_t)kvh * D;
  T* ob = o + (size_t)b * Sq * qrow + (size_t)h * D;

  for (int i = threadIdx.x; i < kBq * D; i += kThreads) {
    const int r = i / D, d = i % D;
    q_s[d * kLq + r] =
        q0 + r < Sq ? to_f32(qb[(size_t)(q0 + r) * qrow + d]) : 0.0f;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;
  }

  // causal: columns past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBq) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = threadIdx.x; i < kBk * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const bool ok = k0 + r < Sk;
      const size_t at = (size_t)(k0 + r) * kvrow + d;
      k_s[d * kLk + r] = ok ? to_f32(kb[at]) : 0.0f;
      v_s[r * ldv + d] = ok ? to_f32(vb[at]) : 0.0f;
    }
    __syncthreads();

    float s[4][4] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[d * kLq + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[d * kLk + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      bool keep[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        keep[j] = col < Sk && (!causal || col <= row);
        s[i][j] = keep[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(steam::kFull, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = keep[j] ? expf(s[i][j] - m_new) : 0.0f;
        p_s[(ty + 16 * i) * kLk + tx + 16 * j] = p;
        rs += p;
      }
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(steam::kFull, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBk; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * kLk + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < D ? v_s[c * ldv + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = tx + 16 * j;
      if (d < D) store(ob + (size_t)row * qrow + d, acc[i][j] / denom);
    }
  }
}

template <typename T, int DJ>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int D, float scale, int causal,
           cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * kLq + (size_t)D * kLk +
                                       (size_t)kBk * (D + 1) +
                                       (size_t)kBq * kLk);
  cudaError_t e = cudaFuncSetAttribute(
      flash_kernel<T, DJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + kBq - 1) / kBq, B * H);
  flash_kernel<T, DJ><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, D, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Sq, int Sk, int H, int KV, int D, float scale, int causal,
             cudaStream_t stream) {
  if (D <= 64)
    return launch<T, 4>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal,
                        stream);
  if (D <= 128)
    return launch<T, 8>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal,
                        stream);
  return launch<T, 16>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal,
                       stream);
}


// --------------------------------------------------------------------------
// bf16: wgmma on the tensor cores
// --------------------------------------------------------------------------
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kBq = 128;      // query rows of a block: two warpgroups of 64
constexpr int kBk = 64;       // keys of a K / V tile (128 leaves the
                              // consumers too few registers: ptxas then
                              // serializes the wgmma)
constexpr int kThreads = 256; // the consumer warpgroups
constexpr int kBlock = kThreads + 128;  // and one producer warpgroup

// Shared memory holds tiles of CP = DP rounded up to 64 columns: 128-byte
// rows, the width of one 128-byte swizzle atom, in blocks of 64 columns.
__host__ __device__ constexpr int padded(int dp) { return (dp + 63) / 64 * 64; }
__host__ __device__ constexpr size_t ring_bytes(int dp, int st) {
  return (size_t)kBq * padded(dp) * 2 + 2 * (size_t)st * kBk * padded(dp) * 2;
}
// stages of the K / V ring: as many (up to 4) as 227 KB of shared memory
// hold with Q, 1 KB of alignment and the barriers
__host__ __device__ constexpr int stages(int dp) {
  return ring_bytes(dp, 4) + 1024 + 64 <= 232448   ? 4
         : ring_bytes(dp, 3) + 1024 + 48 <= 232448 ? 3
                                                   : 2;
}
__host__ __device__ constexpr size_t tile_bytes(int dp) {
  return ring_bytes(dp, stages(dp));
}
// the tiles (from a 1024-byte boundary), then a full and an empty mbarrier
// per stage
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return 1024 + tile_bytes(dp) + 16 * (size_t)stages(dp);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
// one arrival that also expects `bytes` of copies to land on the barrier
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}
// TMA: the box at coordinates (c0, c1, c2, c3) of tensor map `map` into
// shared memory at `dst`; its bytes complete on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// Waits for the completion of the barrier's phase of this parity.  A wait
// that never ends is a fault: it traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (int spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1 << 22)) __trap();
  }
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// pins a register to this point of the program: an asynchronous wgmma
// reads or writes it until its wait, which the compiler cannot see
__device__ __forceinline__ void pin(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void pin(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, LBO and SBO in 16-byte units, layout type 1 (128-byte swizzle)
// in bits 62-63.  K-major (Q, K): SBO steps 8 rows (1024 bytes), LBO is
// unused, and a 16-column k-step inside the 64-column block moves the start
// by 32 bytes.  MN-major (V): SBO steps 8 keys (1024 bytes), LBO the next
// 64-column block.  Atoms start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// d[0:32] (+)= A . B, m64n64k16, A and B in shared memory, both K-major
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[0:N/2] += A . B, m64nNk16, A in registers, B in shared memory MN-major
// (N a multiple of 16 up to 128)
template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db);

template <>
__device__ __forceinline__ void wgmma_rs<16>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}"
      ", {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}"
      ", {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<48>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23}"
      ", {%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<80>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47}"
      ", {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<112>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55}"
      ", {%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float* d, const uint32_t* a,
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Tiles in shared memory: a tile of R rows keeps its 64-column block c at
// byte c * 128 R, each row 128 bytes with its 16-byte pieces permuted by
// the row (TMA's 128-byte swizzle, which wgmma reads back as layout type
// 1).  One TMA box (64 columns x 1 head x R rows x 1 batch) fills a block.

// K-major descriptor of a tile of `rows` rows at 16-column k-step kk
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  return desc(tile + (kk >> 2) * 128 * rows + 32 * (kk & 3), 16, 1024);
}

// O += P.V over one 16-key step at `v` (the step's first key): one wgmma
// over all DP output columns up to 128, two above.  V is [keys][d] (d
// contiguous): MN-major, its 64-column blocks 128 kBk bytes apart.
template <int DP>
__device__ __forceinline__ void pv_step(float* o, const uint32_t* a,
                                        uint32_t v) {
  if constexpr (DP <= 128) {
    wgmma_rs<DP>(o, a, desc(v, 128 * kBk, 1024));
  } else {
    wgmma_rs<128>(o, a, desc(v, 128 * kBk, 1024));
    wgmma_rs<DP - 128>(o + 64, a, desc(v + 2 * 128 * kBk, 128 * kBk, 1024));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;

// Mask, scale and online softmax of one 64 x 64 score tile in a
// warpgroup's accumulator layout: this thread holds rows `row` (s[i], i % 4
// < 2) and row + 8 (i % 4 >= 2), columns k0 + 8 (i / 4) + 2 t + i % 2.
// Leaves the probabilities exp(s scale - m_new) in s (0 where masked),
// updates the running max (over the row) and this thread's part of the
// running sum (its 16 columns: the row's four threads add theirs at the
// end), and returns the two rows' rescale factors.  A tile with no
// masked entry and a positive scale takes the max of the raw scores and
// one fused multiply-add per score into exp2.
__device__ __forceinline__ float2 softmax_tile(float* s, float* m, float* l,
                                               int k0, int row, int t, int Sk,
                                               int causal, float scale) {
  constexpr int kN = kBk / 2;   // scores a thread holds
  const bool full = k0 + kBk <= Sk && (!causal || k0 + kBk - 1 <= row);
  // four partial maxima and sums a row: short dependency chains
  float mx[2][4], rs[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      mx[r][c] = kNegInf;
      rs[r][c] = 0.0f;
    }
  uint32_t keep = 0xffffffffu;
  if (full && scale > 0.0f) {
#pragma unroll
    for (int i = 0; i < kN; ++i)
      mx[(i >> 1) & 1][(i >> 3) & 3] =
          fmaxf(mx[(i >> 1) & 1][(i >> 3) & 3], s[i]);
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int r = (i >> 1) & 1;
      const int col = k0 + 8 * (i >> 2) + 2 * t + (i & 1);
      if (!(col < Sk && (!causal || col <= row + 8 * r)))
        keep &= ~(1u << i);
      s[i] = (keep >> i) & 1 ? s[i] * scale : kNegInf;
      mx[r][(i >> 3) & 3] = fmaxf(mx[r][(i >> 3) & 3], s[i]);
    }
  }
  float alpha[2], off[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(fmaxf(mx[r][0], mx[r][1]), fmaxf(mx[r][2], mx[r][3]));
    if (full && scale > 0.0f) x *= scale;
    x = fmaxf(x, __shfl_xor_sync(steam::kFull, x, 1));
    x = fmaxf(x, __shfl_xor_sync(steam::kFull, x, 2));
    const float m_new = fmaxf(m[r], x);
    alpha[r] = ex2((m[r] - m_new) * kLog2e);
    off[r] = m_new * kLog2e;
    m[r] = m_new;
  }
  if (full && scale > 0.0f) {
    const float c = scale * kLog2e;
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      s[i] = ex2(fmaf(s[i], c, -off[(i >> 1) & 1]));
      rs[(i >> 1) & 1][(i >> 3) & 3] += s[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      s[i] = (keep >> i) & 1 ? ex2(s[i] * kLog2e - off[(i >> 1) & 1]) : 0.0f;
      rs[(i >> 1) & 1][(i >> 3) & 3] += s[i];
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] + ((rs[r][0] + rs[r][1]) + (rs[r][2] + rs[r][3]));
  return make_float2(alpha[0], alpha[1]);
}

__device__ __forceinline__ uint32_t pack(float lo_col, float hi_col) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Probabilities (f32, accumulator layout) to the A fragments of the four
// 16-key steps of P.V, split as p = hi + lo with both halves bf16.
__device__ __forceinline__ void split_p(const float* s, uint32_t* hi,
                                        uint32_t* lo) {
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {   // 8-key column block
#pragma unroll
    for (int r = 0; r < 2; ++r) {    // row, row + 8
      const float a = s[4 * j + 2 * r], b = s[4 * j + 2 * r + 1];
      const uint32_t h = pack(a, b);
      __nv_bfloat162 hv = *reinterpret_cast<const __nv_bfloat162*>(&h);
      const int at = 4 * (j >> 1) + 2 * (j & 1) + r;
      hi[at] = h;
      lo[at] = pack(a - __low2float(hv), b - __high2float(hv));
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kBlock, 1)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                int Sq, int Sk, int H, int KV, int D, float scale, int causal,
                int n_qt) {
  constexpr int kS = stages(DP);
  constexpr int kNb = padded(DP) / 64;        // 64-column blocks of a row
  constexpr uint32_t kTile = kBk * padded(DP) * 2;   // bytes of K or V tile
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_s = q_s + kBq * padded(DP) * 2;
  const uint32_t v_s = k_s + kS * kTile;
  const uint32_t full = q_s + (uint32_t)tile_bytes(DP);  // kS mbarriers
  const uint32_t empty = full + 8 * kS;                  // kS mbarriers

  // q tiles of one (batch, head) run together, longest first: the blocks
  // in flight share a few heads' K and V in L2, and short tiles end the grid
  const int bh = blockIdx.x / n_qt, qt = n_qt - 1 - blockIdx.x % n_qt;
  const int b = bh / H, h = bh % H, kvh = h / (H / KV);
  const int q0 = qt * kBq;
  const size_t qrow = (size_t)H * D;
  const int k_end = causal ? min(Sk, q0 + kBq) : Sk;
  const int n_k = (k_end + kBk - 1) / kBk;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kS; ++st) {
      mbar_init(full + 8 * st, 1);           // the producer's expect-tx
      mbar_init(empty + 8 * st, kThreads / 32);   // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // One branch per role for the whole kernel (setmaxnreg needs paths that
  // never meet again): 12 warps get 168 registers a thread at launch; the
  // producer warpgroup gives back all but 40 and the consumers take 232.
  if (threadIdx.x >= kThreads) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    // producer: one thread puts tile j (K_j, V_j; Q with tile 0) into
    // stage j % kS by TMA, a box per 64-column block, once the consumers
    // have released the stage's previous round; rows past the end and
    // columns past D arrive as zeros
    if (threadIdx.x == kThreads) {
      for (int j = 0; j < n_k; ++j) {
        const int st = j % kS;
        mbar_wait(empty + 8 * st, ((j / kS) & 1) ^ 1);
        mbar_expect(full + 8 * st,
                    2 * kTile + (j == 0 ? kBq * padded(DP) * 2 : 0));
        if (j == 0)
#pragma unroll
          for (int c = 0; c < kNb; ++c)
            tma_load(q_s + c * 128 * kBq, &tq, 64 * c, h, q0, b, full);
#pragma unroll
        for (int c = 0; c < kNb; ++c) {
          tma_load(k_s + st * kTile + c * 128 * kBk, &tk, 64 * c, kvh,
                   j * kBk, b, full + 8 * st);
          tma_load(v_s + st * kTile + c * 128 * kBk, &tv, 64 * c, kvh,
                   j * kBk, b, full + 8 * st);
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    // consumer warpgroups: 64 query rows each
    const int wg = threadIdx.x >> 7, lane = threadIdx.x & 31;
    const int t = lane & 3;
    const int row = q0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
    const uint32_t q_wg = q_s + 64 * 128 * wg;  // this warpgroup's 64 rows
    float s[kBk / 2], acc[DP / 2];
    uint32_t p_hi[kBk / 4], p_lo[kBk / 4];
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;

    // scores of tile 0
    mbar_wait(full, 0);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      wgmma_ss_n64(s, kdesc(q_wg, kBq, kk), kdesc(k_s, kBk, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kBk / 2; ++i) pin(s[i]);
    softmax_tile(s, m, l, 0, row, t, Sk, causal, scale);
    split_p(s, p_hi, p_lo);

    // every tile but the last: scores of tile j + 1 and P.V of tile j in
    // flight together, the softmax of j + 1 under the P.V (no wgmma sits
    // behind a branch: ptxas keeps the pipeline); stage j is released to
    // the producer once its P.V is done
    for (int j = 0; j + 1 < n_k; ++j) {
      const int st = (j + 1) % kS;
      mbar_wait(full + 8 * st, ((j + 1) / kS) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_n64(s, kdesc(q_wg, kBq, kk),
                         kdesc(k_s + st * kTile, kBk, kk), kk);
      wgmma_commit();
      const uint32_t vt = v_s + (j % kS) * kTile;
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        pv_step<DP>(acc, p_hi + 4 * kk, vt + 2048 * kk);
        pv_step<DP>(acc, p_lo + 4 * kk, vt + 2048 * kk);
      }
      wgmma_commit();
      wgmma_wait<1>();
#pragma unroll
      for (int i = 0; i < kBk / 2; ++i) pin(s[i]);
      const float2 alpha = softmax_tile(s, m, l, (j + 1) * kBk, row, t,
                                            Sk, causal, scale);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) pin(acc[i]);
#pragma unroll
      for (int i = 0; i < kBk / 4; ++i) {
        pin(p_hi[i]);
        pin(p_lo[i]);
      }
      if (lane == 0) mbar_arrive(empty + 8 * (j % kS));
      if (__any_sync(steam::kFull, alpha.x != 1.0f || alpha.y != 1.0f)) {
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) acc[i] *= (i & 2) ? alpha.y : alpha.x;
      }
      split_p(s, p_hi, p_lo);
    }
    // the last tile's P.V
    wgmma_fence();
    {
      const uint32_t vt = v_s + ((n_k - 1) % kS) * kTile;
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) {
        pv_step<DP>(acc, p_hi + 4 * kk, vt + 2048 * kk);
        pv_step<DP>(acc, p_lo + 4 * kk, vt + 2048 * kk);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) pin(acc[i]);

    bf16* ob = o + (size_t)b * Sq * qrow + (size_t)h * D;
    float den[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(steam::kFull, l[r], 1);
      l[r] += __shfl_xor_sync(steam::kFull, l[r], 2);
      den[r] = fmaxf(l[r], 1e-30f);
    }
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = row + 8 * r;
        if (col < D && rr < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)rr * qrow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * r] / den[r],
                                    acc[4 * j + 2 * r + 1] / den[r]);
      }
    }
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [B, S, X, D] bf16 as a 4-D tensor (D, X, S, B), boxes of 64 columns x
// 1 head x `rows` rows landing 128-byte swizzled; columns and rows out of
// range are zero-filled
bool tensor_map(CUtensorMap* map, const void* base, int B, int S, int X,
                int D, int rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)X, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)X * D * 2,
                                 (cuuint64_t)S * X * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int D, float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Sq, H, D, kBq) ||
      !tensor_map(&tk, k, B, Sk, KV, D, kBk) ||
      !tensor_map(&tv, v, B, Sk, KV, D, kBk))
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(
      flash_tc_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_qt = (Sq + kBq - 1) / kBq;
  const long long blocks = (long long)n_qt * B * H;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  flash_tc_kernel<DP><<<(unsigned)blocks, kBlock, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), Sq, Sk, H, KV, D, scale, causal,
      n_qt);
  return (int)cudaGetLastError();
}

int launch_dp(const void* q, const void* k, const void* v, void* o, int B,
              int Sq, int Sk, int H, int KV, int D, int DP, float scale,
              int causal, cudaStream_t s) {
#define STEAM_FLASH_DP(n) \
  case n:                 \
    return launch<n>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal, s);
  switch (DP) {
    STEAM_FLASH_DP(16) STEAM_FLASH_DP(32) STEAM_FLASH_DP(48)
    STEAM_FLASH_DP(64) STEAM_FLASH_DP(80) STEAM_FLASH_DP(96)
    STEAM_FLASH_DP(112) STEAM_FLASH_DP(128) STEAM_FLASH_DP(144)
    STEAM_FLASH_DP(160) STEAM_FLASH_DP(176) STEAM_FLASH_DP(192)
    STEAM_FLASH_DP(208) STEAM_FLASH_DP(224) STEAM_FLASH_DP(240)
    STEAM_FLASH_DP(256)
  }
#undef STEAM_FLASH_DP
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

}  // namespace

// dtype: 0 = f32 (CUDA cores), 1 = bf16 (tensor cores).  D <= 256 and, for
// bf16, D % 8 == 0 and DP = D rounded up to 16 (the wrapper pads and
// checks).
extern "C" int steam_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int Sq, int Sk, int H, int KV, int D,
                                     int DP, float scale, int causal,
                                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return tc::launch_dp(q, k, v, o, B, Sq, Sk, H, KV, D, DP, scale, causal,
                         s);
  return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal, s);
}

STEAM_ERROR_STRING_FN(steam_flash_attn_error_string)
