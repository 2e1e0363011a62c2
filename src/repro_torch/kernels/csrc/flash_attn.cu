// Flash attention, forward: online-softmax attention that never writes the
// [Sq, Sk] score matrix to device memory.
//
// Replaces the Pallas kernel src/repro/kernels/flash_attn.py
// (flash_attention, _kernel), with its conventions: q [B, Sq, H, D], k / v
// [B, Sk, KV, D] with H % KV == 0 (query head h reads kv head h / (H / KV));
// the causal mask is top-left aligned (column <= row, also when Sq != Sk);
// scores, running max and sum and the output accumulator are f32 whatever
// the input type; the sum is clamped at 1e-30 before the division and the
// output takes q's type.  Inputs are f32 or bf16 (converted only through
// the intrinsics).  Any D <= 256 and any Sq, Sk: ragged tiles are masked,
// so no length has to be a multiple of the tile.
//
// What bounds it on an H100: operations.  Each (row, column) pair of the
// causal triangle costs 4 D flops (scores and output) against 2 bytes a
// value of bf16 traffic: at zamba2's D = 112 and 4 k tokens, ~1000 flops a
// byte.  This first version keeps the products on the CUDA cores in f32
// (the f32 path must agree with the reference to 2e-5, which TF32 or bf16
// tensor cores cannot), so it runs far below the bf16 tensor-core rate the
// bound is reckoned at; wgmma and TMA are later work.  What the design
// does: one block per (batch * head, 64-row q tile) walks 64-column k / v
// tiles held in shared memory as f32, skips the tiles the causal mask
// covers completely, and gives each thread a 4 x 4 micro-tile of scores
// and a 4-row slice of the output accumulator in registers.  A row's 16
// threads sit in one half-warp, so its max and sum reduce with shuffles.
#include <cuda_bf16.h>

#include "common.cuh"

namespace {

constexpr int kBq = 64, kBk = 64;
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLq = kBq + 1, kLk = kBk + 1;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

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

}  // namespace

// dtype: 0 = f32, 1 = bf16.  D <= 256 (checked by the wrapper).
extern "C" int steam_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int Sq, int Sk, int H, int KV, int D,
                                     float scale, int causal, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, D, scale,
                                   causal, s);
  return launch_d<float>(q, k, v, o, B, Sq, Sk, H, KV, D, scale, causal, s);
}

STEAM_ERROR_STRING_FN(steam_flash_attn_error_string)
