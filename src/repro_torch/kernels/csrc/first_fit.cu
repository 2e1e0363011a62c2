// Greedy first-fit of K candidate tasks onto H hosts.
//
// Replaces the Pallas kernel src/repro/kernels/first_fit.py
// (first_fit_place, _kernel), and with it the reference scheduler's
// `lax.while_loop` placement (core/scheduler.py): one launch per step
// places every candidate, with no host round trip between candidates.
//
// What bounds it on an H100: the work is a chain of K dependent decisions
// (each placement changes the free capacity the next one reads), so it is
// bound by the latency of K block-wide reductions, not by bytes (~8 KB at
// H = 972) or operations (~2 K H compares).  The design keeps the chain on
// one SM: one thread block per scenario row holds the free-core and
// free-GPU vectors in shared memory (8 bytes a host: 7.8 KB at H = 972, up
// to ~28 k hosts within the 227 KB limit).  Per candidate every thread
// finds the lowest fitting host among its strided hosts, a warp-shuffle
// min-reduction combines them, thread 0 records the assignment and
// subtracts the demand, and a barrier publishes the new capacity.
//
// Assignments and free vectors equal the sequential reference bit for bit:
// the lowest fitting index is unique, and the only arithmetic is one f32
// subtraction per placement.  The scheduler pads the candidate list with
// inert (+inf demand) slots; the block skips those without a reduction.
#include "common.cuh"

namespace {

__global__ void first_fit_kernel(const float* __restrict__ cand_cores,
                                 const float* __restrict__ cand_gpus, int K,
                                 const float* __restrict__ free_cores,
                                 const float* __restrict__ free_gpus, int H,
                                 int* __restrict__ assign,
                                 float* __restrict__ out_cores,
                                 float* __restrict__ out_gpus) {
  extern __shared__ float free_smem[];
  __shared__ int scratch[32];
  float* fc = free_smem;
  float* fg = free_smem + H;
  const size_t row = blockIdx.x;
  const float* nc = cand_cores + row * (size_t)K;
  const float* ng = cand_gpus + row * (size_t)K;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    fc[h] = free_cores[row * (size_t)H + h];
    fg[h] = free_gpus[row * (size_t)H + h];
  }
  __syncthreads();
  for (int k = 0; k < K; ++k) {
    const float need_c = nc[k], need_g = ng[k];
    // an inert slot (+inf demand) fits nowhere; every thread reads the same
    // demand, so the whole block skips it together
    if (need_c == INFINITY || need_g == INFINITY) {
      if (threadIdx.x == 0) assign[row * (size_t)K + k] = -1;
      continue;
    }
    int first = H;
    for (int h = threadIdx.x; h < H; h += blockDim.x) {
      if (fc[h] >= need_c && fg[h] >= need_g) {
        first = h;  // strided ascending: the thread's lowest fitting host
        break;
      }
    }
    first = steam::block_min(first, scratch);
    if (threadIdx.x == 0) {
      if (first < H) {
        fc[first] = fc[first] - need_c;
        fg[first] = fg[first] - need_g;
      }
      assign[row * (size_t)K + k] = first < H ? first : -1;
    }
    __syncthreads();
  }
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    out_cores[row * (size_t)H + h] = fc[h];
    out_gpus[row * (size_t)H + h] = fg[h];
  }
}

}  // namespace

extern "C" int steam_first_fit(const float* cand_cores, const float* cand_gpus,
                               const float* free_cores, const float* free_gpus,
                               int B, int K, int H, int* assign,
                               float* out_cores, float* out_gpus,
                               void* stream) {
  const size_t smem = 2 * sizeof(float) * (size_t)H;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        first_fit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  first_fit_kernel<<<B, steam::kThreads, smem, (cudaStream_t)stream>>>(
      cand_cores, cand_gpus, K, free_cores, free_gpus, H, assign, out_cores,
      out_gpus);
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_first_fit_error_string)
