// Shared device helpers for the STEAM Hopper kernels (sm_90a).
//
// Every kernel of this directory runs one thread block per scenario row,
// with blockDim.x a multiple of 32 and at most 1024 threads.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace steam {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// Minimum over the block; the result is valid in thread 0.
__device__ __forceinline__ int block_min(int v, int* scratch) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_down_sync(kFull, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (blockDim.x >> 5) ? scratch[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1)
      v = min(v, __shfl_down_sync(kFull, v, o));
  }
  __syncthreads();
  return v;
}

}  // namespace steam

// Host side: every C entry point returns cudaGetLastError() after its
// launch; the Python wrapper turns a non-zero code into an exception with
// this text.
#define STEAM_ERROR_STRING_FN(name)                    \
  extern "C" const char* name(int code) {              \
    return cudaGetErrorString((cudaError_t)code);      \
  }
