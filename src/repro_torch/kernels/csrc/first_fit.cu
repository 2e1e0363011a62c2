// Greedy first-fit of K candidate tasks onto H hosts.
//
// Replaces the Pallas kernel src/repro/kernels/first_fit.py
// (first_fit_place, _kernel), and with it the reference scheduler's
// `lax.while_loop` placement (core/scheduler.py): one launch per step
// places every candidate, with no host round trip between candidates.
//
// What bounds it on an H100: the work is a chain of K dependent decisions
// (each placement changes the free capacity the next one reads), so it is
// bound by the latency of that chain, not by bytes (~8 KB at H = 972) or
// operations (~2 K H compares).  Each link of the chain is a compare over
// the hosts, a min-reduction to the lowest fitting index and one update.
//
// The design for H <= 1024 (`first_fit_warp_kernel`) keeps the whole chain
// inside one warp, with no block barrier: one warp per scenario row, four
// rows a block.  Lane l holds the free cores and free GPUs of hosts
// l*R .. l*R+R-1 (R = 32) in registers, hosts past H as -inf (they never
// fit); every index into those arrays is a constant of a fully unrolled
// loop, so nothing spills.  The free vectors arrive by coalesced loads into
// a padded per-warp tile in shared memory, from which each lane takes its R
// hosts without bank conflicts (and leave the same way); loaded straight
// from global memory, a lane's contiguous hosts would touch 32 cache lines
// per load instruction.
// The demands come 32 at a time, one per lane; each is broadcast with
// __shfl_sync one placement ahead, so the chain never waits on a load or
// a shuffle.  One placement: a two-sided compare of each of the lane's R
// hosts, folded from the last host down into the lowest fitting local
// index (one select per host, fewer instructions than a min tree), one
// warp-wide __reduce_min_sync (`redux.sync`) -- the lanes' ranges ascend,
// so the lowest host index wins -- and a predicated, unrolled subtraction
// in the owning lane.  The candidate's own lane keeps the assignment in a
// register and writes it once per 32 candidates.  A placement issues about
// six instructions a host in its one warp (two compares and a select, a
// compare and two predicated subtractions), most of them on the 16-lane
// integer and compare pipe: that issue rate, not a barrier, now bounds the
// chain.
//
// For H > 1024 (`first_fit_kernel`, unchanged since it was first ported):
// one 256-thread block per row holds the two free vectors in shared memory
// (8 bytes a host, up to ~28 k hosts within the 227 KB limit); per
// candidate every thread finds the lowest fitting host among its strided
// hosts, a block min-reduction combines them, thread 0 records the
// assignment and subtracts the demand, and a barrier publishes it.
//
// Both equal the sequential reference bit for bit: the lowest fitting index
// is unique, and the only arithmetic is one f32 subtraction per placement.
// The scheduler pads the candidate list with inert (+inf demand) slots;
// every thread reads the same demand, so the warp or block skips those
// together, without a reduction.
#include "common.cuh"

namespace {

constexpr int kHostsPerLane = 32;               // R
constexpr int kWarpHosts = 32 * kHostsPerLane;  // the warp variant's limit
constexpr int kRowsPerBlock = 4;

__global__ void __launch_bounds__(32 * kRowsPerBlock)
first_fit_warp_kernel(const float* __restrict__ cand_cores,
                      const float* __restrict__ cand_gpus, int K,
                      const float* __restrict__ free_cores,
                      const float* __restrict__ free_gpus, int H, int B,
                      int* __restrict__ assign,
                      float* __restrict__ out_cores,
                      float* __restrict__ out_gpus) {
  constexpr int R = kHostsPerLane;
  // host h of a warp's row sits at h + h / 32 of its tile: lane l's run
  // l*R .. l*R+R-1 starts at l * 33, one bank further than lane l-1's
  __shared__ float tile[kRowsPerBlock][2][32 * (R + 1)];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * kRowsPerBlock + warp;
  if (row >= (size_t)B) return;  // the whole warp leaves together
  const int base = lane * R;
  float* tc = tile[warp][0];
  float* tg = tile[warp][1];
  const float* fcr = free_cores + row * (size_t)H;
  const float* fgr = free_gpus + row * (size_t)H;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = i * 32 + lane;
    tc[i * 33 + lane] = h < H ? fcr[h] : -INFINITY;
    tg[i * 33 + lane] = h < H ? fgr[h] : -INFINITY;
  }
  __syncwarp();
  float fc[R], fg[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    fc[r] = tc[lane * 33 + r];
    fg[r] = tg[lane * 33 + r];
  }
  const float* nc = cand_cores + row * (size_t)K;
  const float* ng = cand_gpus + row * (size_t)K;
  int* out = assign + row * (size_t)K;
  for (int k0 = 0; k0 < K; k0 += 32) {
    const int mine = k0 + lane;
    const float my_c = mine < K ? nc[mine] : INFINITY;
    const float my_g = mine < K ? ng[mine] : INFINITY;
    int my_assign = -1;
    const int n = min(32, K - k0);
    float next_c = __shfl_sync(steam::kFull, my_c, 0);
    float next_g = __shfl_sync(steam::kFull, my_g, 0);
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float need_c = next_c, need_g = next_g;
      next_c = __shfl_sync(steam::kFull, my_c, (j + 1) & 31);
      next_g = __shfl_sync(steam::kFull, my_g, (j + 1) & 31);
      if (need_c == INFINITY || need_g == INFINITY) continue;  // inert slot
      // the lane's lowest fitting local index (R where none fits)
      unsigned best = R;
#pragma unroll
      for (int r = R - 1; r >= 0; --r) {
        if (fc[r] >= need_c && fg[r] >= need_g) best = r;
      }
      const unsigned first = __reduce_min_sync(
          steam::kFull, best < R ? (unsigned)base + best : 0xffffffffu);
      const int local = (int)first - base;  // in [0, R) in the owning lane
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r == local) {
          fc[r] = fc[r] - need_c;
          fg[r] = fg[r] - need_g;
        }
      }
      if (lane == j) my_assign = first < (unsigned)H ? (int)first : -1;
    }
    if (mine < K) out[mine] = my_assign;
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    tc[lane * 33 + r] = fc[r];
    tg[lane * 33 + r] = fg[r];
  }
  __syncwarp();
  float* ocr = out_cores + row * (size_t)H;
  float* ogr = out_gpus + row * (size_t)H;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int h = i * 32 + lane;
    if (h < H) {
      ocr[h] = tc[i * 33 + lane];
      ogr[h] = tg[i * 33 + lane];
    }
  }
}

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

// The warp variant: B rows, four a block; H at most 1024.
// The grid comes from the wrapper (first_fit.py, `warp_grid`): `threads`
// must be 32 * kRowsPerBlock and `blocks` cover the B rows.
extern "C" int steam_first_fit_warp(const float* cand_cores,
                                    const float* cand_gpus,
                                    const float* free_cores,
                                    const float* free_gpus, int B, int K,
                                    int H, int blocks, int threads,
                                    int* assign, float* out_cores,
                                    float* out_gpus, void* stream) {
  if (H > kWarpHosts || threads != 32 * kRowsPerBlock ||
      (size_t)blocks * kRowsPerBlock < (size_t)B)
    return (int)cudaErrorInvalidValue;
  first_fit_warp_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      cand_cores, cand_gpus, K, free_cores, free_gpus, H, B, assign,
      out_cores, out_gpus);
  return (int)cudaGetLastError();
}

// The block variant: one block per row, the free vectors in shared memory.
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
