// Per-host sums in task order: out_c[b, h] = the sum of v_c[b, t] over the
// tasks t with seg[b, t] == h, added one after another in increasing t from
// 0.0, for the two value channels the scheduler sums over one `seg` (cores
// and GPUs, used or utilized); bins h >= H (the spare bins of
// scheduler._running_seg: tasks that are not running) are dropped.
//
// Replaces no Pallas kernel.  The reference sums per host with
// `jax.ops.segment_sum` above 256 hosts (src/repro/core/scheduler.py:35-45),
// which on the CPU adds in task order; the port's plain version is
// `scatter_add_`, which on the CPU does the same, but on the card adds
// with atomics in an order that changes from run to run, so per-step IT
// moved by an ulp between runs.  This kernel gives the CPU's bits on every
// run.
//
// What bounds it on an H100: bytes.  A call reads every task's bin (8
// bytes) and values (4 bytes a channel) once: 2.3 MB a row at T = 192,817
// and two channels; the adds are a few thousand a row (the running tasks).
// But a sum in task order is a chain per host, so the design keeps the
// reads wide and the chains short:
//   * one thread block a row; warps 1-31 (the workers) walk the row in
//     tiles of kTile tasks, each warp a contiguous run of 128, each lane
//     loading kPer tasks (coalesced) one tile ahead of their use;
//   * the workers compact a tile's running tasks (bin < H) into shared
//     memory in task order (a ballot a load, a prefix over the warps' counts
//     behind a named barrier of the workers alone);
//   * warp 0 walks the tile compacted a round earlier, 32 entries at a
//     time: `__match_any_sync` groups the lanes of one host, and the lowest
//     lane of each group adds the group's values to the host's accumulator
//     in shared memory one after another, in lane order (task order).
//     Different hosts' groups add at once; one host's adds stay in order.
// A ring of two compacted tiles lets the workers compact tile i while warp
// 0 sums tile i - 1, one block barrier a round.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWorkers = kThreads - 32;      // warps 1-31
constexpr int kWorkerWarps = kWorkers / 32;
constexpr int kPer = 4;                      // tasks a worker lane a tile
constexpr int kRun = 32 * kPer;              // a worker warp's tasks a tile
constexpr int kTile = kWorkerWarps * kRun;   // 3968 tasks a round

__device__ __forceinline__ void workers_barrier() {
  asm volatile("bar.sync 1, %0;" ::"n"(kWorkers));
}

__global__ void __launch_bounds__(kThreads, 1)
host_sum_kernel(const float* __restrict__ v0, const float* __restrict__ v1,
                const int64_t* __restrict__ seg, int T, int H,
                float* __restrict__ out0, float* __restrict__ out1) {
  extern __shared__ float smem[];
  __shared__ int wcount[kWorkerWarps];
  __shared__ int tcount[2];
  const int hp = (H + 3) & ~3;
  float* acc0 = smem;
  float* acc1 = smem + hp;
  int* comp_h = reinterpret_cast<int*>(smem + 2 * hp);  // [2][kTile]
  float* comp_v0 = smem + 2 * hp + 2 * kTile;            // [2][kTile]
  float* comp_v1 = comp_v0 + 2 * kTile;                  // [2][kTile]
  const long long row = blockIdx.x;
  const float* r0 = v0 + row * T;
  const float* r1 = v1 + row * T;
  const int64_t* rs = seg + row * T;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int h = tid; h < H; h += kThreads) {
    acc0[h] = 0.0f;
    acc1[h] = 0.0f;
  }
  const int n_tiles = (T + kTile - 1) / kTile;

  // a worker lane's tasks of one tile: t = tile * kTile + ww * kRun
  // + k * 32 + lane; a task past T or in a spare bin gets bin H
  int hb[kPer];
  float a0[kPer], a1[kPer];
  const int ww = warp - 1;
  auto load = [&](int tile, int* hh, float* x0, float* x1) {
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long t = (long long)tile * kTile + ww * kRun + k * 32 + lane;
      const bool in = t < T;
      const int64_t s = in ? __ldg(rs + t) : (int64_t)H;
      hh[k] = (s >= 0 && s < H) ? (int)s : H;
      x0[k] = in ? __ldg(r0 + t) : 0.0f;
      x1[k] = in ? __ldg(r1 + t) : 0.0f;
    }
  };
  if (warp > 0 && n_tiles > 0) load(0, hb, a0, a1);

  // round i: the workers compact tile i, warp 0 sums tile i - 1
  for (int i = 0; i <= n_tiles; ++i) {
    if (warp > 0) {
      if (i < n_tiles) {
        int nh[kPer];
        float n0[kPer], n1[kPer];
        if (i + 1 < n_tiles) load(i + 1, nh, n0, n1);
        unsigned bal[kPer];
        int cnt = 0;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          bal[k] = __ballot_sync(steam::kFull, hb[k] < H);
          cnt += __popc(bal[k]);
        }
        if (lane == 0) wcount[ww] = cnt;
        workers_barrier();
        int base = 0;
        for (int w = 0; w < ww; ++w) base += wcount[w];
        if (ww == kWorkerWarps - 1 && lane == 0) tcount[i & 1] = base + cnt;
        const int off = (i & 1) * kTile;
        const unsigned below = (1u << lane) - 1u;
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (hb[k] < H) {
            const int p = off + base + __popc(bal[k] & below);
            comp_h[p] = hb[k];
            comp_v0[p] = a0[k];
            comp_v1[p] = a1[k];
          }
          base += __popc(bal[k]);
        }
        if (i + 1 < n_tiles) {
#pragma unroll
          for (int k = 0; k < kPer; ++k) {
            hb[k] = nh[k];
            a0[k] = n0[k];
            a1[k] = n1[k];
          }
        }
      }
    } else if (i > 0) {
      const int off = ((i - 1) & 1) * kTile;
      const int n = tcount[(i - 1) & 1];
      for (int j0 = 0; j0 < n; j0 += 32) {
        const int j = j0 + lane;
        const int hh = j < n ? comp_h[off + j] : -1 - lane;
        const unsigned peers = __match_any_sync(steam::kFull, hh);
        if (j < n && (peers & ((1u << lane) - 1u)) == 0u) {
          float s0 = acc0[hh];
          for (unsigned m = peers; m; m &= m - 1u)
            s0 += comp_v0[off + j0 + __ffs(m) - 1];
          acc0[hh] = s0;
          float s1 = acc1[hh];
          for (unsigned m = peers; m; m &= m - 1u)
            s1 += comp_v1[off + j0 + __ffs(m) - 1];
          acc1[hh] = s1;
        }
        __syncwarp();
      }
    }
    __syncthreads();
  }
  for (int h = tid; h < H; h += kThreads) {
    out0[row * H + h] = acc0[h];
    out1[row * H + h] = acc1[h];
  }
}

}  // namespace

// Dynamic shared memory of a launch on H hosts (chip_smoke.py and the
// wrapper's MAX_HOSTS mirror this count): two accumulators of H (padded to
// 4) and two compacted tiles of a bin and two values.
static size_t host_sum_smem(int H) {
  return sizeof(float) * (2 * (size_t)((H + 3) & ~3) + 6 * (size_t)kTile);
}

// v0, v1 and seg: B contiguous rows of T; out0, out1: [B, H].
extern "C" int steam_host_sum(const float* v0, const float* v1,
                              const int64_t* seg, int B, int T, int H,
                              float* out0, float* out1, void* stream) {
  const size_t smem = host_sum_smem(H);
  if (B <= 0 || H <= 0 || T < 0) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      host_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  host_sum_kernel<<<B, kThreads, smem, (cudaStream_t)stream>>>(
      v0, v1, seg, T, H, out0, out1);
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_host_sum_error_string)
