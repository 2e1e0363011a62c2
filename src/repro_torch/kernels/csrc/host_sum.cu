// Per-host sums of the scheduler, straight from the task table's columns:
// for each scenario row b and channel c, out_c[b, h] is the sum, added one
// after another in increasing task index from 0.0, of a_c[b, t] * w_c[b, t]
// (a_c[b, t] where the channel has no weight column) over the tasks t with
// status[b, t] == RUNNING, host[b, t] >= 0 and min(host[b, t], H - 1) == h.
// The product is rounded to f32 before it is added (--fmad=false), as the
// eager `tasks.cores * tasks.cpu_util` is.
//
// Replaces no Pallas kernel.  The reference sums per host with
// `jax.ops.segment_sum` above 256 hosts (src/repro/core/scheduler.py:35-45),
// which on the CPU adds in task order; the port's plain version
// (kernels/ref.py) is `scatter_add_`, which on the CPU does the same, but on
// the card adds with atomics in an order that changes from run to run.  This
// kernel gives the CPU's bits on every run.
//
// What bounds it on an H100: bytes, and the latency of the chains.  A call
// must read every task's status (4 bytes), the host of each running task
// and the values of those with a host (~3 % of Marconi's tasks): ~0.9 MB
// a row at T = 192,817, ~0.27 us at 3.35 TB/s; the adds are one chain a
// host.  (The kernel reads the host column whole: coalesced, 4 more bytes
// a task.)  The
// design spreads the reads and the sorting over every SM, and leaves the
// chains, side by side, to one block a row:
//   * phase 1, wide: a grid of (tiles, B) blocks, one a tile of kTile
//     tasks.  A block loads its tile's status and host (coalesced, kPer
//     tasks a thread), finds the running tasks by ballot and a block
//     prefix and compacts them in shared memory in task order, then reads
//     the values of those tasks only (one round trip) while it sorts them
//     stably by bucket (host mod kBuckets: per-warp bucket counts, a prefix
//     over buckets and warps, ranks within a warp from __match_any_sync).
//     It writes the records (host, value 0, value 1; 16 bytes), so sorted,
//     to the tile's own slot of a workspace, with the tile's bucket starts
//     (u16).
//   * the block of a row that finishes last (a ticket: after a barrier,
//     its thread 0 fences the block's writes and takes a number from the
//     row's counter; the last one sets the counter back to 0, so no memset
//     is launched and a CUDA graph can replay the launch) goes on to phase
//     2, narrow: thread j walks bucket j through the row's tiles in order.
//     The block copies the bucket starts of a window of kWindow tiles from
//     L2 into shared memory (cp.async, the next window's while this one is
//     walked); thread j then gathers bucket j's records of those tiles from
//     L2, kBatch at a time (one 16-byte load a record), and adds them in
//     order onto their hosts' accumulators.  A host always falls in the
//     same bucket, so one thread makes all of its adds, in task order;
//     different hosts add at once.  Thread j's first two hosts (j and j +
//     kBuckets) accumulate in registers, any further one in `out`.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                   // tasks a thread in phase 1
constexpr int kTile = kThreads * kPer;    // 4096 tasks a phase-1 block
constexpr int kBuckets = kThreads;        // one a thread in phase 2
constexpr int kBounds =                   // a tile's bucket starts and n,
    (kBuckets + 1 + 15) / 16 * 16;        // padded to 32-byte sectors (u16)
constexpr int kWindow = 32;               // tiles a phase-2 window
constexpr int kBatch = 4;                 // records a phase-2 gather
static_assert((kBuckets & (kBuckets - 1)) == 0, "buckets: a power of 2");
static_assert(kBounds >= kBuckets + 1 && kBounds % 16 == 0, "bounds");
static_assert(kTile <= 65535, "positions and starts: u16");
static_assert(kWindow <= 32, "a window's tiles: a 32-bit mask");

// The task table's columns of one launch.  A row stride of 0 is a column
// shared by every row (a [T] or [1, T] column); a null weight, a channel
// summed unweighted.
struct Columns {
  const int* status;
  const int* host;
  const float* a0;
  const float* a1;
  const float* w0;
  const float* w1;
  long long rs_status, rs_host, rs_a0, rs_a1, rs_w0, rs_w1;
};

// 16 bytes from global to shared memory without a register (cp.async,
// through L2), and its group's commit and wait.
__device__ __forceinline__ void copy16(void* to, const void* from) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(to));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(from)
               : "memory");
}
__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void copy_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Exclusive prefix sum over the block of one int a thread; *total gets the
// block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* scratch,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(steam::kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? scratch[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(steam::kFull, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kWarps) scratch[lane] = w;
  }
  __syncthreads();
  const int before = warp ? scratch[warp - 1] : 0;
  *total = scratch[kWarps - 1];
  __syncthreads();
  return before + x - v;
}

__global__ void __launch_bounds__(kThreads, 2)
host_sum_kernel(Columns c, int T, int H, int running, int n_tiles,
                int4* __restrict__ ws, unsigned short* __restrict__ bounds,
                int* __restrict__ tickets, float* __restrict__ out0,
                float* __restrict__ out1) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int scratch[kWarps];
  __shared__ int base[kPer * kWarps];
  __shared__ int last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long row = blockIdx.y;
  // the workspace: B rows of n_tiles slots of kTile records (host, value
  // 0, value 1, 0); the bounds: B rows of n_tiles x kBounds
  int4* rec = ws + row * n_tiles * kTile;
  unsigned short* row_bounds = bounds + row * n_tiles * kBounds;

  // ---- phase 1: the running tasks of one tile, sorted by bucket
  {
    int* ch = reinterpret_cast<int*>(smem);             // [kTile] host
    float* c0 = reinterpret_cast<float*>(ch + kTile);   // [kTile] value 0
    float* c1 = c0 + kTile;                             // [kTile] value 1
    unsigned short* ct =                                // [kTile] task
        reinterpret_cast<unsigned short*>(c1 + kTile);
    unsigned short* perm = ct + kTile;                  // [kTile]
    unsigned short* wcnt = perm + kTile;                // [kWarps][kBuckets]
    const int* st = c.status + row * c.rs_status;
    const int* ho = c.host + row * c.rs_host;
    const long long t0 = (long long)blockIdx.x * kTile;
    int hk[kPer], sk[kPer];
    unsigned bal[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {  // every load in flight at once
      const long long t = t0 + k * kThreads + tid;
      hk[k] = t < T ? __ldg(ho + t) : -1;
      sk[k] = t < T ? __ldg(st + t) : 0;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      bal[k] = __ballot_sync(steam::kFull, sk[k] == running && hk[k] >= 0);
      hk[k] = min(hk[k], H - 1);
      if (lane == 0) base[k * kWarps + warp] = __popc(bal[k]);
    }
    __syncthreads();
    // task t0 + k * kThreads + tid comes in the order (k, warp, lane)
    int n;
    const int mine = tid < kPer * kWarps ? base[tid] : 0;
    const int before = block_exclusive_scan(mine, scratch, &n);
    if (tid < kPer * kWarps) base[tid] = before;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if ((bal[k] >> lane) & 1u) {
        const int p = base[k * kWarps + warp] + __popc(bal[k] & below);
        ch[p] = hk[k];
        ct[p] = (unsigned short)(k * kThreads + tid);
      }
    }
    // a stable counting sort of the n records by bucket: warp w takes
    // records [w * span, (w + 1) * span), span a multiple of 32
    const int span = (n + kThreads - 1) / kThreads * 32;
    const int nw = span ? (n + span - 1) / span : 0;
    for (int i = tid; i < nw * kBuckets; i += kThreads) wcnt[i] = 0;
    __syncthreads();
    // the values of the running tasks only, in flight during the sort
    const float* a0 = c.a0 + row * c.rs_a0;
    const float* a1 = c.a1 + row * c.rs_a1;
    const float* w0 = c.w0 ? c.w0 + row * c.rs_w0 : nullptr;
    const float* w1 = c.w1 ? c.w1 + row * c.rs_w1 : nullptr;
    float x0[kPer], x1[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      if (e < n) {
        const long long t = t0 + ct[e];
        x0[i] = w0 ? __ldg(a0 + t) * __ldg(w0 + t) : __ldg(a0 + t);
        x1[i] = w1 ? __ldg(a1 + t) * __ldg(w1 + t) : __ldg(a1 + t);
      }
    }
    if (warp < nw) {
      for (int e0 = warp * span; e0 < min(n, (warp + 1) * span); e0 += 32) {
        const int e = e0 + lane;
        const int key = e < n ? (ch[e] & (kBuckets - 1)) : kBuckets + lane;
        const unsigned peers = __match_any_sync(steam::kFull, key);
        if (e < n && (peers & below) == 0u)
          wcnt[warp * kBuckets + key] += __popc(peers);
        __syncwarp();  // the next round's leader of a key reads this count
      }
    }
    __syncthreads();
    {
      // thread j: bucket j's start, and each warp's first place in it
      int sum = 0;
      for (int w = 0; w < nw; ++w) sum += wcnt[w * kBuckets + tid];
      int all;
      int at = block_exclusive_scan(sum, scratch, &all);
      row_bounds[blockIdx.x * kBounds + tid] = (unsigned short)at;
      if (tid <= kBounds - kBuckets - 1)  // n, then the padding: whole
        row_bounds[blockIdx.x * kBounds + kBuckets + tid] =  // sectors
            (unsigned short)(tid ? 0 : n);
      for (int w = 0; w < nw; ++w) {
        const int x = wcnt[w * kBuckets + tid];
        wcnt[w * kBuckets + tid] = (unsigned short)at;
        at += x;
      }
    }
    __syncthreads();
    if (warp < nw) {
      for (int e0 = warp * span; e0 < min(n, (warp + 1) * span); e0 += 32) {
        const int e = e0 + lane;
        const bool ok = e < n;
        const int key = ok ? (ch[e] & (kBuckets - 1)) : kBuckets + lane;
        const unsigned peers = __match_any_sync(steam::kFull, key);
        int at = 0;
        if (ok) {
          at = wcnt[warp * kBuckets + key];
          perm[at + __popc(peers & below)] = (unsigned short)e;
        }
        __syncwarp();
        if (ok && (peers & below) == 0u)
          wcnt[warp * kBuckets + key] = (unsigned short)(at + __popc(peers));
        __syncwarp();
      }
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = i * kThreads + tid;
      if (e < n) {
        c0[e] = x0[i];
        c1[e] = x1[i];
      }
    }
    __syncthreads();
    for (int q = tid; q < n; q += kThreads) {
      const int e = perm[q];
      rec[t0 + q] = make_int4(ch[e], __float_as_int(c0[e]),
                              __float_as_int(c1[e]), 0);
    }
    if (tid == 0 && (n & 1)) rec[t0 + n] = make_int4(0, 0, 0, 0);  // sectors
  }

  // ---- the ticket: the row's last block goes on (the barrier orders the
  // block's writes before thread 0's fence, which orders them before its
  // atomic)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int ticket = atomicAdd(tickets + row, 1);
    last = ticket == n_tiles - 1;
    if (last) {
      tickets[row] = 0;  // every block of the row has taken its ticket
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;

  // ---- phase 2: thread j walks bucket j through the row's tiles in order
  unsigned short* sb =                               // [2][kWindow][kBounds]
      reinterpret_cast<unsigned short*>(smem);
  float* o0 = out0 + row * H;
  float* o1 = out1 + row * H;
  float lo0 = 0.0f, lo1 = 0.0f, hi0 = 0.0f, hi1 = 0.0f;
  for (int h = tid + 2 * kBuckets; h < H; h += kBuckets) {
    o0[h] = 0.0f;
    o1[h] = 0.0f;
  }
  // the bucket starts of a window of tiles, copied into one of two
  // buffers while thread j walks the other window
  auto fetch = [&](int tw, unsigned short* buf) {
    const int nwt = min(kWindow, n_tiles - tw);
    const char* from = reinterpret_cast<const char*>(row_bounds + tw * kBounds);
    for (int v = tid; v < nwt * (kBounds / 8); v += kThreads)
      copy16(buf + 8 * v, from + 16 * v);
  };
  fetch(0, sb);
  copy_commit();
  for (int w = 0, tw = 0; tw < n_tiles; ++w, tw += kWindow) {
    const unsigned short* wb = sb + (w & 1) * kWindow * kBounds;
    if (tw + kWindow < n_tiles)
      fetch(tw + kWindow, sb + ((w + 1) & 1) * kWindow * kBounds);
    copy_commit();
    copy_wait_all_but_last();  // this window's starts have landed
    __syncthreads();
    // the window's tiles that hold records of bucket j, a mask
    const int nwt = min(kWindow, n_tiles - tw);
    unsigned live = 0u;
#pragma unroll
    for (int i = 0; i < kWindow; ++i)
      if (i < nwt && wb[i * kBounds + tid + 1] > wb[i * kBounds + tid])
        live |= 1u << i;
    // the bucket's records of the window, kBatch at a time: every load of
    // a batch in flight at once, then the adds in order
    int i = 0, q = 0, rem = 0;
    while (live || rem) {
      int at[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (rem == 0 && live) {
          i = __ffs(live) - 1;
          live &= live - 1u;
          q = wb[i * kBounds + tid];
          rem = wb[i * kBounds + tid + 1] - q;
        }
        at[u] = -1;
        if (rem) {
          at[u] = (tw + i) * kTile + q;
          ++q;
          --rem;
        }
      }
      int4 r[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (at[u] >= 0) r[u] = __ldcg(rec + at[u]);
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (at[u] >= 0) {
          const int h = r[u].x;
          const float y0 = __int_as_float(r[u].y);
          const float y1 = __int_as_float(r[u].z);
          if (h == tid) {
            lo0 += y0;
            lo1 += y1;
          } else if (h == tid + kBuckets) {
            hi0 += y0;
            hi1 += y1;
          } else {
            o0[h] += y0;
            o1[h] += y1;
          }
        }
      }
    }
    __syncthreads();  // the window after next overwrites these starts
  }
  if (tid < H) {
    o0[tid] = lo0;
    o1[tid] = lo1;
  }
  if (tid + kBuckets < H) {
    o0[tid + kBuckets] = hi0;
    o1[tid + kBuckets] = hi1;
  }
}

}  // namespace

// Dynamic shared memory of a launch: the larger of phase 1's (a tile of
// records, their tasks and order, u16, and the per-warp bucket counts,
// u16) and phase 2's (two windows' bucket starts, u16).
constexpr size_t kSmem1 = 12 * kTile + 2 * (2 * kTile + kWarps * kBuckets);
constexpr size_t kSmem2 = 2 * 2 * kWindow * kBounds;
constexpr size_t kSmem = kSmem1 > kSmem2 ? kSmem1 : kSmem2;

// The workspace of a launch at B rows of T tasks: B x n_tiles x kTile
// records of 16 bytes, then B x n_tiles x kBounds bucket starts (u16, on
// 32 bytes).
static long long records_bytes(int B, int T) {
  const long long n_tiles = T > 0 ? (T + kTile - 1) / kTile : 1;
  return (long long)sizeof(int4) * B * n_tiles * kTile;
}

extern "C" long long steam_host_sum_workspace_bytes(int B, int T) {
  const long long n_tiles = T > 0 ? (T + kTile - 1) / kTile : 1;
  return records_bytes(B, T) + 2LL * B * n_tiles * kBounds;
}

// Blocks of the kernel an SM holds at once (registers, static and dynamic
// shared memory as compiled and launched); 0 on an error.
extern "C" int steam_host_sum_blocks_per_sm() {
  if (cudaFuncSetAttribute(host_sum_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)kSmem) != cudaSuccess)
    return 0;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, host_sum_kernel,
                                                    kThreads, kSmem)
      != cudaSuccess)
    return 0;
  return n;
}

// status, host (i32) and a0, a1, w0, w1 (f32; w0 / w1 may be null): rows
// of T with unit stride along T and the given row strides (0: shared);
// ws: the workspace, ws_bytes of it, at least
// steam_host_sum_workspace_bytes(B, T) (16-byte aligned); tickets: B
// int32, all 0 (the kernel leaves them 0); out0, out1: [B, H].
extern "C" int steam_host_sum(const int* status, const int* host,
                              const float* a0, const float* a1,
                              const float* w0, const float* w1,
                              long long rs_status, long long rs_host,
                              long long rs_a0, long long rs_a1,
                              long long rs_w0, long long rs_w1, int B, int T,
                              int H, int running, void* ws,
                              long long ws_bytes, int* tickets, float* out0,
                              float* out1, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || T < 0
      || ws_bytes < steam_host_sum_workspace_bytes(B, T)
      || reinterpret_cast<uintptr_t>(ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int n_tiles = T > 0 ? (T + kTile - 1) / kTile : 1;
  const cudaError_t e = cudaFuncSetAttribute(
      host_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kSmem);
  if (e != cudaSuccess) return (int)e;
  const Columns c{status, host, a0, a1, w0, w1,
                  rs_status, rs_host, rs_a0, rs_a1, rs_w0, rs_w1};
  unsigned short* bounds = reinterpret_cast<unsigned short*>(
      static_cast<char*>(ws) + records_bytes(B, T));
  host_sum_kernel<<<dim3(n_tiles, B), kThreads, kSmem,
                    (cudaStream_t)stream>>>(c, T, H, running, n_tiles,
                                            static_cast<int4*>(ws), bounds,
                                            tickets, out0, out1);
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_host_sum_error_string)
