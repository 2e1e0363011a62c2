// Per-host power curves + host-axis sum, with a carbon or a cooling tail.
//
// Replaces the Pallas kernels of src/repro/kernels/power_carbon.py:
//   steam_power_carbon     <- fused_power_carbon   (_kernel, _power_block)
//   steam_facility_power   <- fused_facility_power (_facility_kernel)
//
// What bounds it on an H100: at the simulator's widths (H ~ 1e3 hosts) one
// call moves ~20 KB (four f32 inputs read, one f32 output written), ~6 ns
// at 3.35 TB/s, and does a few thousand flops: it is bound by launch
// latency and by the dependent steps inside the one block, not by bytes or
// operations.  Both keep the whole step in one launch, one thread block per
// scenario row (a scenario grid puts one row on each SM), with no atomics.
//
// Both kernels share one row pass (`row_pass`), built for the latency: one
// host a thread, up to 1024 threads (a wider row takes a further pass of
// 1024 hosts for each 1024 more), and every load of a pass -- its host's
// four inputs and, in thread 0, the tail's per-row inputs (carbon
// intensity; wet-bulb and setpoint) -- issued before any is used, so a row
// of up to 1024 hosts pays one DRAM round trip.  One host a thread rather
// than 16-byte vector loads: a row of H floats starts on a 16-byte boundary
// only when H % 4 == 0 (and a [H] input may be a view at any offset), while
// 1024 threads already issue every load of a 1024-host row at once.  The
// IT sum is a warp shuffle tree, one barrier, and a second shuffle tree in
// warp 0, whose lane 0 then runs the kernel's tail: the carbon product
// (power_carbon_kernel) or the cooling model of core/thermal.py
// (facility_power_kernel).  No second barrier.
//
// Arithmetic follows the reference term for term in f32; the library is
// built without --use_fast_math and with --fmad=false, so sqrtf and the
// divisions are IEEE and no multiply-add is contracted.  A division by a
// constant of the configuration (1000, the economizer's range) is the
// product with its f32 reciprocal, as the reference's jitted kernel
// computes it; a division by a value of the step stays IEEE.  Only the
// order of the IT sum differs from the reference's.
#include "common.cuh"

// Parameter blocks passed by value; named (not file-local) types, so the
// extern "C" entry points that take them keep external linkage.
struct PowerParams {
  float cpu_idle, cpu_span, gpu_idle, gpu_span;  // W; span = max - idle
  int cpu_curve, gpu_curve;                      // 0 linear 1 sqrt 2 square 3 cubic
};

struct CoolingParams {
  float econ_range, tower_approach, condenser_lift, carnot_eff, max_cop,
      fan_overhead, evap_l_per_kwh;
};

namespace {

constexpr float kInvKilo = 1.0f / 1000.0f;  // rounded once, in f32

__device__ __forceinline__ float curve(float u, int kind) {
  switch (kind) {
    case 1: return sqrtf(u);
    case 2: return u * u;
    case 3: return u * u * u;
    default: return u;
  }
}

// kW drawn by one host: (p_cpu + p_gpu) * on / 1000.
__device__ __forceinline__ float host_kw(float cpu_u, float gpu_u,
                                         float n_gpus, float on,
                                         const PowerParams& p) {
  const float cu = fminf(fmaxf(cpu_u, 0.0f), 1.0f);
  const float gu = fminf(fmaxf(gpu_u, 0.0f), 1.0f);
  const float p_cpu = p.cpu_idle + p.cpu_span * curve(cu, p.cpu_curve);
  const float p_gpu = (p.gpu_idle + p.gpu_span * curve(gu, p.gpu_curve)) * n_gpus;
  return (p_cpu + p_gpu) * on * kInvKilo;
}

// The row pass of both kernels: one host a thread (a row wider than the
// block takes a further pass for each blockDim.x more hosts), the host's
// four loads issued before any is used, the per-host power stored, and the
// row's IT sum as a warp shuffle tree, one barrier and a second tree in
// warp 0.  Returns true in thread 0 alone, with the sum in `total`; every
// other thread is done when it returns.  The caller issues its tail's
// per-row loads in thread 0 before the call, so they are in flight with
// the hosts'.
__device__ __forceinline__ bool row_pass(const float* __restrict__ cpu_u,
                                         const float* __restrict__ gpu_u,
                                         const float* __restrict__ n_gpus,
                                         const float* __restrict__ on, int H,
                                         const PowerParams& p,
                                         float* __restrict__ power,
                                         float& total) {
  __shared__ float warp_sums[32];
  const int tid = threadIdx.x, n = blockDim.x;
  float part = 0.0f;
  for (int h = tid; h < H; h += n) {
    const float kw = host_kw(cpu_u[h], gpu_u[h], n_gpus[h], on[h], p);
    power[h] = kw;
    part += kw;
  }
  const int lane = tid & 31, warp = tid >> 5;
  for (int s = 16; s > 0; s >>= 1)
    part += __shfl_down_sync(steam::kFull, part, s);
  if (lane == 0) warp_sums[warp] = part;
  __syncthreads();
  if (warp != 0) return false;
  total = lane < (n >> 5) ? warp_sums[lane] : 0.0f;
  for (int s = 16; s > 0; s >>= 1)
    total += __shfl_down_sync(steam::kFull, total, s);
  return lane == 0;
}

__global__ void __launch_bounds__(1024)
power_carbon_kernel(const float* __restrict__ cpu_u,
                    const float* __restrict__ gpu_u,
                    const float* __restrict__ n_gpus,
                    const float* __restrict__ on,
                    const float* __restrict__ ci, float dt, int H,
                    PowerParams p, float* __restrict__ power,
                    float* __restrict__ it, float* __restrict__ carbon) {
  const size_t row = blockIdx.x, off = row * (size_t)H;
  float ci_row = 0.0f, total;
  if (threadIdx.x == 0 && ci != nullptr) ci_row = ci[row];
  if (!row_pass(cpu_u + off, gpu_u + off, n_gpus + off, on + off, H, p,
                power + off, total))
    return;
  // the carbon tail of power_carbon.py, in the reference's order
  it[row] = total;
  carbon[row] = ci == nullptr ? 0.0f : total * dt * ci_row * kInvKilo;
}

__global__ void __launch_bounds__(1024)
facility_power_kernel(const float* __restrict__ cpu_u,
                      const float* __restrict__ gpu_u,
                      const float* __restrict__ n_gpus,
                      const float* __restrict__ on,
                      const float* __restrict__ wet_bulb,
                      const float* __restrict__ setpoint, int H,
                      PowerParams p, CoolingParams c,
                      float* __restrict__ power, float* __restrict__ it,
                      float* __restrict__ cooling,
                      float* __restrict__ water) {
  const size_t row = blockIdx.x, off = row * (size_t)H;
  float wb = 0.0f, sp = 0.0f, total;
  if (threadIdx.x == 0) {
    wb = wet_bulb[row];
    sp = setpoint[row];
  }
  if (!row_pass(cpu_u + off, gpu_u + off, n_gpus + off, on + off, H, p,
                power + off, total))
    return;
  // the cooling tail of power_carbon.py:110-122 / core/thermal.py
  const float rng = fmaxf(c.econ_range, 1e-6f);
  const float frac =
      fminf(fmaxf((wb - (sp - rng)) * (1.0f / rng), 0.0f), 1.0f);
  const float lift = fmaxf(wb + c.tower_approach + c.condenser_lift - sp, 1.0f);
  const float cop = fminf(fmaxf(c.carnot_eff * (sp + 273.15f) / lift, 1.0f),
                          c.max_cop);
  const float chiller_kw = frac * total / cop;
  it[row] = total;
  cooling[row] = c.fan_overhead * total + chiller_kw;
  water[row] = (frac * total + chiller_kw) * c.evap_l_per_kwh;
}

// Launch latency alone: the floor of any kernel launched on the same grid.
__global__ void empty_kernel() {}

}  // namespace

// `threads` (a multiple of 32, at most 1024) comes from the wrappers
// (power_carbon.py, `facility_block`), for both kernels.
extern "C" int steam_power_carbon(const float* cpu_u, const float* gpu_u,
                                  const float* n_gpus, const float* on,
                                  const float* ci, float dt, int B, int H,
                                  int threads, const PowerParams* p,
                                  float* power, float* it, float* carbon,
                                  void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  power_carbon_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      cpu_u, gpu_u, n_gpus, on, ci, dt, H, *p, power, it, carbon);
  return (int)cudaGetLastError();
}

extern "C" int steam_facility_power(const float* cpu_u, const float* gpu_u,
                                    const float* n_gpus, const float* on,
                                    const float* wet_bulb,
                                    const float* setpoint, int B, int H,
                                    int threads, const PowerParams* p,
                                    const CoolingParams* c, float* power,
                                    float* it, float* cooling, float* water,
                                    void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > 1024)
    return (int)cudaErrorInvalidValue;
  facility_power_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(
      cpu_u, gpu_u, n_gpus, on, wet_bulb, setpoint, H, *p, *c, power, it,
      cooling, water);
  return (int)cudaGetLastError();
}

extern "C" int steam_empty_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_power_carbon_error_string)
