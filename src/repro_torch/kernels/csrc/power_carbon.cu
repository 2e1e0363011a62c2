// Per-host power curves + host-axis sum, with a carbon or a cooling tail.
//
// Replaces the Pallas kernels of src/repro/kernels/power_carbon.py:
//   steam_power_carbon     <- fused_power_carbon   (_kernel, _power_block)
//   steam_facility_power   <- fused_facility_power (_facility_kernel)
//
// What bounds it on an H100: at the simulator's widths (H ~ 1e3 hosts) one
// call moves ~20 KB (four f32 inputs read, one f32 output written), ~6 ns
// at 3.35 TB/s, and does a few thousand flops: it is bound by launch
// latency, not by bytes or operations.  The design keeps the whole step in
// one launch: one thread block per scenario row, 256 threads striding over
// the hosts, the curves evaluated per element, a warp-shuffle block
// reduction for the IT sum, and the scalar tail (carbon, or the cooling
// model of core/thermal.py) run by thread 0 -- so no second launch and no
// atomics.  The leading scenario axis [B, H] lets a scenario grid put one
// row on each SM in a single launch.
//
// Arithmetic follows the reference term for term in f32; the library is
// built without --use_fast_math and with --fmad=false, so sqrtf and the
// divisions are IEEE and no multiply-add is contracted.
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

__device__ __forceinline__ float curve(float u, int kind) {
  switch (kind) {
    case 1: return sqrtf(u);
    case 2: return u * u;
    case 3: return u * u * u;
    default: return u;
  }
}

// kW drawn by host h of a row: (p_cpu + p_gpu) * on / 1000.
__device__ __forceinline__ float host_kw(const float* cpu_u, const float* gpu_u,
                                         const float* n_gpus, const float* on,
                                         int h, const PowerParams& p) {
  const float cu = fminf(fmaxf(cpu_u[h], 0.0f), 1.0f);
  const float gu = fminf(fmaxf(gpu_u[h], 0.0f), 1.0f);
  const float p_cpu = p.cpu_idle + p.cpu_span * curve(cu, p.cpu_curve);
  const float p_gpu = (p.gpu_idle + p.gpu_span * curve(gu, p.gpu_curve)) * n_gpus[h];
  return (p_cpu + p_gpu) * on[h] / 1000.0f;
}

// Power block of one row; returns the row's sum in thread 0.
__device__ float power_row(const float* cpu_u, const float* gpu_u,
                           const float* n_gpus, const float* on, int H,
                           const PowerParams p, float* power, float* scratch) {
  float part = 0.0f;
  for (int h = threadIdx.x; h < H; h += blockDim.x) {
    const float kw = host_kw(cpu_u, gpu_u, n_gpus, on, h, p);
    power[h] = kw;
    part += kw;
  }
  return steam::block_sum(part, scratch);
}

__global__ void power_carbon_kernel(const float* __restrict__ cpu_u,
                                    const float* __restrict__ gpu_u,
                                    const float* __restrict__ n_gpus,
                                    const float* __restrict__ on,
                                    const float* __restrict__ ci, float dt,
                                    int H, PowerParams p,
                                    float* __restrict__ power,
                                    float* __restrict__ it,
                                    float* __restrict__ carbon) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x, off = row * (size_t)H;
  const float total = power_row(cpu_u + off, gpu_u + off, n_gpus + off,
                                on + off, H, p, power + off, scratch);
  if (threadIdx.x == 0) {
    it[row] = total;
    carbon[row] = ci == nullptr ? 0.0f : total * dt * ci[row] / 1000.0f;
  }
}

__global__ void facility_power_kernel(const float* __restrict__ cpu_u,
                                      const float* __restrict__ gpu_u,
                                      const float* __restrict__ n_gpus,
                                      const float* __restrict__ on,
                                      const float* __restrict__ wet_bulb,
                                      const float* __restrict__ setpoint,
                                      int H, PowerParams p, CoolingParams c,
                                      float* __restrict__ power,
                                      float* __restrict__ it,
                                      float* __restrict__ cooling,
                                      float* __restrict__ water) {
  __shared__ float scratch[32];
  const size_t row = blockIdx.x, off = row * (size_t)H;
  const float total = power_row(cpu_u + off, gpu_u + off, n_gpus + off,
                                on + off, H, p, power + off, scratch);
  if (threadIdx.x == 0) {
    // the cooling tail of power_carbon.py:110-122 / core/thermal.py
    const float wb = wet_bulb[row], sp = setpoint[row];
    const float rng = fmaxf(c.econ_range, 1e-6f);
    const float frac = fminf(fmaxf((wb - (sp - rng)) / rng, 0.0f), 1.0f);
    const float lift = fmaxf(wb + c.tower_approach + c.condenser_lift - sp, 1.0f);
    const float cop = fminf(fmaxf(c.carnot_eff * (sp + 273.15f) / lift, 1.0f),
                            c.max_cop);
    const float chiller_kw = frac * total / cop;
    it[row] = total;
    cooling[row] = c.fan_overhead * total + chiller_kw;
    water[row] = (frac * total + chiller_kw) * c.evap_l_per_kwh;
  }
}

}  // namespace

extern "C" int steam_power_carbon(const float* cpu_u, const float* gpu_u,
                                  const float* n_gpus, const float* on,
                                  const float* ci, float dt, int B, int H,
                                  const PowerParams* p, float* power,
                                  float* it, float* carbon, void* stream) {
  power_carbon_kernel<<<B, steam::kThreads, 0, (cudaStream_t)stream>>>(
      cpu_u, gpu_u, n_gpus, on, ci, dt, H, *p, power, it, carbon);
  return (int)cudaGetLastError();
}

extern "C" int steam_facility_power(const float* cpu_u, const float* gpu_u,
                                    const float* n_gpus, const float* on,
                                    const float* wet_bulb,
                                    const float* setpoint, int B, int H,
                                    const PowerParams* p,
                                    const CoolingParams* c, float* power,
                                    float* it, float* cooling, float* water,
                                    void* stream) {
  facility_power_kernel<<<B, steam::kThreads, 0, (cudaStream_t)stream>>>(
      cpu_u, gpu_u, n_gpus, on, wet_bulb, setpoint, H, *p, *c, power, it,
      cooling, water);
  return (int)cudaGetLastError();
}

STEAM_ERROR_STRING_FN(steam_power_carbon_error_string)
