"""The ops layer: one entry per hand-written kernel, dispatched on device.

A CUDA tensor launches the kernel (csrc/*.cu through the wrappers in this
package) or raises; a CPU tensor takes the kernel's plain version in
kernels/ref.py.  There is no fallback from a failed launch and no switch
that sends CUDA tensors to the plain versions.

Each kernel keeps a launch count, added to by its wrapper at the launch and
nowhere else; `launch_counts()` / `reset_launch_counts()` read and clear
them, so a run can show which kernels its path went through.
"""
from __future__ import annotations

from . import build, ref
from . import first_fit as _first_fit
from . import flash_attn as _flash_attn
from . import fused_step as _fused_step
from . import power_carbon as _power_carbon
from . import ssd_chunk as _ssd_chunk

launch_counts = build.launch_counts
reset_launch_counts = build.reset_launch_counts
KERNELS = build.KERNELS


def host_power(cpu_util, gpu_util, n_gpus, on, cpu_cfg, gpu_cfg):
    """(power_kw[H], it_kw): per-host power and its sum (kernel 1, without
    the carbon tail)."""
    if cpu_util.is_cuda:
        p, it, _ = _power_carbon.fused_power_carbon(
            cpu_util, gpu_util, n_gpus, on, None, 0.0, cpu_cfg, gpu_cfg)
        return p, it
    p, it, _ = ref.fused_power_carbon(cpu_util, gpu_util, n_gpus, on, None,
                                      0.0, cpu_cfg, gpu_cfg)
    return p, it


def fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h, cpu_cfg,
                       gpu_cfg):
    """(power_kw, it_kw, op_carbon_kg) in one pass."""
    impl = _power_carbon if cpu_util.is_cuda else ref
    return impl.fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h,
                                   cpu_cfg, gpu_cfg)


def facility_power(cpu_util, gpu_util, n_gpus, on, wet_bulb_c, setpoint_c,
                   cpu_cfg, gpu_cfg, cooling_cfg):
    """(power_kw, it_kw, cooling_kw, water_l_per_h) in one pass: the power
    block, the host-axis sum and the cooling model of core/thermal.py."""
    impl = _power_carbon if cpu_util.is_cuda else ref
    return impl.fused_facility_power(cpu_util, gpu_util, n_gpus, on,
                                     wet_bulb_c, setpoint_c, cpu_cfg,
                                     gpu_cfg, cooling_cfg)


def first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus):
    """Greedy first-fit of K candidates onto H hosts:
    (assign i32[K], free cores, free GPUs)."""
    impl = _first_fit if cand_cores.is_cuda else ref
    return impl.first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus)


def fused_facility_totals(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                          pv_cf, batt_threshold, ci_rising, cfg, **kwargs):
    """The megakernel's facility half over the whole horizon, reduced to
    the totals dict of `engine.facility_totals_from_flows`."""
    impl = _fused_step if it_kw.is_cuda else ref
    return impl.fused_facility_totals(it_kw, ci, wet_bulb_c, price, price_lo,
                                      price_hi, pv_cf, batt_threshold,
                                      ci_rising, cfg, **kwargs)


def ssd_intra_chunk(xdt, da, b, c):
    """Mamba-2 SSD intra-chunk quadratic form: xdt [B,C,Q,H,P], da
    [B,C,H,Q], b / c [B,C,Q,G,N] (H % G == 0) -> y f32 [B,C,Q,H,P]."""
    impl = _ssd_chunk if xdt.is_cuda else ref
    return impl.ssd_intra_chunk(xdt, da, b, c)


def flash_attention(q, k, v, *, scale: float, causal: bool = True):
    """Online-softmax attention: q [B,Sq,H,D], k / v [B,Sk,KV,D] -> like q
    (causal mask top-left aligned, f32 accumulation)."""
    impl = _flash_attn if q.is_cuda else ref
    return impl.flash_attention(q, k, v, scale=scale, causal=causal)
