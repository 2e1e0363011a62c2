"""Launch wrappers of the per-host power kernels (csrc/power_carbon.cu).

`fused_power_carbon` replaces the Pallas kernel of the same name
(src/repro/kernels/power_carbon.py): per-host CPU+GPU power curves, the
host-axis sum and carbon = sum * dt * ci / 1000.  `fused_facility_power`
replaces `fused_facility_power`: the same power block and sum plus the
cooling tail of core/thermal.py.  Inputs are f32 [H] or [B, H] (one row per
scenario); the kernels run one thread block per row.  The wrappers check
their inputs, allocate the outputs and launch on PyTorch's current stream;
they take CUDA tensors only (kernels/ops.py routes CPU tensors to the plain
versions in kernels/ref.py).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.config import CoolingConfig, PowerModelConfig
from . import build

CURVE_CODES = {"linear": 0, "sqrt": 1, "square": 2, "cubic": 3}


class _PowerParams(ctypes.Structure):
    _fields_ = [("cpu_idle", ctypes.c_float), ("cpu_span", ctypes.c_float),
                ("gpu_idle", ctypes.c_float), ("gpu_span", ctypes.c_float),
                ("cpu_curve", ctypes.c_int), ("gpu_curve", ctypes.c_int)]


class _CoolingParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in (
        "econ_range", "tower_approach", "condenser_lift", "carnot_eff",
        "max_cop", "fan_overhead", "evap_l_per_kwh")]


def _power_params(cpu: PowerModelConfig, gpu: PowerModelConfig):
    for m in (cpu, gpu):
        if m.model not in CURVE_CODES:
            raise ValueError(f"unknown power model '{m.model}'")
    # the span is formed in double and rounded once, as the reference
    # forms `(max_w - idle_w)` from Python floats
    return _PowerParams(cpu.idle_w, cpu.max_w - cpu.idle_w, gpu.idle_w,
                        gpu.max_w - gpu.idle_w, CURVE_CODES[cpu.model],
                        CURVE_CODES[gpu.model])


def _rows(*xs):
    """[H] or [B, H] f32 inputs as contiguous [B, H]; (B, H, was_1d)."""
    one_d = xs[0].dim() == 1
    rows = [x.reshape(1, -1) if one_d else x for x in xs]
    rows = [r.to(torch.float32).contiguous() for r in rows]
    shape = rows[0].shape
    if any(r.shape != shape for r in rows) or len(shape) != 2:
        raise ValueError(f"host inputs must share one [H] or [B, H] shape, "
                         f"got {[tuple(x.shape) for x in xs]}")
    return rows, shape[0], shape[1], one_d


def _per_row(x, b: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] per-row input as a contiguous f32 [B] on the device
    (a host number is filled in on the device: no copy, no wait)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((b,), float(x), dtype=torch.float32,
                          device=like.device)
    x = x.to(device=like.device, dtype=torch.float32)
    return x.reshape(-1).expand(b).contiguous() if x.numel() == 1 else \
        x.reshape(b).contiguous()


def fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h: float,
                       cpu_cfg: PowerModelConfig, gpu_cfg: PowerModelConfig):
    """(power_kw, it_kw, carbon_kg) from one launch.  `ci` is a scalar or
    [B] tensor, or None for a power-only call (carbon is then 0)."""
    (cu, gu, ng, o), b, h, one_d = _rows(cpu_util, gpu_util, n_gpus, on)
    build.require_cuda("fused_power_carbon", cu, gu, ng, o)
    ci_row = None if ci is None else _per_row(ci, b, cu)
    power = torch.empty((b, h), dtype=torch.float32, device=cu.device)
    it = torch.empty(b, dtype=torch.float32, device=cu.device)
    carbon = torch.empty(b, dtype=torch.float32, device=cu.device)
    fn = build.function("power_carbon", "steam_power_carbon", [
        *[ctypes.c_void_p] * 5, ctypes.c_float, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_PowerParams), *[ctypes.c_void_p] * 4])
    params = _power_params(cpu_cfg, gpu_cfg)
    code = fn(build.ptr(cu), build.ptr(gu), build.ptr(ng), build.ptr(o),
              None if ci_row is None else build.ptr(ci_row), float(dt_h),
              b, h, ctypes.byref(params), build.ptr(power), build.ptr(it),
              build.ptr(carbon), build.stream_of(cu))
    build.check("power_carbon", "fused_power_carbon launch", code)
    build.count_launch("fused_power_carbon")
    if one_d:
        return power[0], it[0], carbon[0]
    return power, it, carbon


def fused_facility_power(cpu_util, gpu_util, n_gpus, on, wet_bulb_c,
                         setpoint_c, cpu_cfg: PowerModelConfig,
                         gpu_cfg: PowerModelConfig,
                         cooling_cfg: CoolingConfig):
    """(power_kw, it_kw, cooling_kw, water_l_per_h) from one launch;
    `wet_bulb_c` and `setpoint_c` are scalars or [B] tensors."""
    (cu, gu, ng, o), b, h, one_d = _rows(cpu_util, gpu_util, n_gpus, on)
    build.require_cuda("fused_facility_power", cu, gu, ng, o)
    wb = _per_row(wet_bulb_c, b, cu)
    sp = _per_row(setpoint_c, b, cu)
    power = torch.empty((b, h), dtype=torch.float32, device=cu.device)
    it, cool, water = torch.empty((3, b), dtype=torch.float32,
                                  device=cu.device)
    fn = build.function("power_carbon", "steam_facility_power", [
        *[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(_PowerParams), ctypes.POINTER(_CoolingParams),
        *[ctypes.c_void_p] * 5])
    params = _power_params(cpu_cfg, gpu_cfg)
    c = cooling_cfg
    cparams = _CoolingParams(c.economizer_range_c, c.tower_approach_c,
                             c.condenser_lift_c, c.carnot_efficiency,
                             c.max_cop, c.fan_pump_overhead,
                             c.evap_l_per_kwh_heat)
    code = fn(build.ptr(cu), build.ptr(gu), build.ptr(ng), build.ptr(o),
              build.ptr(wb), build.ptr(sp), b, h, ctypes.byref(params),
              ctypes.byref(cparams), build.ptr(power), build.ptr(it),
              build.ptr(cool), build.ptr(water), build.stream_of(cu))
    build.check("power_carbon", "fused_facility_power launch", code)
    build.count_launch("fused_facility_power")
    if one_d:
        return power[0], it[0], cool[0], water[0]
    return power, it, cool, water
