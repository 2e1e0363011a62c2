"""Launch wrappers of the per-host power kernels (csrc/power_carbon.cu).

`fused_power_carbon` replaces the Pallas kernel of the same name
(src/repro/kernels/power_carbon.py): per-host CPU+GPU power curves, the
host-axis sum and carbon = sum * dt * ci / 1000.  `fused_facility_power`
replaces `fused_facility_power`: the same power block and sum plus the
cooling tail of core/thermal.py.  Inputs are f32 [H] or [B, H] (one row per
scenario); the kernels run one thread block per row.  The wrappers check
their inputs, allocate the outputs and launch on PyTorch's current stream;
they take CUDA tensors only (kernels/ops.py routes CPU tensors to the plain
versions in kernels/ref.py).  A step calls them once each, so they keep
their host work small: the ctypes parameter blocks are built once per
configuration, and inputs that already are contiguous f32 are not copied.
"""
from __future__ import annotations

import ctypes

import torch

from ..core.config import CoolingConfig, PowerModelConfig
from . import build

CURVE_CODES = {"linear": 0, "sqrt": 1, "square": 2, "cubic": 3}
# the block of both kernels' row pass: one host a thread, at most MAX_THREADS
MAX_THREADS = 1024


class _PowerParams(ctypes.Structure):
    _fields_ = [("cpu_idle", ctypes.c_float), ("cpu_span", ctypes.c_float),
                ("gpu_idle", ctypes.c_float), ("gpu_span", ctypes.c_float),
                ("cpu_curve", ctypes.c_int), ("gpu_curve", ctypes.c_int)]


class _CoolingParams(ctypes.Structure):
    _fields_ = [(f, ctypes.c_float) for f in (
        "econ_range", "tower_approach", "condenser_lift", "carnot_eff",
        "max_cop", "fan_overhead", "evap_l_per_kwh")]


_POWER_ARGS = [*[ctypes.c_void_p] * 5, ctypes.c_float, *[ctypes.c_int] * 3,
               ctypes.POINTER(_PowerParams),
               *[ctypes.c_void_p] * 4]
_FACILITY_ARGS = [*[ctypes.c_void_p] * 6, *[ctypes.c_int] * 3,
                  ctypes.POINTER(_PowerParams),
                  ctypes.POINTER(_CoolingParams), *[ctypes.c_void_p] * 5]
_params: dict = {}


def _power_params(cpu: PowerModelConfig, gpu: PowerModelConfig):
    """The kernels' power parameter block, built once per configuration."""
    key = (cpu, gpu)
    if key not in _params:
        for m in (cpu, gpu):
            if m.model not in CURVE_CODES:
                raise ValueError(f"unknown power model '{m.model}'")
        # the span is formed in double and rounded once, as the reference
        # forms `(max_w - idle_w)` from Python floats
        _params[key] = ctypes.byref(_PowerParams(
            cpu.idle_w, cpu.max_w - cpu.idle_w, gpu.idle_w,
            gpu.max_w - gpu.idle_w, CURVE_CODES[cpu.model],
            CURVE_CODES[gpu.model]))
    return _params[key]


def _cooling_params(c: CoolingConfig):
    """The cooling tail's parameter block, built once per configuration."""
    if c not in _params:
        _params[c] = ctypes.byref(_CoolingParams(
            c.economizer_range_c, c.tower_approach_c, c.condenser_lift_c,
            c.carnot_efficiency, c.max_cop, c.fan_pump_overhead,
            c.evap_l_per_kwh_heat))
    return _params[c]


def facility_block(h: int) -> int:
    """Threads of the row pass's block (both kernels) for a row of `h`
    hosts: one a host, rounded up to a warp, at most MAX_THREADS (a wider
    row takes further passes)."""
    return min(max(-(-h // 32) * 32, 32), MAX_THREADS)


def _rows(*xs):
    """[H] or [B, H] inputs as contiguous f32 of one shape; (B, H)."""
    rows = [build.f32(x) for x in xs]
    shape = rows[0].shape
    if any(r.shape != shape for r in rows) or len(shape) not in (1, 2):
        raise ValueError(f"host inputs must share one [H] or [B, H] shape, "
                         f"got {[tuple(x.shape) for x in xs]}")
    return rows, (1 if len(shape) == 1 else shape[0]), shape[-1]


def _per_row(x, b: int, like: torch.Tensor) -> torch.Tensor:
    """A scalar or [B] per-row input as contiguous f32 of B elements on the
    device (a host number is filled in on the device: no copy, no wait)."""
    if not isinstance(x, torch.Tensor):
        return torch.full((b,), float(x), dtype=torch.float32,
                          device=like.device)
    if (x.numel() == b and x.dtype == torch.float32
            and x.device == like.device and x.is_contiguous()):
        return x
    x = x.to(device=like.device, dtype=torch.float32)
    return x.reshape(-1).expand(b).contiguous() if x.numel() == 1 else \
        x.reshape(b).contiguous()


def fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h: float,
                       cpu_cfg: PowerModelConfig, gpu_cfg: PowerModelConfig):
    """(power_kw, it_kw, carbon_kg) from one launch.  `ci` is a scalar or
    [B] tensor, or None for a power-only call (carbon is then 0)."""
    (cu, gu, ng, o), b, h = _rows(cpu_util, gpu_util, n_gpus, on)
    build.require_cuda("fused_power_carbon", cu, gu, ng, o)
    ci_row = None if ci is None else _per_row(ci, b, cu)
    power = torch.empty(cu.shape, dtype=torch.float32, device=cu.device)
    sums = torch.empty((2, *cu.shape[:-1]), dtype=torch.float32,
                       device=cu.device)
    fn = build.function("power_carbon", "steam_power_carbon", _POWER_ARGS)
    code = fn(cu.data_ptr(), gu.data_ptr(), ng.data_ptr(), o.data_ptr(),
              None if ci_row is None else ci_row.data_ptr(), float(dt_h),
              b, h, facility_block(h), _power_params(cpu_cfg, gpu_cfg),
              power.data_ptr(), sums.data_ptr(), sums.data_ptr() + 4 * b,
              build.stream_of(cu))
    build.check("power_carbon", "fused_power_carbon launch", code)
    build.count_launch("fused_power_carbon")
    it, carbon = sums
    return power, it, carbon


def fused_facility_power(cpu_util, gpu_util, n_gpus, on, wet_bulb_c,
                         setpoint_c, cpu_cfg: PowerModelConfig,
                         gpu_cfg: PowerModelConfig,
                         cooling_cfg: CoolingConfig):
    """(power_kw, it_kw, cooling_kw, water_l_per_h) from one launch;
    `wet_bulb_c` and `setpoint_c` are scalars or [B] tensors."""
    (cu, gu, ng, o), b, h = _rows(cpu_util, gpu_util, n_gpus, on)
    build.require_cuda("fused_facility_power", cu, gu, ng, o)
    wb = _per_row(wet_bulb_c, b, cu)
    sp = _per_row(setpoint_c, b, cu)
    power = torch.empty(cu.shape, dtype=torch.float32, device=cu.device)
    sums = torch.empty((3, *cu.shape[:-1]), dtype=torch.float32,
                       device=cu.device)
    fn = build.function("power_carbon", "steam_facility_power",
                        _FACILITY_ARGS)
    at = sums.data_ptr()
    code = fn(cu.data_ptr(), gu.data_ptr(), ng.data_ptr(), o.data_ptr(),
              wb.data_ptr(), sp.data_ptr(), b, h, facility_block(h),
              _power_params(cpu_cfg, gpu_cfg), _cooling_params(cooling_cfg),
              power.data_ptr(), at, at + 4 * b, at + 8 * b,
              build.stream_of(cu))
    build.check("power_carbon", "fused_facility_power launch", code)
    build.count_launch("fused_facility_power")
    it, cool, water = sums
    return power, it, cool, water


def empty_launch(blocks: int, threads: int, device) -> None:
    """One launch of an empty kernel on `blocks` x `threads`, through this
    library's ctypes path: the device time any launch of that grid pays.  A
    measurement, not a kernel of the main path: it counts no launch."""
    fn = build.function("power_carbon", "steam_empty_launch",
                        [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    code = fn(blocks, threads, ctypes.c_void_p(
        torch.cuda.current_stream(device).cuda_stream))
    build.check("power_carbon", "empty launch", code)
