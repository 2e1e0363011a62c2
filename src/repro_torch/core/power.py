"""Statistical power models (paper §IV-A, §V-C1).

Converts component utilization (0..1) into power draw (kW) with the
linear / sqrt / square / cubic curves of the reference; the paper's
experiments use sqrt for CPUs and linear for GPUs.  `calibrate_power_model`
fits a curve's idle and peak draw to telemetry (paper §VIII) and `mape`
scores the fit; both run in numpy on the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import PowerModelConfig, inv_f32

CURVES = {
    "linear": lambda u: u,
    "sqrt": torch.sqrt,
    "square": lambda u: u * u,
    "cubic": lambda u: u * u * u,
}

# Per-class utilization profiles (mean cpu_util, gpu_util), indexed by the
# state.JOB_* codes (batch, training, interactive).
JOB_CLASS_CPU_UTIL = (0.80, 0.55, 0.35)
JOB_CLASS_GPU_UTIL = (0.30, 0.95, 0.60)


def class_utilization(job_class):
    """Per-task (cpu_util, gpu_util) f32 from the class profile tables;
    out-of-range codes clamp to the nearest class."""
    cls = torch.clamp(job_class.long(), 0, len(JOB_CLASS_CPU_UTIL) - 1)
    table = torch.tensor((JOB_CLASS_CPU_UTIL, JOB_CLASS_GPU_UTIL),
                         dtype=torch.float32, device=job_class.device)
    return table[0][cls], table[1][cls]


def host_power_kw(cpu_util, gpu_util, n_gpus, on_mask,
                  cpu_cfg: PowerModelConfig, gpu_cfg: PowerModelConfig):
    """Per-host draw in kW: (p_cpu + p_gpu * n_gpus) * on / 1000, with idle
    draw whenever a host is on (`on_mask`: active AND up, as f32).

    Associated as the reference's fused Pallas kernel does; the reference's
    jnp model divides each component by 1000 first, a difference of ULPs
    (its kernel tests hold the two to rtol 1e-5).  The division by 1000 is
    the product with its f32 reciprocal that the jitted kernel computes."""
    for m in (cpu_cfg, gpu_cfg):
        if m.model not in CURVES:
            raise ValueError(f"unknown power model '{m.model}'")
    cpu_u = torch.clamp(cpu_util, 0.0, 1.0)
    gpu_u = torch.clamp(gpu_util, 0.0, 1.0)
    p_cpu = cpu_cfg.idle_w + (cpu_cfg.max_w - cpu_cfg.idle_w) * CURVES[
        cpu_cfg.model](cpu_u)
    p_gpu = (gpu_cfg.idle_w + (gpu_cfg.max_w - gpu_cfg.idle_w) * CURVES[
        gpu_cfg.model](gpu_u)) * n_gpus
    return (p_cpu + p_gpu) * on_mask * inv_f32(1000.0)


def component_power_kw(util, cfg: PowerModelConfig, present=None):
    """kW drawn by one component class: idle draw whenever the component
    is present, plus the curve's share of (max - idle) at `util` (clamped
    to [0, 1]); `present` scales it (e.g. the host's GPU count)."""
    if cfg.model not in CURVES:
        raise ValueError(f"unknown power model '{cfg.model}'")
    u = torch.clamp(util, 0.0, 1.0)
    watts = cfg.idle_w + (cfg.max_w - cfg.idle_w) * CURVES[cfg.model](u)
    if present is not None:
        watts = watts * present
    return watts * inv_f32(1000.0)


def calibrate_power_model(utils, watts, model: str = "sqrt",
                          idle_bounds=(0.0, 1e4)) -> PowerModelConfig:
    """Least-squares calibration of (idle_w, max_w) on telemetry (paper
    §VIII).  With a fixed curve f, P = idle + (max - idle) f(u) is linear
    in (idle, max - idle): a two-parameter least squares in closed form, in
    float64 numpy."""
    u = np.clip(np.asarray(utils, np.float64), 0.0, 1.0)
    w = np.asarray(watts, np.float64)
    f = {"linear": u, "sqrt": np.sqrt(u), "square": u ** 2,
         "cubic": u ** 3}[model]
    a = np.stack([np.ones_like(f), f], axis=-1)
    coef, *_ = np.linalg.lstsq(a, w, rcond=None)
    idle = float(np.clip(coef[0], *idle_bounds))
    mx = float(idle + max(coef[1], 0.0))
    return PowerModelConfig(idle_w=idle, max_w=mx, model=model)


def mape(pred, actual) -> float:
    """Mean absolute percentage error of `pred` against `actual` (entries
    with |actual| <= 1e-9 left out), in float64."""
    pred = np.asarray(pred, np.float64)
    actual = np.asarray(actual, np.float64)
    mask = np.abs(actual) > 1e-9
    return float(np.mean(np.abs((pred[mask] - actual[mask]) / actual[mask]))
                 * 100.0)
