"""Statistical power models (paper §IV-A, §V-C1).

Converts component utilization (0..1) into power draw (kW) with the
linear / sqrt / square / cubic curves of the reference; the paper's
experiments use sqrt for CPUs and linear for GPUs.
"""
from __future__ import annotations

import torch

from .config import PowerModelConfig

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
    (its kernel tests hold the two to rtol 1e-5)."""
    for m in (cpu_cfg, gpu_cfg):
        if m.model not in CURVES:
            raise ValueError(f"unknown power model '{m.model}'")
    cpu_u = torch.clamp(cpu_util, 0.0, 1.0)
    gpu_u = torch.clamp(gpu_util, 0.0, 1.0)
    p_cpu = cpu_cfg.idle_w + (cpu_cfg.max_w - cpu_cfg.idle_w) * CURVES[
        cpu_cfg.model](cpu_u)
    p_gpu = (gpu_cfg.idle_w + (gpu_cfg.max_w - gpu_cfg.idle_w) * CURVES[
        gpu_cfg.model](gpu_u)) * n_gpus
    return (p_cpu + p_gpu) * on_mask / 1000.0
