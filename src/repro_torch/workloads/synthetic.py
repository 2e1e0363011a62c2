"""Synthetic Surf/Marconi/Borg-like workloads (paper Table I/II).

A copy of the reference package's generator: duration distributions around
the published average task durations, diurnal+weekly arrivals, the GPU mix
(Marconi > 90% GPU tasks), topology shapes and embodied costs from Table II,
calibrated so the peak core demand sits at the published optimal-scale
fraction of capacity (Surf 200/277, Marconi 750/972, Borg 900/1534).  The
draws are numpy's, seed for seed the reference's; only the tables are built
with this package's `make_task_table` / `make_host_table`, on `device`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core.config import EmbodiedConfig
from ..core.power import JOB_CLASS_CPU_UTIL, JOB_CLASS_GPU_UTIL
from ..core.state import JOB_INTERACTIVE, make_host_table, make_task_table

# duration multiplier per job class (batch, training, interactive)
CLASS_DURATION_SCALE = (1.0, 3.0, 0.15)


@dataclass(frozen=True)
class WorkloadSpec:
    name: str
    horizon_days: float
    n_hosts: int
    cores_per_host: int
    gpus_per_host: int
    host_embodied_kg: float
    mean_duration_h: float       # ATD from Table I
    duration_sigma: float        # lognormal shape
    gpu_task_frac: float
    cores_choices: tuple[int, ...]
    cores_probs: tuple[float, ...]
    peak_capacity_frac: float    # calibration: peak demand / full capacity
    diurnal_amp: float
    weekly_amp: float


SURF = WorkloadSpec(
    name="surf", horizon_days=124, n_hosts=277, cores_per_host=16,
    gpus_per_host=0, host_embodied_kg=1022.0, mean_duration_h=1.8272,
    duration_sigma=1.2, gpu_task_frac=0.0,
    cores_choices=(1, 2, 4, 8, 16), cores_probs=(0.30, 0.25, 0.25, 0.15, 0.05),
    peak_capacity_frac=0.72, diurnal_amp=0.45, weekly_amp=0.20)

MARCONI = WorkloadSpec(
    name="marconi", horizon_days=30, n_hosts=972, cores_per_host=48,
    gpus_per_host=4, host_embodied_kg=3542.0, mean_duration_h=6.3367,
    duration_sigma=1.1, gpu_task_frac=0.9,
    cores_choices=(4, 8, 16, 32, 48), cores_probs=(0.25, 0.30, 0.25, 0.15, 0.05),
    peak_capacity_frac=0.77, diurnal_amp=0.30, weekly_amp=0.15)

BORG = WorkloadSpec(
    name="borg", horizon_days=31, n_hosts=1534, cores_per_host=64,
    gpus_per_host=0, host_embodied_kg=2250.0, mean_duration_h=2.0309,
    duration_sigma=1.4, gpu_task_frac=0.0,
    cores_choices=(1, 2, 4, 8, 16), cores_probs=(0.40, 0.30, 0.18, 0.09, 0.03),
    peak_capacity_frac=0.59, diurnal_amp=0.35, weekly_amp=0.10)

SPECS = {"surf": SURF, "marconi": MARCONI, "borg": BORG}


def _arrival_envelope(t_h: np.ndarray, spec: WorkloadSpec) -> np.ndarray:
    """Relative arrival rate over time (diurnal + weekly business pattern)."""
    day = 1.0 + spec.diurnal_amp * np.sin(2 * np.pi * (t_h - 10.0) / 24.0)
    week = 1.0 + spec.weekly_amp * np.sin(2 * np.pi * (t_h - 48.0) / 168.0)
    return np.maximum(day * week, 0.05)


def make_workload(kind: str, scale: float = 1.0, seed: int = 0,
                  n_tasks_cap: int | None = None,
                  dt_h: float = 0.25, horizon_days: float | None = None,
                  class_mix: tuple[float, float, float] | None = None,
                  interactive_grace_h: float = 0.25, device="cuda"):
    """Returns (TaskTable, HostTable, spec, meta dict), tables on `device`.

    Expected peak core demand = peak_capacity_frac * capacity; the arrival
    rate follows from Little's law over mean duration x mean cores.
    `horizon_days` truncates the horizon at the same arrival density.
    `class_mix` (batch, training, interactive) types the tasks from its own
    rng stream, so the untyped draws of a seed never change.
    """
    spec = SPECS[kind]
    rng = np.random.default_rng(seed)
    n_hosts = max(int(round(spec.n_hosts * scale)), 4)
    horizon_h = (horizon_days or spec.horizon_days) * 24.0

    mean_cores = float(np.dot(spec.cores_choices, spec.cores_probs))
    # lognormal with target mean: mu = ln(mean) - sigma^2/2
    sig = spec.duration_sigma
    mu = np.log(spec.mean_duration_h) - 0.5 * sig * sig

    peak_rel = 1.0 + spec.diurnal_amp + spec.weekly_amp

    def _demand(n_hosts_):
        cap_ = n_hosts_ * spec.cores_per_host
        mean_demand_ = spec.peak_capacity_frac * cap_ / peak_rel
        lam_ = mean_demand_ / (spec.mean_duration_h * mean_cores)  # tasks/h
        return cap_, mean_demand_, int(lam_ * horizon_h)

    capacity, mean_demand, n_tasks = _demand(n_hosts)
    if n_tasks_cap is not None and n_tasks > n_tasks_cap:
        # fewer hosts at the same demand/capacity ratio
        n_hosts = max(int(n_hosts * n_tasks_cap / n_tasks), 2)
        capacity, mean_demand, n_tasks = _demand(n_hosts)
        n_tasks = min(n_tasks, n_tasks_cap)

    # nonhomogeneous Poisson arrivals by inverse-CDF over the envelope
    grid = np.arange(0.0, horizon_h, dt_h)
    env = _arrival_envelope(grid, spec)
    cdf = np.cumsum(env)
    cdf = cdf / cdf[-1]
    u = np.sort(rng.uniform(0.0, 1.0, n_tasks))
    arrival = np.interp(u, cdf, grid + dt_h)

    duration = np.clip(rng.lognormal(mu, sig, n_tasks), 0.05, 96.0)
    cores = rng.choice(spec.cores_choices, n_tasks, p=spec.cores_probs)
    is_gpu = rng.uniform(size=n_tasks) < spec.gpu_task_frac
    gpus = np.where(is_gpu, rng.integers(1, max(spec.gpus_per_host, 1) + 1,
                                         n_tasks), 0).astype(np.float64)
    if spec.gpus_per_host == 0:
        gpus = np.zeros(n_tasks)
    cpu_util = np.clip(rng.beta(4.0, 2.0, n_tasks), 0.05, 1.0)
    gpu_util = np.where(gpus > 0,
                        np.clip(rng.beta(5.0, 2.0, n_tasks), 0.05, 1.0), 0.0)

    if class_mix is None:
        tasks = make_task_table(arrival, duration, cores, gpus, cpu_util,
                                gpu_util, device=device)
    else:
        mix = np.asarray(class_mix, np.float64)
        mix = mix / mix.sum()
        crng = np.random.default_rng(seed + 101)   # own stream
        job_class = crng.choice(len(mix), n_tasks, p=mix).astype(np.int32)
        duration = np.clip(
            duration * np.asarray(CLASS_DURATION_SCALE)[job_class],
            0.05, 96.0)
        cpu_util = np.asarray(JOB_CLASS_CPU_UTIL, np.float64)[job_class]
        gpu_util = np.where(
            gpus > 0, np.asarray(JOB_CLASS_GPU_UTIL, np.float64)[job_class],
            0.0)
        sla_grace = np.where(job_class == JOB_INTERACTIVE,
                             interactive_grace_h, -1.0)
        tasks = make_task_table(arrival, duration, cores, gpus, cpu_util,
                                gpu_util, job_class=job_class,
                                sla_grace=sla_grace, device=device)
    hosts = make_host_table(n_hosts, spec.cores_per_host, spec.gpus_per_host,
                            device=device)
    meta = {"name": kind, "n_tasks": n_tasks, "n_hosts": n_hosts,
            "capacity_cores": capacity,
            "horizon_h": horizon_h, "mean_demand_cores": mean_demand,
            "embodied": EmbodiedConfig(host_kg=spec.host_embodied_kg)}
    if class_mix is not None:
        meta["class_mix"] = tuple(float(m) for m in mix)
    return tasks, hosts, spec, meta
