"""Synthetic per-region user-traffic arrival-rate traces.

Real request logs at datacenter scale (Google/Azure/Meta serving traces)
are not redistributable offline, so — mirroring carbontraces/,
weathertraces/, pricetraces/ and renewabletraces/ — each region gets a
deterministic synthetic arrival-rate curve

    rate(t) = base * max(floor, 1 + a_d sin(2*pi*(t_local-phi_d)/24)
                                + dip(t_local, weekend)
                                + AR(1) noise + flash crowds)   [tasks/h]

driven by the region's USER population, not by an abstract rate knob.

Traffic-curve calibration
-------------------------
The shape constants below are calibrated to the published diurnal
signatures of large consumer services (Meta's Messenger/web serving
curves, Google cluster front-ends, Azure Functions):

* **User base -> demand level.**  Each region serves `users_m` million
  active users; every million users contributes `tasks_per_muser_h`
  schedulable tasks per hour (requests batch into tasks upstream, so this
  is task -- not request -- throughput).  The defaults put a mid-size
  region at a few hundred tasks/hour, which at SURF-like task sizes keeps
  a O(100)-host site near the paper's ~60-80% occupancy.
* **Diurnal swing.**  Consumer traffic peaks in the local evening
  (phase anchor ~19:00) and bottoms out at 03:00-05:00 local; published
  peak-to-trough ratios for consumer services sit at 3-5x, which the
  default `diurnal_amp` range (0.35-0.55 relative) reproduces once the
  overnight trough discount is added: (1 + a) / (1 - a - 0.15) spans
  ~2.9x-5.2x across the range before noise widens it slightly.
* **Weekly cycle.**  Work-adjacent services dip 10-30% on weekends
  (`weekly_amp`); the dip is a smooth 168 h harmonic, not a hard gate, so
  Fridays/Mondays shoulder naturally.
* **Timezone offsets.**  A region's local evening is anchored to the SAME
  `phase_d` its carbon trace uses (carbontraces.sample_region_params):
  solar generation and human activity share the sun, so the demand peak
  trails the region's solar phase.  That correlation is the point — it is
  what makes "follow the sun" spatial scheduling meet "follow the users"
  interactive traffic head-on.
* **Burstiness.**  Slow AR(1) noise (std `noise_sigma`, hours of memory)
  models organic demand drift; a rare fast-decaying flash-crowd process
  (launch events, virality) adds the positive excursions autoscalers hate.

Two consumers:

* `make_arrival_rate_traces` -> f32[R, S] tasks/hour, the per-step rate
  family (plot it, feed autoscaler studies, or integrate it yourself).
* `make_arrival_sets` -> f32[R, T] per-task arrival HOURS, sampled from
  each region's rate curve by inverse-CDF (the same nonhomogeneous-
  Poisson construction workloads/synthetic.py uses) and sorted — exactly
  what `grid.tasktrace_axis` / the `arrival_trace` dyn key consume to
  re-time one task population per region in one grid run.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.carbontraces.synthetic import sample_region_params

N_REGIONS = 158


class TrafficParams(NamedTuple):
    users_m: np.ndarray           # millions of active users served
    tasks_per_muser_h: np.ndarray # tasks/hour contributed per million users
    diurnal_amp: np.ndarray       # relative evening-peak amplitude
    weekly_amp: np.ndarray        # relative weekend dip
    phase_d: np.ndarray           # local-evening anchor, hours (from carbon)
    phase_w: np.ndarray           # weekly phase, hours
    noise_sigma: np.ndarray       # AR(1) stationary std (relative)
    noise_rho: np.ndarray         # AR(1) memory
    crowd_prob: np.ndarray        # per-hour flash-crowd probability
    crowd_scale: np.ndarray       # mean relative magnitude of a crowd
    crowd_rho: np.ndarray         # fast decay of the crowd process


def sample_traffic_params(n_regions: int = N_REGIONS,
                          seed: int = 0) -> TrafficParams:
    """Per-region traffic parameters, correlated with the carbon regions of
    the same (n_regions, seed) — see the module docstring's calibration
    notes.  Population sizes are log-uniform (a few markets dominate)."""
    carbon = sample_region_params(n_regions, seed)
    rng = np.random.default_rng(seed + 29)
    users_m = np.exp(rng.uniform(np.log(0.5), np.log(50.0), n_regions))
    tasks_per_muser_h = rng.uniform(6.0, 14.0, n_regions)
    diurnal_amp = rng.uniform(0.35, 0.55, n_regions)
    weekly_amp = rng.uniform(0.05, 0.15, n_regions)
    # local evening trails the solar/diurnal anchor the carbon trace uses:
    # same sun, same humans (small local offset for media habits)
    phase_d = (carbon.phase_d + rng.uniform(-1.5, 1.5, n_regions)) % 24.0
    phase_w = rng.uniform(0.0, 168.0, n_regions)
    noise_sigma = rng.uniform(0.03, 0.10, n_regions)
    noise_rho = rng.uniform(0.95, 0.99, n_regions)
    crowd_prob = rng.uniform(0.001, 0.006, n_regions)
    crowd_scale = rng.uniform(0.3, 1.2, n_regions)
    crowd_rho = rng.uniform(0.5, 0.8, n_regions)
    return TrafficParams(users_m, tasks_per_muser_h, diurnal_amp, weekly_amp,
                         phase_d, phase_w, noise_sigma, noise_rho,
                         crowd_prob, crowd_scale, crowd_rho)


def make_arrival_rate_traces(n_steps: int, dt_h: float = 0.25,
                             n_regions: int = N_REGIONS,
                             seed: int = 0) -> np.ndarray:
    """f32[n_regions, n_steps] task arrival rates (tasks/hour)."""
    p = sample_traffic_params(n_regions, seed)
    rng = np.random.default_rng(seed + 31)
    t = np.arange(n_steps) * dt_h                                    # [S]
    local = (t[None, :] - p.phase_d[:, None]) % 24.0                 # [R, S]
    # evening crest at local hour ~19, overnight trough at 03-05 local: the
    # sine is phased so its maximum lands at 19:00 local
    diurnal = p.diurnal_amp[:, None] * np.sin(
        2 * np.pi * (local - 13.0) / 24.0)
    # extra overnight discount deepens the 03-05 trough to the published
    # 3-5x peak-to-trough band without flattening the evening shoulder
    trough = -0.15 * ((local >= 1.0) & (local < 6.0))
    weekly = -p.weekly_amp[:, None] * (
        1.0 + np.sin(2 * np.pi * (t[None] - p.phase_w[:, None]) / 168.0))
    rho = p.noise_rho[:, None]
    eps = (rng.standard_normal((n_regions, n_steps))
           * p.noise_sigma[:, None] * np.sqrt(1.0 - rho**2))
    crowd_jump = (rng.uniform(size=(n_regions, n_steps))
                  < p.crowd_prob[:, None] * dt_h)
    crowd_mag = crowd_jump * rng.exponential(1.0, (n_regions, n_steps)) \
        * p.crowd_scale[:, None]
    crho = p.crowd_rho[:, None]
    noise = np.zeros_like(eps)
    acc = np.zeros((n_regions, 1))
    crowd = np.zeros_like(eps)
    cacc = np.zeros((n_regions, 1))
    for s in range(n_steps):                 # host-side; fine for generation
        acc = rho * acc + eps[:, s:s + 1]
        noise[:, s:s + 1] = acc
        cacc = crho * cacc + crowd_mag[:, s:s + 1]
        crowd[:, s:s + 1] = cacc
    base = p.users_m * p.tasks_per_muser_h                           # [R]
    shape = np.maximum(1.0 + diurnal + trough + weekly + noise + crowd, 0.05)
    return (base[:, None] * shape).astype(np.float32)


def make_arrival_sets(n_tasks: int, n_steps: int, dt_h: float = 0.25,
                      n_regions: int = N_REGIONS, seed: int = 0,
                      rates: np.ndarray | None = None) -> np.ndarray:
    """f32[n_regions, n_tasks] sorted per-task arrival hours.

    Samples `n_tasks` arrivals from each region's rate curve by inverse-CDF
    over the cumulative rate (nonhomogeneous-Poisson order statistics,
    the construction workloads/synthetic.py uses), so arrival DENSITY
    tracks the traffic curve: evening-peak hours receive 3-5x the arrivals
    of the overnight trough.  Rows are sorted ascending — the task-table
    FIFO invariant `grid.tasktrace_axis` requires.  Pass `rates` to reuse
    a precomputed `make_arrival_rate_traces` array.
    """
    if rates is None:
        rates = make_arrival_rate_traces(n_steps, dt_h, n_regions, seed)
    rates = np.asarray(rates, np.float64)
    n_regions = rates.shape[0]
    rng = np.random.default_rng(seed + 37)
    horizon = rates.shape[1] * dt_h
    cum = np.cumsum(rates * dt_h, axis=1)                          # [R, S]
    out = np.empty((n_regions, n_tasks), np.float64)
    grid_t = (np.arange(rates.shape[1]) + 1) * dt_h
    for r in range(n_regions):
        u = np.sort(rng.uniform(0.0, cum[r, -1], n_tasks))
        out[r] = np.interp(u, cum[r], grid_t)
    return np.clip(out, 0.0, horizon).astype(np.float32)


def traffic_stats(traces: np.ndarray, dt_h: float = 0.25):
    """(mean rate, peak-to-trough daily ratio) per region — the two numbers
    that size a site and decide how much demand an autoscaler can chase."""
    steps_per_day = max(int(round(24.0 / dt_h)), 1)
    s = traces.shape[1] - traces.shape[1] % steps_per_day
    days = traces[:, :s].reshape(traces.shape[0], -1, steps_per_day)
    ratio = (days.max(axis=2)
             / np.maximum(days.min(axis=2), 1e-9)).mean(axis=1)
    return traces.mean(axis=1), ratio
