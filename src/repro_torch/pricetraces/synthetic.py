"""Synthetic per-region electricity-price traces (spot-like tariffs).

Real day-ahead/spot price series (ENTSO-E, CAISO, ...) are not
redistributable offline, so — mirroring carbontraces/ and weathertraces/ —
each region gets a deterministic synthetic trace

    price(t) = mean * max(floor, 1 + tou(t) + a_d sin(2*pi*(t-phi_d)/24)
                                 + a_w sin(2*pi*(t-phi_w)/168)
                                 + a_s sin(2*pi*t/(24*365.25))
                                 + AR(1) noise + spikes)      [$ / kWh]

with a deterministic time-of-use base `tou(t)` (evening peak block, morning
shoulder, overnight trough), smooth diurnal/weekly/seasonal harmonics, slow
AR(1) noise (fuel/demand drift) and a fast-decaying spike process (scarcity
events: rare positive jumps that relax over a few hours — the signature of
spot markets that makes storage arbitrage pay).

Economics are *correlated* with the carbon regions drawn from the same
`(n_regions, seed)`: fossil-heavy grids (high mean CI) skew toward higher
mean prices AND steeper peak premia — their marginal evening unit is a gas
peaker — while hydro/nuclear-heavy grids are cheap and flat.  A joint
(carbon x price) grid therefore reproduces the coupling CEO-DC shows flips
decarbonization decisions: the dirtiest hours are usually also the dearest,
so carbon-greedy and price-greedy dispatch agree often, but not always —
that residual disagreement is exactly what `dispatch_lambda` sweeps.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.carbontraces.synthetic import sample_region_params

N_REGIONS = 158


class PriceParams(NamedTuple):
    mean: np.ndarray          # $/kWh average tariff level
    tou_amp: np.ndarray       # time-of-use peak premium (relative)
    daily_amp: np.ndarray     # smooth diurnal amplitude (relative)
    weekly_amp: np.ndarray
    seasonal_amp: np.ndarray
    noise_sigma: np.ndarray
    noise_rho: np.ndarray
    spike_prob: np.ndarray    # per-hour probability of a scarcity spike
    spike_scale: np.ndarray   # mean relative magnitude of a spike
    spike_rho: np.ndarray     # fast decay of the spike process
    phase_d: np.ndarray       # diurnal phase, hours (shared with carbon)
    phase_w: np.ndarray


def sample_price_params(n_regions: int = N_REGIONS,
                        seed: int = 0) -> PriceParams:
    """Per-region price parameters, correlated with the carbon regions of
    the same (n_regions, seed) — see module docstring."""
    carbon = sample_region_params(n_regions, seed)
    greenness = 1.0 - ((np.log(carbon.mean) - np.log(15.0))
                       / (np.log(860.0) - np.log(15.0)))
    fossil = np.clip(1.0 - greenness, 0.0, 1.0)
    rng = np.random.default_rng(seed + 13)
    # fuel-cost exposure: fossil grids pay for every marginal MWh, so both
    # the level and the peak premium scale with fossil share (mixed with an
    # independent component: market design and congestion vary regardless)
    expose = np.clip(0.55 * fossil + 0.45 * rng.uniform(0.0, 1.0, n_regions),
                     0.0, 1.0)
    mean = 0.05 + 0.17 * expose                           # 0.05-0.22 $/kWh
    tou_amp = rng.uniform(0.05, 0.20, n_regions) + 0.35 * expose
    daily_amp = rng.uniform(0.05, 0.25, n_regions) * (0.4 + 0.6 * expose)
    weekly_amp = rng.uniform(0.02, 0.12, n_regions)
    seasonal_amp = rng.uniform(0.02, 0.20, n_regions)
    noise_sigma = rng.uniform(0.03, 0.12, n_regions)
    noise_rho = rng.uniform(0.97, 0.995, n_regions)       # hours of memory
    # scarcity spikes: more frequent and taller where peakers set the price
    spike_prob = rng.uniform(0.001, 0.01, n_regions) * (0.3 + 0.7 * expose)
    spike_scale = rng.uniform(0.5, 2.0, n_regions) * (0.4 + 0.6 * expose)
    spike_rho = rng.uniform(0.55, 0.85, n_regions)        # relax in hours
    # evening demand peak: same diurnal phase family as the carbon trace
    # (fossil marginal units serve the same peak), with a small local offset
    phase_d = (carbon.phase_d + rng.uniform(-2.0, 2.0, n_regions)) % 24.0
    phase_w = rng.uniform(0.0, 168.0, n_regions)
    return PriceParams(mean, tou_amp, daily_amp, weekly_amp, seasonal_amp,
                       noise_sigma, noise_rho, spike_prob, spike_scale,
                       spike_rho, phase_d, phase_w)


def _tou_base(t_h: np.ndarray, phase_d: np.ndarray) -> np.ndarray:
    """Deterministic time-of-use profile in [-0.3, 1]: evening peak block
    (4 h at full premium), morning shoulder (half premium), overnight
    trough (discount).  `t_h[S]` hours, `phase_d[R]` shifts the peak."""
    hour = (t_h[None, :] - phase_d[:, None]) % 24.0        # [R, S]
    peak = (hour >= 17.0) & (hour < 21.0)
    shoulder = (hour >= 7.0) & (hour < 11.0)
    trough = hour < 5.0
    return (1.0 * peak + 0.5 * shoulder - 0.3 * trough).astype(np.float64)


def make_price_traces(n_steps: int, dt_h: float = 0.25,
                      n_regions: int = N_REGIONS, seed: int = 0,
                      carbon_tax_per_kg: float = 0.0) -> np.ndarray:
    """f32[n_regions, n_steps] electricity price traces ($/kWh).

    `carbon_tax_per_kg` > 0 folds a carbon tax into the tariff host-side:
    each region's price gains `tax * ci(t) / 1000` $/kWh from the carbon
    trace of the SAME `(n_regions, seed)` (carbontraces/synthetic.py) — the
    one-line way to study carbon pricing without touching the engine, since
    a taxed tariff makes the battery's 'price' policy partially
    carbon-aware by construction.  The default 0.0 leaves the trace
    bitwise unchanged.
    """
    p = sample_price_params(n_regions, seed)
    rng = np.random.default_rng(seed + 17)
    t = np.arange(n_steps) * dt_h                                   # [S]
    base = (1.0
            + p.tou_amp[:, None] * _tou_base(t, p.phase_d)
            # smooth diurnal swing phased so its crest sits in the evening
            # TOU block (phase-relative hour 19) instead of fighting it
            + p.daily_amp[:, None]
            * np.sin(2 * np.pi * (t[None] - p.phase_d[:, None] - 13.0) / 24.0)
            + p.weekly_amp[:, None]
            * np.sin(2 * np.pi * (t[None] - p.phase_w[:, None]) / 168.0)
            + p.seasonal_amp[:, None]
            * np.sin(2 * np.pi * t[None] / (24 * 365.25)))
    # slow AR(1) noise with STATIONARY std = noise_sigma (same correction as
    # the carbon traces: the naive recurrence inflates std by 1/sqrt(1-rho^2))
    rho = p.noise_rho[:, None]
    eps = (rng.standard_normal((n_regions, n_steps))
           * p.noise_sigma[:, None] * np.sqrt(1.0 - rho**2))
    # scarcity spikes: rare positive jumps relaxed by a FAST AR(1) — the
    # classic spot-market signature (hours-long price excursions)
    jump = (rng.uniform(size=(n_regions, n_steps))
            < p.spike_prob[:, None] * dt_h)
    jump_mag = jump * rng.exponential(1.0, (n_regions, n_steps)) \
        * p.spike_scale[:, None]
    srho = p.spike_rho[:, None]
    noise = np.zeros_like(eps)
    acc = np.zeros((n_regions, 1))
    spike = np.zeros_like(eps)
    sacc = np.zeros((n_regions, 1))
    for s in range(n_steps):                 # host-side; fine for generation
        acc = rho * acc + eps[:, s:s + 1]
        noise[:, s:s + 1] = acc
        sacc = srho * sacc + jump_mag[:, s:s + 1]
        spike[:, s:s + 1] = sacc
    price = p.mean[:, None] * np.maximum(base + noise + spike, 0.02)
    if carbon_tax_per_kg:
        from repro_torch.carbontraces.synthetic import make_region_traces
        ci = make_region_traces(n_steps, dt_h, n_regions, seed)  # gCO2/kWh
        price = price + carbon_tax_per_kg * ci / 1000.0
    return price.astype(np.float32)


def price_stats(traces: np.ndarray, dt_h: float = 0.25):
    """(mean price, peak-to-trough daily ratio) per region — the axes that
    decide whether storage arbitrage pays."""
    steps_per_day = max(int(round(24.0 / dt_h)), 1)
    s = traces.shape[1] - traces.shape[1] % steps_per_day
    days = traces[:, :s].reshape(traces.shape[0], -1, steps_per_day)
    ratio = (days.max(axis=2) / np.maximum(days.min(axis=2), 1e-9)).mean(axis=1)
    return traces.mean(axis=1), ratio
