"""Synthetic carbon-intensity traces for 158 regions (paper Appendix A).

A copy of the reference package's generator (host-side numpy, deterministic
by seed): per region

    ci(t) = mean * max(0.05, 1 + a_d sin(2*pi*(t-phi_d)/24)
                             + a_w sin(2*pi*(t-phi_w)/168)
                             + a_s sin(2*pi*t/(24*365.25))
                             + AR(1) noise)

with (mean, a_d, a_w, noise) drawn per region to reproduce the published
spread: means 15-860 gCO2/kWh, daily variability ~0-0.6.  The same seed
gives the reference's arrays bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

N_REGIONS = 158


class RegionParams(NamedTuple):
    mean: np.ndarray        # gCO2/kWh
    daily_amp: np.ndarray   # relative diurnal amplitude
    weekly_amp: np.ndarray
    seasonal_amp: np.ndarray
    noise_sigma: np.ndarray
    noise_rho: np.ndarray
    phase_d: np.ndarray
    phase_w: np.ndarray


def sample_region_params(n_regions: int = N_REGIONS,
                         seed: int = 0) -> RegionParams:
    rng = np.random.default_rng(seed)
    # log-beta means over [15, 860] with most mass in the 100-600 band
    mean = np.exp(np.log(15.0) + (np.log(860.0) - np.log(15.0))
                  * rng.beta(2.5, 1.6, n_regions))
    greenness = 1.0 - (np.log(mean) - np.log(15.0)) / (np.log(860.0)
                                                        - np.log(15.0))
    # variability: greenness mixed with an independent component
    mix = 0.3 * greenness + 0.7 * rng.uniform(0.0, 1.0, n_regions)
    daily_amp = np.clip(rng.beta(2.0, 3.0, n_regions) * (0.1 + 1.3 * mix),
                        0.0, 0.6)
    weekly_amp = rng.uniform(0.0, 0.15, n_regions)
    seasonal_amp = rng.uniform(0.0, 0.25, n_regions)
    # rho 0.97-0.995 at 15-min steps = 8-50 h noise memory
    noise_sigma = rng.uniform(0.02, 0.10, n_regions)
    noise_rho = rng.uniform(0.97, 0.995, n_regions)
    phase_d = rng.uniform(0.0, 24.0, n_regions)
    phase_w = rng.uniform(0.0, 168.0, n_regions)
    return RegionParams(mean, daily_amp, weekly_amp, seasonal_amp,
                        noise_sigma, noise_rho, phase_d, phase_w)


def make_region_traces(n_steps: int, dt_h: float = 0.25,
                       n_regions: int = N_REGIONS,
                       seed: int = 0) -> np.ndarray:
    """f32[n_regions, n_steps] carbon intensity traces (gCO2/kWh), as numpy
    (move them with `torch.as_tensor(..., device=...)`)."""
    p = sample_region_params(n_regions, seed)
    rng = np.random.default_rng(seed + 1)
    t = np.arange(n_steps) * dt_h
    base = (1.0
            + p.daily_amp[:, None] * np.sin(
                2 * np.pi * (t[None] - p.phase_d[:, None]) / 24.0)
            + p.weekly_amp[:, None] * np.sin(
                2 * np.pi * (t[None] - p.phase_w[:, None]) / 168.0)
            + p.seasonal_amp[:, None] * np.sin(
                2 * np.pi * t[None] / (24 * 365.25)))
    # AR(1) noise with stationary std = noise_sigma
    rho = p.noise_rho[:, None]
    eps = (rng.standard_normal((n_regions, n_steps))
           * p.noise_sigma[:, None] * np.sqrt(1.0 - rho**2))
    noise = np.zeros_like(eps)
    acc = np.zeros((n_regions, 1))
    for s in range(n_steps):
        acc = rho * acc + eps[:, s:s + 1]
        noise[:, s:s + 1] = acc
    ci = p.mean[:, None] * np.maximum(base + noise, 0.05)
    return ci.astype(np.float32)


def trace_stats(traces: np.ndarray, dt_h: float = 0.25):
    """(mean, mean daily variability) per region: the paper Fig 13 axes."""
    steps_per_day = max(int(round(24.0 / dt_h)), 1)
    s = traces.shape[1] - traces.shape[1] % steps_per_day
    days = traces[:, :s].reshape(traces.shape[0], -1, steps_per_day)
    daily_var = (days.std(axis=2)
                 / np.maximum(days.mean(axis=2), 1e-9)).mean(axis=1)
    return traces.mean(axis=1), daily_var
