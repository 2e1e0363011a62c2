"""Synthetic per-region wet-bulb temperature traces (weather for cooling).

The thermal subsystem (core/thermal.py) is driven by the *wet-bulb*
temperature: it bounds both the water temperature a cooling tower can produce
(condenser lift -> chiller COP) and the hours in which an economizer can
carry the whole heat load for free.  Real reanalysis weather is not
redistributable offline, so — mirroring carbontraces/synthetic.py — each
region gets a deterministic synthetic trace

    wb(t) = mean + a_d sin(2*pi*(t-phi_d)/24) + a_s sin(2*pi*(t-phi_s)/(24*365.25))
                 + AR(1) noise        [degrees C]

with per-region (mean, amplitudes, noise) drawn to span the real spread of
datacenter sites: annual-mean wet-bulb ~2 C (Nordics) to ~26 C (tropics).

Climate is *correlated* with the carbon-intensity regions generated from the
same seed: low-carbon grids (hydro/wind-heavy) skew toward cool temperate
climates while coal/gas-heavy grids skew hot — so a joint
(carbon-region x climate) grid reproduces the real-world coupling where the
greenest regions are also the cheapest to cool.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.carbontraces.synthetic import sample_region_params

N_REGIONS = 158


class ClimateParams(NamedTuple):
    mean_c: np.ndarray        # annual-mean wet-bulb temperature, degrees C
    daily_amp_c: np.ndarray   # diurnal swing amplitude
    seasonal_amp_c: np.ndarray
    noise_sigma_c: np.ndarray
    noise_rho: np.ndarray
    phase_d: np.ndarray       # diurnal phase, hours
    phase_s: np.ndarray       # seasonal phase, hours


def sample_climate_params(n_regions: int = N_REGIONS,
                          seed: int = 0) -> ClimateParams:
    """Per-region climate parameters, correlated with the carbon regions of
    the same (n_regions, seed) — see module docstring."""
    carbon = sample_region_params(n_regions, seed)
    greenness = 1.0 - ((np.log(carbon.mean) - np.log(15.0))
                       / (np.log(860.0) - np.log(15.0)))
    rng = np.random.default_rng(seed + 7)
    # hot-climate propensity: mostly anti-correlated with grid greenness,
    # mixed with an independent component (green-but-hot sites exist: solar)
    heat = np.clip(0.55 * (1.0 - greenness)
                   + 0.45 * rng.uniform(0.0, 1.0, n_regions), 0.0, 1.0)
    mean_c = 2.0 + 24.0 * heat
    # continental (dry, big swings) vs maritime (humid, damped) split is
    # independent of heat; wet-bulb swings are smaller than dry-bulb ones
    daily_amp_c = rng.uniform(1.5, 5.0, n_regions)
    seasonal_amp_c = rng.uniform(2.0, 10.0, n_regions) * (0.4 + 0.6 * heat)
    noise_sigma_c = rng.uniform(0.5, 2.0, n_regions)
    noise_rho = rng.uniform(0.97, 0.995, n_regions)   # fronts: hours of memory
    phase_d = rng.uniform(0.0, 24.0, n_regions)
    phase_s = rng.uniform(0.0, 24.0 * 365.25, n_regions)
    return ClimateParams(mean_c, daily_amp_c, seasonal_amp_c, noise_sigma_c,
                         noise_rho, phase_d, phase_s)


def make_weather_traces(n_steps: int, dt_h: float = 0.25,
                        n_regions: int = N_REGIONS, seed: int = 0) -> np.ndarray:
    """f32[n_regions, n_steps] wet-bulb temperature traces (degrees C)."""
    p = sample_climate_params(n_regions, seed)
    rng = np.random.default_rng(seed + 11)
    t = np.arange(n_steps) * dt_h                                  # [S]
    base = (p.mean_c[:, None]
            + p.daily_amp_c[:, None]
            * np.sin(2 * np.pi * (t[None] - p.phase_d[:, None]) / 24.0)
            + p.seasonal_amp_c[:, None]
            * np.sin(2 * np.pi * (t[None] - p.phase_s[:, None])
                     / (24.0 * 365.25)))
    # AR(1) noise with STATIONARY std = noise_sigma (same correction as the
    # carbon traces: the naive recurrence inflates std by 1/sqrt(1-rho^2))
    rho = p.noise_rho[:, None]
    eps = (rng.standard_normal((n_regions, n_steps))
           * p.noise_sigma_c[:, None] * np.sqrt(1.0 - rho**2))
    noise = np.zeros_like(eps)
    acc = np.zeros((n_regions, 1))
    for s in range(n_steps):                 # host-side; fine for generation
        acc = rho * acc + eps[:, s:s + 1]
        noise[:, s:s + 1] = acc
    return (base + noise).astype(np.float32)


def weather_stats(traces: np.ndarray):
    """(mean wet-bulb, p95 wet-bulb) per region — sizing-relevant summary."""
    return traces.mean(axis=1), np.percentile(traces, 95.0, axis=1)
