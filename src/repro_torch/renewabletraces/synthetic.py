"""Synthetic per-region solar capacity-factor traces (on-site generation).

The renewables subsystem (core/renewables.py) is driven by a *capacity
factor* trace cf(t) in [0, 1]: instantaneous PV output is
`pv_capacity_kw * cf(t)`.  Real irradiance reanalysis is not
redistributable offline, so — mirroring carbontraces/ and weathertraces/ —
each region gets a deterministic synthetic trace

    cf(t) = peak_cf * clearsky(t) * (1 - atten * cloud(t))

where `clearsky(t)` is the astronomical envelope (a half-sine solar-elevation
proxy over the daylight hours, zero at night, with a seasonal daylength and
amplitude modulation standing in for latitude) and `cloud(t)` in [0, 1] is a
slow AR(1) cloud-cover process (weather fronts: hours-to-days of memory)
squashed through a logistic so overcast and clear-sky spells both persist.

Climate is *correlated* with the weather/carbon regions drawn from the same
`(n_regions, seed)`: sunny sites skew toward the hot end of the climate
distribution (deserts), so — via weathertraces' heat/greenness coupling —
fossil-heavy grids tend to have the best solar resource.  That is exactly
the coupling that makes on-site PV interesting: the dirtiest grids are the
ones where a datacenter can displace the most carbon per panel.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from repro_torch.weathertraces.synthetic import sample_climate_params

N_REGIONS = 158

_H_PER_DAY = 24.0
_H_PER_YEAR = 24.0 * 365.25


class SolarParams(NamedTuple):
    peak_cf: np.ndarray        # clear-sky noon capacity factor (site quality)
    daylength_h: np.ndarray    # annual-mean daylight hours
    seasonal_amp: np.ndarray   # relative seasonal swing of yield + daylength
    cloud_mean: np.ndarray     # mean cloud-cover fraction
    cloud_sigma: np.ndarray    # cloud-process noise scale
    cloud_rho: np.ndarray      # AR(1) memory (fronts: hours-days)
    cloud_atten: np.ndarray    # yield lost under full overcast
    phase_d: np.ndarray        # solar-noon hour (from the climate's diurnal)
    phase_s: np.ndarray        # seasonal phase, hours


def sample_solar_params(n_regions: int = N_REGIONS,
                        seed: int = 0) -> SolarParams:
    """Per-region solar parameters, correlated with the climate regions of
    the same (n_regions, seed) — see module docstring."""
    climate = sample_climate_params(n_regions, seed)
    # the climate's heat propensity (mean wet-bulb spans 2-26 C) is the
    # latitude/insolation proxy: hot sites are sunny sites, mostly
    heat = np.clip((climate.mean_c - 2.0) / 24.0, 0.0, 1.0)
    rng = np.random.default_rng(seed + 19)
    sun = np.clip(0.55 * heat + 0.45 * rng.uniform(0.0, 1.0, n_regions),
                  0.0, 1.0)
    peak_cf = 0.55 + 0.35 * sun                     # noon output, clear sky
    daylength_h = 10.0 + 3.0 * sun                  # sunny ~ low latitude
    seasonal_amp = 0.45 - 0.35 * sun                # tropics barely swing
    cloud_mean = np.clip(0.65 - 0.45 * sun
                         + rng.uniform(-0.1, 0.1, n_regions), 0.05, 0.9)
    cloud_sigma = rng.uniform(0.5, 1.2, n_regions)
    cloud_rho = rng.uniform(0.985, 0.998, n_regions)  # fronts: many hours
    cloud_atten = rng.uniform(0.75, 0.95, n_regions)
    # solar noon sits half a day from the climate's coolest hour; reuse the
    # climate's diurnal phase so PV, cooling load and carbon stay in step
    phase_d = (climate.phase_d + 12.0) % _H_PER_DAY
    phase_s = climate.phase_s
    return SolarParams(peak_cf, daylength_h, seasonal_amp, cloud_mean,
                       cloud_sigma, cloud_rho, cloud_atten, phase_d, phase_s)


def _clearsky(t_h: np.ndarray, p: SolarParams) -> np.ndarray:
    """f64[R, S] clear-sky envelope in [0, 1]: a half-sine solar-elevation
    proxy over each day's daylight window, with seasonal daylength and
    amplitude modulation."""
    season = np.sin(2 * np.pi * (t_h[None, :] - p.phase_s[:, None])
                    / _H_PER_YEAR)                                  # [R, S]
    daylen = np.clip(p.daylength_h[:, None] * (1.0 + p.seasonal_amp[:, None]
                                               * season), 4.0, 20.0)
    # hours from solar noon, wrapped into [-12, 12)
    dt_noon = ((t_h[None, :] - p.phase_d[:, None] + 12.0) % _H_PER_DAY) - 12.0
    up = np.abs(dt_noon) < 0.5 * daylen
    elev = np.cos(np.pi * dt_noon / np.maximum(daylen, 1e-6))
    amp = 1.0 + 0.5 * p.seasonal_amp[:, None] * season  # winter sun is low
    return np.where(up, np.clip(amp * elev, 0.0, 1.0), 0.0)


def make_pv_traces(n_steps: int, dt_h: float = 0.25,
                   n_regions: int = N_REGIONS, seed: int = 0) -> np.ndarray:
    """f32[n_regions, n_steps] solar capacity-factor traces in [0, 1]."""
    p = sample_solar_params(n_regions, seed)
    rng = np.random.default_rng(seed + 23)
    t = np.arange(n_steps) * dt_h                                   # [S]
    clear = _clearsky(t, p)
    # AR(1) cloud process with STATIONARY std = cloud_sigma (same correction
    # as the other trace families), squashed to a [0, 1] cover fraction
    rho = p.cloud_rho[:, None]
    eps = (rng.standard_normal((n_regions, n_steps))
           * p.cloud_sigma[:, None] * np.sqrt(1.0 - rho**2))
    drv = np.zeros_like(eps)
    acc = np.zeros((n_regions, 1))
    for s in range(n_steps):                 # host-side; fine for generation
        acc = rho * acc + eps[:, s:s + 1]
        drv[:, s:s + 1] = acc
    # logistic centered so the long-run mean cover ~= cloud_mean
    bias = np.log(p.cloud_mean[:, None] / (1.0 - p.cloud_mean[:, None]))
    cloud = 1.0 / (1.0 + np.exp(-(bias + 2.0 * drv)))
    cf = p.peak_cf[:, None] * clear * (1.0 - p.cloud_atten[:, None] * cloud)
    return np.clip(cf, 0.0, 1.0).astype(np.float32)


def pv_stats(traces: np.ndarray):
    """(mean capacity factor, daylight-hours fraction) per region — the
    sizing-relevant summary (annual CF is what a PPA quotes)."""
    return traces.mean(axis=1), (traces > 0.01).mean(axis=1)
