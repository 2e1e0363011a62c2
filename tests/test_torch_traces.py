"""The PyTorch port's trace generators against the reference package's.

`repro_torch.{carbon,task,weather,price,renewable}traces` are copies of the
reference's numpy generators with the port's own imports (the port imports
nothing of the reference).  For every seed, size and step tested, each
array, parameter set and statistic must be bit-equal to the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.carbontraces as jcarbon
import repro.pricetraces as jprice
import repro.renewabletraces as jpv
import repro.tasktraces as jtask
import repro.weathertraces as jweather
import repro_torch.carbontraces as pcarbon
import repro_torch.pricetraces as pprice
import repro_torch.renewabletraces as ppv
import repro_torch.tasktraces as ptask
import repro_torch.weathertraces as pweather

torch.set_num_threads(1)

SEEDS = (0, 1, 7)
# (n_steps, dt_h, n_regions): a day at 15 min, a ragged three days at 10
# min, a week hourly, one step
SIZES = ((96, 0.25, 8), (433, 1.0 / 6.0, 3), (168, 1.0, 5), (1, 0.25, 2))
PACKAGES = {"carbon": (jcarbon, pcarbon), "task": (jtask, ptask),
            "weather": (jweather, pweather), "price": (jprice, pprice),
            "renewable": (jpv, ppv)}


def bit_equal(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8)), what


def test_same_exports():
    for name, (j, p) in PACKAGES.items():
        assert sorted(j.__all__) == sorted(p.__all__), name
        assert j.N_REGIONS == p.N_REGIONS, name


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("kind,make", [
    ("carbon", "make_region_traces"), ("task", "make_arrival_rate_traces"),
    ("weather", "make_weather_traces"), ("price", "make_price_traces"),
    ("renewable", "make_pv_traces")])
def test_generators_bit_equal(kind, make, size, seed):
    j, p = PACKAGES[kind]
    s, dt, r = size
    bit_equal(getattr(p, make)(s, dt, r, seed),
              getattr(j, make)(s, dt, r, seed), f"{make}{size} seed {seed}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("kind,sample", [
    ("carbon", "sample_region_params"), ("task", "sample_traffic_params"),
    ("weather", "sample_climate_params"), ("price", "sample_price_params"),
    ("renewable", "sample_solar_params")])
def test_region_parameters_bit_equal(kind, sample, seed):
    j, p = PACKAGES[kind]
    for n in (1, 8, 13):
        got, want = getattr(p, sample)(n, seed), getattr(j, sample)(n, seed)
        assert got._fields == want._fields
        for f, g, w in zip(want._fields, got, want):
            bit_equal(g, w, f"{sample}({n}, {seed}).{f}")


@pytest.mark.parametrize("seed", SEEDS)
def test_price_traces_with_carbon_tax_bit_equal(seed):
    bit_equal(pprice.make_price_traces(192, 0.25, 4, seed, 0.08),
              jprice.make_price_traces(192, 0.25, 4, seed, 0.08),
              f"taxed prices seed {seed}")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("n_tasks,n_steps,dt,r", [
    (12, 96, 0.25, 3), (500, 672, 0.25, 8), (77, 200, 1.0 / 6.0, 2)])
def test_arrival_sets_bit_equal(n_tasks, n_steps, dt, r, seed):
    got = ptask.make_arrival_sets(n_tasks, n_steps, dt, r, seed)
    bit_equal(got, jtask.make_arrival_sets(n_tasks, n_steps, dt, r, seed),
              "arrival sets")
    assert (np.diff(got, axis=1) >= 0).all()
    rates = jtask.make_arrival_rate_traces(n_steps, dt, r, seed + 3)
    bit_equal(ptask.make_arrival_sets(n_tasks, n_steps, dt, r, seed,
                                      rates=rates),
              jtask.make_arrival_sets(n_tasks, n_steps, dt, r, seed,
                                      rates=rates), "arrival sets of rates")


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("dt", [0.25, 1.0])
def test_trace_stats_bit_equal(dt, seed):
    n = int(round(72 / dt)) + 5  # three days and a ragged tail
    ci = jcarbon.make_region_traces(n, dt, 6, seed)
    for g, w in zip(pcarbon.trace_stats(ci, dt), jcarbon.trace_stats(ci, dt)):
        bit_equal(g, w, "trace_stats")
    for g, w in zip(ptask.traffic_stats(
            jtask.make_arrival_rate_traces(n, dt, 6, seed), dt),
            jtask.traffic_stats(
                jtask.make_arrival_rate_traces(n, dt, 6, seed), dt)):
        bit_equal(g, w, "traffic_stats")
    wb = jweather.make_weather_traces(n, dt, 6, seed)
    for g, w in zip(pweather.weather_stats(wb), jweather.weather_stats(wb)):
        bit_equal(g, w, "weather_stats")
    pr = jprice.make_price_traces(n, dt, 6, seed)
    for g, w in zip(pprice.price_stats(pr, dt), jprice.price_stats(pr, dt)):
        bit_equal(g, w, "price_stats")
    pv = jpv.make_pv_traces(n, dt, 6, seed)
    for g, w in zip(ppv.pv_stats(pv), jpv.pv_stats(pv)):
        bit_equal(g, w, "pv_stats")
