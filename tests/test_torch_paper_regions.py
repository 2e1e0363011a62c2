"""The paper's battery-region (Fig 6) and analytical-gap (§III) studies on
the CPU, port against the reference package.

`scripts/paper_studies_card.py`'s study functions at `benchmarks/common.py`'s
SMOKE size (see `tests/test_torch_paper_studies.py`) against the benches'
compositions rebuilt from the reference's `repro.core`:

  * Fig 6 (`benchmarks/bench_battery_regions.py:408-426`): the base and the
    battery grid over the 158 regions of `make_region_traces(S, 0.25, 158,
    seed=0)`; the mean, best and worst reduction within 1e-3 points, the
    shares of regions at or above 5 % and below 0 exact, the grids' counts
    exact;
  * §III (`bench_analytical_gap.py:62-88`, each region a single run as the
    bench runs it): the oracle's and the simulated mean savings within
    1e-3 points.
"""
from __future__ import annotations

import functools

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.carbontraces import make_region_traces
from repro.core.analytical import analytical_shifting_savings

from test_torch_paper_studies import (DT, PS, SIZE, _quiet, assert_pct,
                                      port_workload, reference_battery,
                                      reference_setup)

torch.set_num_threads(1)


# ---------------------------------------------------------------------------
# Fig 6: batteries across regions
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_battery_regions(name: str) -> dict:
    """`bench_battery_regions.run`'s row of one workload (lines 408-426)."""
    jt, jh, meta, cfg = reference_setup(name)
    n = SIZE["battery_regions"]
    axes = [J.trace_axis(make_region_traces(cfg.n_steps, DT, n, seed=0))]
    base = J.sweep_grid(jt, jh, cfg, axes)
    treated = J.sweep_grid(jt, jh, cfg.replace(
        battery=reference_battery(meta)), axes)
    red = np.asarray(J.carbon_reduction_pct(base, treated))
    return {"regions": n, "value": float(red.mean()),
            "frac_ge_5pct": float((red >= 5).mean()),
            "frac_negative": float((red < 0).mean()),
            "best_pct": float(red.max()), "worst_pct": float(red.min())}


@pytest.mark.parametrize("name", ("surf", "marconi", "borg"))
def test_battery_regions_row_matches_reference(name):
    got = PS.battery_regions_study(port_workload(name),
                                   SIZE["battery_regions"], "cpu", _quiet)
    want = reference_battery_regions(name)
    assert got["bench"] == "battery_regions" and got["workload"] == name
    assert got["metric"] == "mean_reduction_pct"
    assert got["regions"] == want["regions"] == 158
    for k in ("frac_ge_5pct", "frac_negative"):
        assert got[k] == want[k], k
    for k in ("value", "best_pct", "worst_pct"):
        assert_pct(got[k], want[k], k)


# ---------------------------------------------------------------------------
# §III: the analytical gap
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_gap(name: str) -> dict:
    """`bench_analytical_gap.run`'s row of one workload (lines 62-88): the
    oracle and a base and a TS single run on each region."""
    jt, jh, _, cfg = reference_setup(name)
    traces = make_region_traces(cfg.n_steps, DT, SIZE["gap_regions"],
                                seed=11)
    arr, dur = np.asarray(jt.arrival), np.asarray(jt.duration)
    valid = np.isfinite(arr)
    scfg = cfg.replace(shifting=jconfig.ShiftingConfig(enabled=True))
    oracle, sim = [], []
    for tr in np.asarray(traces):
        oracle.append(float(analytical_shifting_savings(
            arr[valid], dur[valid], tr, cfg.dt_h, oracle=True)[0]))
        base = J.summarize(J.simulate(jt, jh, tr, cfg)[0], cfg)
        ts = J.summarize(J.simulate(jt, jh, tr, scfg)[0], scfg)
        sim.append(100.0 * (1 - float(ts.op_carbon_kg)
                            / float(base.op_carbon_kg)))
    return {"value": float(np.mean(oracle)),
            "sim_mean_savings_pct": float(np.mean(sim)),
            "gap_x": float(np.mean(oracle) / max(np.mean(sim), 0.1))}


@pytest.mark.parametrize("name", ("surf", "borg"))
def test_analytical_gap_row_matches_reference(name):
    got = PS.analytical_gap_study(port_workload(name), SIZE["gap_regions"],
                                  "cpu", _quiet)
    want = reference_gap(name)
    assert got["bench"] == "analytical_gap" and got["workload"] == name
    assert got["metric"] == "oracle_mean_savings_pct"
    assert_pct(got["value"], want["value"], "oracle mean")
    assert_pct(got["sim_mean_savings_pct"], want["sim_mean_savings_pct"],
               "simulated mean")
    np.testing.assert_allclose(got["gap_x"], want["gap_x"], rtol=1e-4)
    # the §III claim at this size: the oracle claims more than simulation
    assert got["value"] > got["sim_mean_savings_pct"]
