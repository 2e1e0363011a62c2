"""The paper's trade-off study (Figs 9 / 14 / 15, §XI) on the CPU, port
against the reference package.

`scripts/paper_studies_card.py`'s `tradeoffs_study` at
`benchmarks/common.py`'s SMOKE size (see `tests/test_torch_paper_studies.py`)
against `benchmarks/bench_tradeoffs.py:468-512` rebuilt from the reference's
`repro.core`: with pricing on, none / B / TS / B+TS each one `sweep_grid`
over `price_axis` of two tariffs, and the cost-carbon front (B with the
`blended` policy over `dispatch_lambda` x the tariffs): every row's peak
power, delay, energy and bill within rtol 1e-4, its finished tasks exact,
and the front's lambda = 1 rows bit for bit the carbon policy's B rows.
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
from repro.pricetraces.synthetic import make_price_traces

from test_torch_paper_studies import (DT, PS, _quiet, port_workload,
                                      reference_battery, reference_setup)

torch.set_num_threads(1)

COMBOS = ("none", "B", "TS", "B+TS")
FRONT = tuple(f"B(lambda={lv})" for lv in (0.0, 0.5, 1.0))


@functools.lru_cache(maxsize=None)
def reference_tradeoffs(name: str) -> tuple:
    """`bench_tradeoffs.run`'s rows of one workload (lines 468-512) by
    combo, with the finished tasks of each row's cell."""
    jt, jh, meta, cfg = reference_setup(name)
    cfg = cfg.replace(pricing=jconfig.PricingConfig(
        enabled=True, demand_charge_per_kw=12.0))
    trace = make_region_traces(cfg.n_steps, DT, 2, seed=7)[1]
    prices = make_price_traces(cfg.n_steps, DT, 2, seed=7)
    combos = {"none": cfg, "B": cfg.replace(battery=reference_battery(meta)),
              "TS": cfg.replace(shifting=jconfig.ShiftingConfig(enabled=True)),
              "B+TS": cfg.replace(battery=reference_battery(meta),
                                  shifting=jconfig.ShiftingConfig(
                                      enabled=True))}
    rows = {}
    for name_, c in combos.items():
        res = J.sweep_grid(jt, jh, c, [J.price_axis(prices)], ci_trace=trace)
        cell = lambda f, p=0: float(np.asarray(getattr(res, f))[p])  # noqa
        rows[name_] = {
            "value": cell("peak_power_kw"), "mean_delay_h": cell("mean_delay_h"),
            "energy_mwh": float(np.asarray(res.dc_energy_kwh)[0] / 1000.0),
            "grid_energy_mwh": float(np.asarray(res.grid_energy_kwh)[0]
                                     / 1000.0),
            "energy_cost": cell("energy_cost"),
            "demand_cost": cell("demand_cost"),
            "total_cost": cell("total_cost"),
            "total_cost_alt_tariff": cell("total_cost", 1),
            "n_done": cell("n_done")}
    c = combos["B"].replace(battery=reference_battery(
        meta, policy="blended", price_window_h=48.0))
    front = J.sweep_grid(jt, jh, c, [
        J.dyn_axis(dispatch_lambda=np.asarray((0.0, 0.5, 1.0), np.float32)),
        J.price_axis(prices)], ci_trace=trace)
    for i, key in enumerate(FRONT):
        rows[key] = {
            "value": float(np.asarray(front.total_cost)[i, 0]),
            "total_carbon_kg": float(np.asarray(front.total_carbon_kg)[i, 0]),
            "peak_power_kw": float(np.asarray(front.peak_power_kw)[i, 0]),
            "n_done": float(np.asarray(front.n_done)[i, 0])}
    return rows


@functools.lru_cache(maxsize=None)
def port_tradeoffs(name: str) -> dict:
    return {r["combo"]: r for r in PS.tradeoffs_study(
        port_workload(name), "cpu", _quiet)}


def assert_row(got: dict, want: dict, what: str) -> None:
    """The finished tasks exact, every other field within rtol 1e-4."""
    assert got["n_done"] == want["n_done"], what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=0.0,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("combo", COMBOS + FRONT)
@pytest.mark.parametrize("name", ("surf", "borg"))
def test_tradeoff_rows_match_reference(name, combo):
    got = port_tradeoffs(name)[combo]
    want = reference_tradeoffs(name)[combo]
    assert got["bench"] == "tradeoffs" and got["workload"] == name
    assert got["metric"] == ("total_cost" if combo in FRONT
                             else "peak_power_kw")
    assert_row(got, want, combo)


def test_tradeoff_marconi_rows_match_reference():
    got = port_tradeoffs("marconi")
    want = reference_tradeoffs("marconi")
    assert set(got) == set(want)
    for combo, row in want.items():
        assert_row(got[combo], row, combo)


def test_front_lambda_one_is_the_carbon_policy():
    """The front's lambda = 1 rows are the carbon policy's B rows on the
    same tariff, every field bit for bit (the reference's guarantee): the
    port's grids directly, beside the study's own gate."""
    wl = port_workload("surf")
    cfgs = PS.S.study_configs(wl.base, wl.kwh)
    trace, prices = PS.S.study_tariff_traces(wl.steps, "cpu")
    carbon = PS.result_to_numpy(PS.sweep_grid(
        wl.tasks, wl.hosts, cfgs["B"], [PS.price_axis(prices)], trace,
        device="cpu"))
    front = PS.result_to_numpy(PS.sweep_grid(
        wl.tasks, wl.hosts, cfgs["front"],
        [PS.dyn_axis(dispatch_lambda=np.float32([0.0, 1.0])),
         PS.price_axis(prices)], trace, device="cpu"))
    for k, v in carbon.items():
        np.testing.assert_array_equal(front[k][1], v, err_msg=k)
    # and the price end differs: the front is not one point
    assert not np.array_equal(front["total_cost"][0], carbon["total_cost"])
