"""The paper's scaling study (Fig 5) on the CPU, port against the reference
package; the committed records the card is held to.

`scripts/paper_studies_card.py`'s study functions (the same the card runs
at full scale) at `benchmarks/common.py`'s SMOKE size (2 days, scale 0.02,
at most 256 tasks) at the Fig 11 study's slots a step, megakernel, against
the benches' compositions rebuilt from the reference's `repro.core`:

  * Fig 5 (`benchmarks/bench_scaling.py:29-60`): each share of hosts' SLA
    fraction and the scale `find_min_scale` finds exact, every SLA fraction
    the search evaluated exact, carbon rtol 1e-4, the reduction at the
    scale found within 1e-3 points.

The trade-off study is in `tests/test_torch_paper_tradeoffs.py`, the
battery-region and analytical-gap studies in
`tests/test_torch_paper_regions.py`.
"""
from __future__ import annotations

import functools
import json
import os
import sys

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.carbontraces import make_region_traces
from repro.workloads import make_workload as j_workload
from repro_torch.workloads import make_workload as p_workload

ROOT = os.path.join(os.path.dirname(__file__), "..")
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import paper_studies_card as PS  # noqa: E402

torch.set_num_threads(1)

DT = 0.25
# benchmarks/common.py:44-46 (SMOKE): 2 days, scale at most 0.02, 256 tasks
SIZE = {"scale": 0.02, "days": 2.0, "cap": 256, "battery_regions": 158,
        "gap_regions": 4}
SLOTS = {"surf": 256, "marconi": 64, "borg": 4096}
KWH_PER_HOST = {"surf": 1.1, "marconi": 9.0, "borg": 2.2}
RECORDS = os.path.join(os.path.dirname(__file__), "data",
                       "torch_paper_studies_reference.json")
PCT_ATOL = 1e-3


def _quiet(_line) -> None:
    """The study functions' `emit`: the tests read the returned rows."""


def reference_setup(name: str):
    """(tasks, hosts, meta, base config) of the reference at SIZE: the
    bench's `setup` (`benchmarks/common.py:40-58`) at the study's slots,
    through the megakernel."""
    jt, jh, _, meta = j_workload(name, scale=SIZE["scale"], seed=0, dt_h=DT,
                                 horizon_days=SIZE["days"],
                                 n_tasks_cap=SIZE["cap"])
    cfg = jconfig.SimConfig(
        dt_h=DT, n_steps=int(SIZE["days"] * 24 / DT),
        embodied=jconfig.EmbodiedConfig(host_kg=meta["embodied"].host_kg),
        backend="megakernel",
        scheduler=jconfig.SchedulerConfig(slots_per_step=SLOTS[name]))
    return jt, jh, meta, cfg


def reference_battery(meta, **kw):
    """`benchmarks/common.py:72-78` battery_cfg."""
    return jconfig.BatteryConfig(
        enabled=True, capacity_kwh=KWH_PER_HOST[meta["name"]]
        * meta["n_hosts"], **kw)


@functools.lru_cache(maxsize=None)
def port_workload(name: str):
    return PS.load_workload(name, SIZE, "cpu")


def assert_pct(got, want, what: str) -> None:
    np.testing.assert_allclose(got, want, rtol=0.0, atol=PCT_ATOL,
                               err_msg=what)


# ---------------------------------------------------------------------------
# Fig 5: horizontal scaling
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_scaling(name: str) -> dict:
    """`bench_scaling.run`'s rows of one workload (lines 29-60), with the
    search's evaluated scales; runs memoised (they are deterministic)."""
    jt, jh, meta, cfg = reference_setup(name)
    n_hosts = meta["n_hosts"]
    trace = make_region_traces(cfg.n_steps, DT, 1, seed=1)[0]
    rows = {}
    for failures in (False, True):
        c = cfg.replace(failures=jconfig.FailureConfig(
            enabled=failures, mtbf_h=400.0, repair_h=4.0,
            checkpointing=True))

        @functools.lru_cache(maxsize=None)
        def sla_and_carbon(n, c=c):
            final, _ = J.simulate(jt, J.with_scale(jh, n), trace, c)
            res = J.summarize(final, c)
            return (float(res.sla_violation_frac), float(res.total_carbon_kg),
                    float(res.op_carbon_kg), max(float(res.done_frac), 1e-3))
        sweep = {f: sla_and_carbon(max(int(n_hosts * f), 1))
                 for f in PS.FRACS}
        best, evaluated = J.find_min_scale(lambda n: sla_and_carbon(n)[0],
                                           lo=1, hi=n_hosts, target=0.01)
        reachable = best <= n_hosts
        red = (100.0 * (1 - sla_and_carbon(best)[1] / sweep[1.0][1])
               if reachable else 0.0)
        rows[failures] = {
            "min_scale_hosts": int(best) if reachable else None,
            "value": red,
            "sla_curve": {str(f): 100 * s[0] for f, s in sweep.items()},
            "op_carbon_curve": {str(f): s[2] for f, s in sweep.items()},
            "op_per_done_curve": {str(f): s[2] / s[3]
                                  for f, s in sweep.items()},
            "search_evaluated": {str(n): v for n, v in evaluated.items()}}
    return rows


@functools.lru_cache(maxsize=None)
def port_scaling(name: str) -> dict:
    rows = PS.scaling_study(port_workload(name), "cpu", _quiet)
    return {r["failures"]: r for r in rows}


@pytest.mark.parametrize("failures", (False, True))
@pytest.mark.parametrize("name", ("surf", "marconi", "borg"))
def test_scaling_rows_match_reference(name, failures):
    got, want = port_scaling(name)[failures], reference_scaling(name)[failures]
    assert got["bench"] == "scaling" and got["workload"] == name
    assert got["full_hosts"] == port_workload(name).meta["n_hosts"]
    assert got["min_scale_hosts"] == want["min_scale_hosts"]
    assert got["sla_curve"] == want["sla_curve"]
    assert got["search_evaluated"] == want["search_evaluated"]
    for k in ("op_carbon_curve", "op_per_done_curve"):
        assert got[k].keys() == want[k].keys()
        np.testing.assert_allclose(list(got[k].values()),
                                   list(want[k].values()), rtol=1e-4,
                                   atol=0.0, err_msg=k)
    assert_pct(got["value"], want["value"], "reduction at the min scale")


def test_scaling_search_is_nontrivial_somewhere():
    """At this size Marconi's search moves: its quarter of the hosts misses
    the SLA, and failures raise the scale it needs (the F1 claim)."""
    rows = port_scaling("marconi")
    assert rows[False]["sla_curve"]["0.25"] > 1.0
    assert len(rows[False]["search_evaluated"]) > 2
    assert rows[True]["min_scale_hosts"] > rows[False]["min_scale_hosts"]
    assert rows[False]["min_scale_sla"] <= 0.01


@pytest.mark.parametrize("mtbf_h", (400.0, 1000.0))
def test_failure_probability_is_the_reference_constant(mtbf_h):
    """Without resilience the reference's failure probability is a constant
    of its compiled program (`src/repro/core/failures.py:34`), which XLA
    folds with libm's `expf`; the port evaluates XLA's polynomial.  At Fig
    5's MTBF (400 h) and the default (1000 h) both give the same f32 bits,
    so no draw of the studies' failure runs can flip."""
    want = jax.jit(lambda: 1.0 - jax.numpy.exp(-DT / mtbf_h))()
    got = PS.S.failures.failure_probability(None, DT, mtbf_h)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == np.asarray(want, np.float32).tobytes()


# ---------------------------------------------------------------------------
# the committed records (scripts/reference_experiments.py --studies)
# ---------------------------------------------------------------------------

def _records() -> dict:
    with open(RECORDS) as f:
        return json.load(f)


RECORD_RUNS = ("scaling_failures_half", "tradeoffs_bts_tariff1",
               "front_blended_lambda0.5_tariff0")


@pytest.mark.parametrize("size", ("full", "smoke"))
@pytest.mark.parametrize("name", ("surf", "borg"))
def test_records_describe_the_sizes_the_card_reads(name, size):
    """The records' sizes are those the script (full) and the smoke's phase
    4h (2 days at full width) make, at the study's constants."""
    rec = _records()
    assert rec["scale"] == 1.0 and rec["seed"] == 0 and rec["dt_h"] == DT
    assert rec["failures"] == PS.S.STUDY_FAILURES
    assert rec["demand_charge_per_kw"] == PS.S.STUDY_DEMAND_CHARGE_PER_KW
    assert rec["front_lambda"] == PS.S.STUDY_LAMBDAS[1]
    assert rec["front_price_window_h"] == PS.S.STUDY_PRICE_WINDOW_H
    assert rec["oracle_regions"] == PS.S.STUDY_ORACLE_REGIONS
    assert rec["gap_regions"] == PS.FULL["gap_regions"]
    w = rec["workloads"][name][size]
    assert rec["smoke_days"] == PS.S.STUDY_DAYS
    days = None if size == "full" else rec["smoke_days"]
    _, hosts, spec, meta = p_workload(name, scale=1.0, seed=0, dt_h=DT,
                                      horizon_days=days, device="cpu")
    days = days or spec.horizon_days
    assert w["days"] == days
    assert w["n_tasks"] == meta["n_tasks"]
    assert w["n_hosts"] == meta["n_hosts"] == hosts.cores.shape[0]
    assert w["n_steps"] == int(round(days * 24 / DT))
    assert w["slots_per_step"] == SLOTS[name]
    assert w["battery_kwh"] == KWH_PER_HOST[name] * meta["n_hosts"]
    assert PS.S.STUDY_KWH_PER_HOST[name] == KWH_PER_HOST[name]


@pytest.mark.parametrize("name", ("surf", "borg"))
def test_records_hold_the_named_runs(name):
    for size, w in _records()["workloads"][name].items():
        assert set(w["runs"]) == set(RECORD_RUNS), size
        half = w["runs"]["scaling_failures_half"]
        assert half["n_active_hosts"] == max(int(w["n_hosts"] * 0.5), 1)
        assert w["runs"]["tradeoffs_bts_tariff1"]["tariff"] == 1
        front = w["runs"]["front_blended_lambda0.5_tariff0"]
        assert (front["dispatch_lambda"], front["tariff"]) == (0.5, 0)
        for key, run in w["runs"].items():
            assert run["n_tasks"] == w["n_tasks"], (size, key)
            assert 0 < run["n_done"] <= run["n_tasks"], (size, key)
            for k in ("total_carbon_kg", "op_carbon_kg", "total_cost",
                      "demand_cost", "sla_violation_frac", "mean_delay_h"):
                assert np.isfinite(run[k]), (size, key, k)
        assert len(w["oracle_mean_pct"]) == 4
        assert all(0 < m < 100 for m in w["oracle_mean_pct"])
