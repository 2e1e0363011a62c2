"""The paper's other two workloads and its Fig 11 study, port against the
reference package on the CPU.

SURF and Borg (`make_workload`, the same seed) at a small scale with the
study's slots a step (256 / 4096: at full scale the smallest power of two
at or above the most arrivals in any step) in the base configuration, B+TS
and HS+B+TS, each through both step executors against the reference's same
executor: outcome counts exact, totals within rtol 1e-4.  The committed
records of the reference at full scale
(`tests/data/torch_paper_workloads_reference.json`, from
`scripts/reference_experiments.py --workloads`) describe the port's
full-scale workloads and hold what `chip_smoke.py`'s phase 4g and
`scripts/paper_workloads_card.py` read; neither script imports JAX or the
reference package.  The study's 8 grids are in
tests/test_torch_paper_study.py, SURF's whole 124-day horizon in
tests/test_torch_paper_horizon.py.
"""
from __future__ import annotations

import ast
import functools
import inspect
import json
import os

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.carbontraces import make_region_traces
from repro.workloads import make_workload as j_workload
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro_torch.workloads import make_workload as p_workload

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
RECORDS = os.path.join(os.path.dirname(__file__), "data",
                       "torch_paper_workloads_reference.json")
DT = 0.25
SLOTS = {"surf": 256, "marconi": 64, "borg": 4096}
KWH_PER_HOST = {"surf": 1.1, "marconi": 9.0, "borg": 2.2}
# (scale, days) of the small cases; the HS cases keep this share of hosts
SMALL = {"surf": (0.1, 2.0), "borg": (0.05, 1.0)}
HS_SHARE = 0.8
COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "class_n_violations", "class_n_decided", "class_n_started")
TOTALS = ("total_carbon_kg", "op_carbon_kg", "emb_carbon_kg",
          "grid_energy_kwh", "dc_energy_kwh", "it_energy_kwh",
          "peak_power_kw", "batt_discharged_kwh", "sla_violation_frac",
          "mean_delay_h", "mean_start_delay_h", "done_frac")
COMBOS = ("", "H", "B", "T", "HB", "HT", "BT", "HBT")


def _np(table) -> dict:
    return {k: np.asarray(v) for k, v in table._asdict().items()}


@functools.lru_cache(maxsize=None)
def _workload(name: str, scale: float, days: float, cap=None):
    """(reference tables, port tables, the reference's meta, steps)."""
    jt, jh, _, meta = j_workload(name, scale=scale, seed=0, dt_h=DT,
                                 horizon_days=days, n_tasks_cap=cap)
    pt, ph = P.tables_from_numpy(_np(jt), _np(jh), device="cpu")
    steps = int(round(days * 24 / DT))
    return jt, jh, pt, ph, meta, steps


def _config(C, name: str, steps: int, meta: dict, combo: str, backend: str):
    cfg = C.SimConfig(dt_h=DT, n_steps=steps,
                      embodied=C.EmbodiedConfig(
                          host_kg=meta["embodied"].host_kg),
                      backend=backend,
                      scheduler=C.SchedulerConfig(slots_per_step=SLOTS[name]))
    if "B" in combo:
        cfg = cfg.replace(battery=C.BatteryConfig(
            enabled=True, capacity_kwh=KWH_PER_HOST[name] * meta["n_hosts"]))
    if "T" in combo:
        cfg = cfg.replace(shifting=C.ShiftingConfig(enabled=True))
    return cfg


def _dyn(combo: str, meta: dict):
    return ({"n_active_hosts": int(HS_SHARE * meta["n_hosts"])}
            if "H" in combo else None)


@functools.lru_cache(maxsize=None)
def _reference_run(name: str, combo: str, backend: str, scale: float,
                   days: float, cap=None) -> dict:
    jt, jh, _, _, meta, steps = _workload(name, scale, days, cap)
    ci = make_region_traces(steps, DT, 24, seed=0)[0]
    cfg = _config(jconfig, name, steps, meta, combo, backend)
    final, _ = J.simulate(jt, jh, ci, cfg, dyn=_dyn(combo, meta))
    return {k: np.asarray(v) for k, v in
            J.summarize(final, cfg)._asdict().items() if v is not None}


def port_run(name: str, combo: str, backend: str, scale: float,
             days: float, cap=None) -> dict:
    _, _, pt, ph, meta, steps = _workload(name, scale, days, cap)
    ci = torch.as_tensor(make_region_traces(steps, DT, 24, seed=0)[0])
    cfg = _config(pconfig, name, steps, meta, combo, backend)
    final, _ = P.simulate(pt, ph, ci, cfg, dyn=_dyn(combo, meta),
                          device="cpu")
    return P.result_to_numpy(P.summarize(final, cfg))


def assert_same(got: dict, want: dict, rtol: float) -> None:
    for k in COUNT_FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"count {k}")
    for k in TOTALS:
        np.testing.assert_allclose(np.float64(got[k]), np.float64(want[k]),
                                   rtol=rtol, atol=0.0, err_msg=f"field {k}")


# ---------------------------------------------------------------------------
# (a) SURF and Borg at a small scale, each executor against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ("stage-pipeline", "megakernel"))
@pytest.mark.parametrize("combo", ("", "BT", "HBT"))
@pytest.mark.parametrize("name", ("surf", "borg"))
def test_workload_matches_reference(name, combo, backend):
    scale, days = SMALL[name]
    got = port_run(name, combo, backend, scale, days)
    want = _reference_run(name, combo, backend, scale, days)
    assert_same(got, want, 1e-4)
    assert got["n_done"] > 0


def test_borg_fills_more_slots_than_the_default():
    """Borg's arrivals outrun the default 64 slots a step even at a small
    scale: the study's 4096 leave no backlog in the base configuration,
    and 64 do (the reason for the study's slot counts)."""
    scale, days = SMALL["borg"]
    _, _, pt, ph, meta, steps = _workload("borg", scale, days)
    ci = torch.as_tensor(make_region_traces(steps, DT, 24, seed=0)[0])
    starts = {}
    for slots in (64, SLOTS["borg"]):
        cfg = _config(pconfig, "borg", steps, meta, "", "megakernel")
        cfg = cfg.replace(scheduler=pconfig.SchedulerConfig(
            slots_per_step=slots))
        final, _ = P.simulate(pt, ph, ci, cfg, device="cpu")
        starts[slots] = float(P.summarize(final, cfg).mean_start_delay_h)
    assert starts[SLOTS["borg"]] < starts[64]


# ---------------------------------------------------------------------------
# (d) the committed records
# ---------------------------------------------------------------------------

def _records() -> dict:
    with open(RECORDS) as f:
        return json.load(f)


@pytest.mark.parametrize("name", ("surf", "borg"))
def test_records_describe_the_full_scale_workload(name):
    rec = _records()
    assert rec["scale"] == 1.0 and rec["seed"] == 0 and rec["dt_h"] == DT
    assert rec["regions"] == 24 and rec["search_steps"] == 672
    w = rec["workloads"][name]
    _, hosts, spec, meta = p_workload(name, scale=1.0, seed=0, dt_h=DT,
                                      device="cpu")
    assert w["n_tasks"] == meta["n_tasks"]
    assert w["n_hosts"] == meta["n_hosts"] == hosts.cores.shape[0]
    assert w["n_steps"] == int(round(spec.horizon_days * 24 / DT))
    assert w["slots_per_step"] == SLOTS[name]
    assert w["battery_kwh"] == KWH_PER_HOST[name] * meta["n_hosts"]


@pytest.mark.parametrize("name", ("surf", "borg"))
def test_records_hold_what_the_card_reads(name):
    w = _records()["workloads"][name]
    search = w["search"]
    assert search["n_hs"] == min(search["best"], w["n_hosts"])
    assert 1 <= search["n_hs"] <= w["n_hosts"]
    # the search's pairs: the SLA fraction is at most the target exactly
    # at and above the host count it found
    for n, sla in search["evaluated"].items():
        assert (sla <= 0.01) == (int(n) >= search["best"]), (n, sla)
    runs = w["runs"]
    assert set(runs) == {"base_megakernel", "base_stage-pipeline",
                         "hs_b_ts_megakernel"}
    assert runs["hs_b_ts_megakernel"]["dyn"] == {
        "n_active_hosts": search["n_hs"]}
    assert runs["hs_b_ts_megakernel"]["techniques"] == "HS+B+TS"
    for key, run in runs.items():
        for k in (*COUNT_FIELDS, *TOTALS):
            assert k in run, (key, k)
        assert run["n_tasks"] == w["n_tasks"]
        assert 0 < run["n_done"] <= run["n_tasks"]
        assert run["cpu_seconds"] > 0


# ---------------------------------------------------------------------------
# the scripts that run this on the card
# ---------------------------------------------------------------------------

def _imports(path: str) -> set:
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", ("chip_smoke.py",
                                  "scripts/paper_workloads_card.py",
                                  "scripts/paper_studies_card.py"))
def test_card_scripts_import_neither_jax_nor_reference(path):
    names = _imports(os.path.join(ROOT, path))
    assert "repro_torch" in names
    assert not names & {"jax", "jaxlib", "repro"}, names


def test_study_entry_points_default_to_the_card():
    for fn in (P.simulate, P.sweep_grid, p_workload):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
