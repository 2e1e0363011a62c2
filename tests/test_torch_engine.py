"""The PyTorch port's simulation against the reference package, on the CPU.

Both step executors of `repro_torch` run the same tables and traces as
`repro.core.simulate` (stage pipeline).  Outcome counts must be exact;
every other SimResult field agrees within rtol 1e-5, atol 1e-6 -- the
reference's own cross-backend contract (sums reassociate).  The golden
snapshots of tests/golden/ reproduce at rtol 1e-4, the energy-flow ledger
conserves power at every step, the port refuses what it has not ported,
and importing it loads neither JAX nor the reference package.  The same
simulation on the card is in tests/test_torch_card.py.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
import repro_torch.core as P
import repro_torch.core.config as pconfig

torch.set_num_threads(1)

S = 96
DT = 0.25
GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# the workload of tests/test_megakernel.py
_rng0 = np.random.default_rng(21)
_N = 12
J_TASKS = J.make_task_table(np.sort(_rng0.uniform(0.0, 8.0, _N)),
                            _rng0.uniform(0.5, 4.0, _N),
                            _rng0.integers(1, 3, _N).astype(float))
J_HOSTS = J.make_host_table(3, 4)

COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "class_n_violations", "class_n_decided", "class_n_started")
COMBOS = [(cool, price, renew)
          for cool in (False, True)
          for price in (False, True)
          for renew in (False, True)]


def _np(table) -> dict:
    return {k: np.asarray(v) for k, v in table._asdict().items()}


def port_tables(tasks, hosts):
    return P.tables_from_numpy(_np(tasks), _np(hosts), device="cpu")


def _traces(seed: int):
    rng = np.random.default_rng(seed)
    t = np.arange(S) * DT
    ci = (rng.uniform(50, 600)
          * (1 + rng.uniform(0, 0.8) * np.sin(2 * np.pi * t / 24
                                              + rng.uniform(0, 6)))
          + rng.normal(0, 10, S)).clip(5.0).astype(np.float32)
    price = (rng.uniform(0.05, 0.2)
             * (1 + rng.uniform(0, 0.9) * np.sin(2 * np.pi * t / 24
                                                 + rng.uniform(0, 6)))
             + rng.exponential(0.01, S)).clip(0.005).astype(np.float32)
    wb = (rng.uniform(5, 25)
          + 6.0 * np.sin(2 * np.pi * t / 24)).astype(np.float32)
    day = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0, 1.0)
    cf = (day * rng.uniform(0.3, 0.9)).astype(np.float32)
    return ci, price, wb, cf


CI, PRICE, WB, CF = _traces(7)


def make_cfg(C, cool, price, renew, policy="carbon", batt=True, export=True,
             shifting=None, scheduler=None, **kw):
    """The same SimConfig in either package (`C` is its config module)."""
    extra = {}
    if shifting is not None:
        extra["shifting"] = C.ShiftingConfig(**shifting)
    if scheduler is not None:
        extra["scheduler"] = C.SchedulerConfig(**scheduler)
    return C.SimConfig(
        n_steps=S,
        cooling=C.CoolingConfig(enabled=cool, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=price, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=renew, export_allowed=export,
                                     pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=batt, capacity_kwh=6.0,
                                policy=policy, price_window_h=24.0),
        **extra, **kw)


def trace_dyn(cfg) -> dict:
    """The exogenous traces each enabled subsystem consumes."""
    d = {}
    if cfg.pricing.enabled:
        d["price_trace"] = PRICE
    if cfg.cooling.enabled:
        d["wet_bulb_trace"] = WB
    if cfg.renewables.enabled:
        d["pv_cf_trace"] = CF
    return d


def assert_results_match(got: dict, want, rtol=1e-5, atol=1e-6):
    """Port result (numpy dict) vs a reference SimResult or dict."""
    want = want._asdict() if hasattr(want, "_asdict") else want
    want = {k: v for k, v in want.items() if v is not None}
    assert set(got) == set(want)
    for k, v in want.items():
        v = np.asarray(v, np.float64)
        g = np.asarray(got[k], np.float64)
        if k in COUNT_FIELDS:
            np.testing.assert_array_equal(g, v, err_msg=f"count {k}")
        else:
            np.testing.assert_allclose(g, v, rtol=rtol, atol=atol,
                                       err_msg=f"field {k}")


def run_port(cfg, tasks=None, hosts=None, ci=CI, dyn=None, backend=None):
    tasks, hosts = (port_tables(J_TASKS, J_HOSTS) if tasks is None
                    else (tasks, hosts))
    if backend is not None:
        cfg = cfg.replace(backend=backend)
    final, ys = P.simulate(tasks, hosts, ci, cfg, dyn=dyn, device="cpu")
    return P.result_to_numpy(P.summarize(final, cfg)), ys


# ---------------------------------------------------------------------------
# both port backends == the reference stage pipeline
# ---------------------------------------------------------------------------

MATRIX = [dict(cool=c, price=p, renew=r) for c, p, r in COMBOS] + [
    # everything on: blended dispatch, shifting with the stopper and a
    # down-scaled host count
    dict(cool=True, price=True, renew=True, policy="blended",
         shifting=dict(enabled=True, stop_running=True, max_delay_h=12.0),
         dyn={"n_active_hosts": 2, "dispatch_lambda": 0.4}),
    # the remaining dyn keys of the slice: a re-timed population, a masked
    # slot count, and swept battery / PV / setpoint / quantile levels
    dict(cool=True, price=True, renew=True, policy="price",
         shifting=dict(enabled=True, max_delay_h=6.0),
         dyn={"arrival_trace": np.sort(np.random.default_rng(4).uniform(
                  0.0, 12.0, _N)).astype(np.float32),
              "slots_per_step": 2, "batt_capacity_kwh": 4.0,
              "pv_capacity_kw": 15.0, "cooling_setpoint": 22.0,
              "shift_quantile_value": 0.5}),
]


@functools.lru_cache(maxsize=None)
def _reference(case: int):
    spec = dict(MATRIX[case])
    dyn = spec.pop("dyn", {})
    args = (spec.pop("cool"), spec.pop("price"), spec.pop("renew"))
    cfg = make_cfg(jconfig, *args, **spec)
    final, _ = J.simulate(J_TASKS, J_HOSTS, CI, cfg,
                          dyn={**trace_dyn(cfg), **dyn})
    return J.summarize(final, cfg)


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("case", range(len(MATRIX)))
def test_port_matches_reference(case, backend):
    spec = dict(MATRIX[case])
    dyn = spec.pop("dyn", {})
    args = (spec.pop("cool"), spec.pop("price"), spec.pop("renew"))
    cfg = make_cfg(pconfig, *args, **spec)
    got, _ = run_port(cfg, dyn={**trace_dyn(cfg), **dyn}, backend=backend)
    want = _reference(case)
    assert_results_match(got, want)
    assert got["n_done"] > 0


# ---------------------------------------------------------------------------
# golden snapshots (inputs built as in tests/test_golden.py)
# ---------------------------------------------------------------------------

def _golden_workload():
    rng = np.random.default_rng(42)
    n = 24
    tasks = J.make_task_table(np.sort(rng.uniform(0.0, 8.0, n)),
                              rng.uniform(0.5, 4.0, n),
                              rng.integers(1, 3, n).astype(float))
    return tasks, J.make_host_table(4, 4)


def _golden_ci():
    t = np.arange(S) * 0.25
    return (300.0 + 200.0 * np.sin(2 * np.pi * t / 24.0)).astype(np.float32)


def _golden_case(name: str):
    """(port tasks, hosts, cfg, dyn) of one golden scenario."""
    C = pconfig
    tasks, hosts = _golden_workload()
    dyn = {}
    if name == "core_battery_shifting":
        cfg = C.SimConfig(n_steps=S,
                          battery=C.BatteryConfig(enabled=True,
                                                  capacity_kwh=4.0),
                          shifting=C.ShiftingConfig(enabled=True))
    elif name == "thermal":
        t = np.arange(S) * 0.25
        dyn["wet_bulb_trace"] = (18.0 + 7.0 * np.sin(2 * np.pi * t / 24.0)
                                 ).astype(np.float32)
        cfg = C.SimConfig(n_steps=S, cooling=C.CoolingConfig(enabled=True))
    elif name == "pricing":
        from repro.pricetraces.synthetic import make_price_traces
        dyn["price_trace"] = make_price_traces(S, 0.25, 2, seed=5)[0]
        cfg = C.SimConfig(
            n_steps=S,
            pricing=C.PricingConfig(enabled=True, demand_charge_per_kw=8.0,
                                    billing_window_h=12.0),
            battery=C.BatteryConfig(enabled=True, capacity_kwh=4.0,
                                    policy="blended", dispatch_lambda=0.5,
                                    price_window_h=24.0))
    elif name == "renewables":
        from repro.renewabletraces.synthetic import make_pv_traces
        dyn["pv_cf_trace"] = make_pv_traces(S, 0.25, 2, seed=5)[0]
        cfg = C.SimConfig(
            n_steps=S,
            renewables=C.RenewableConfig(enabled=True, pv_capacity_kw=30.0),
            pricing=C.PricingConfig(enabled=True, export_price_fraction=0.4),
            battery=C.BatteryConfig(enabled=True, capacity_kwh=4.0))
    else:  # typed_workload
        rng = np.random.default_rng(42)
        n = 24
        tasks = J.make_task_table(
            np.sort(rng.uniform(0.0, 8.0, n)), rng.uniform(0.5, 4.0, n),
            rng.integers(1, 3, n).astype(float),
            job_class=np.array([0, 1, 2] * (n // 3), np.int32),
            sla_grace=np.where(np.arange(n) % 3 == 2, 0.25, -1.0))
        hosts = J.make_host_table(2, 4)
        cfg = C.SimConfig(
            n_steps=S,
            shifting=C.ShiftingConfig(enabled=True, max_delay_h=12.0),
            scheduler=C.SchedulerConfig(priority_levels=3))
    return (*port_tables(tasks, hosts), cfg, dyn)


GOLDENS = ("core_battery_shifting", "thermal", "pricing", "renewables",
           "typed_workload")


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("name", GOLDENS)
def test_golden_snapshot(name, backend):
    tasks, hosts, cfg, dyn = _golden_case(name)
    got, _ = run_port(cfg, tasks, hosts, _golden_ci(), dyn, backend)
    with open(os.path.join(GOLDEN_DIR, name + ".json")) as f:
        want = json.load(f)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                   np.asarray(v, np.float64), rtol=1e-4,
                                   atol=1e-8, err_msg=f"golden {name}.{k}")


# ---------------------------------------------------------------------------
# the energy-flow ledger, per step (as tests/test_energy_ledger.py holds it)
# ---------------------------------------------------------------------------

def check_ledger(cfg, res: dict, series: dict):
    flow = series["flow"]
    f = {k: getattr(flow, k).numpy() for k in flow._fields}
    lhs = f["grid_import_kw"] + f["pv_kw"] + f["batt_discharge_kw"]
    rhs = (f["it_kw"] + f["cooling_kw"] + f["batt_charge_kw"]
           + f["grid_export_kw"] + f["curtailed_kw"])
    scale = max(float(np.abs(rhs).max()), 1.0)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-5, atol=1e-4 * scale,
                               err_msg="ledger conservation violated")
    for k, v in f.items():
        assert (v >= -1e-5 * scale).all(), f"negative flow {k}"
    assert (np.minimum(f["grid_import_kw"], f["grid_export_kw"])
            <= 1e-5 * scale).all()
    if not cfg.renewables.enabled:
        for k in ("pv_kw", "grid_export_kw", "curtailed_kw"):
            assert (f[k] == 0.0).all(), f"{k} nonzero with renewables off"
    if cfg.renewables.export_allowed:
        assert (f["curtailed_kw"] == 0.0).all()
    if not cfg.cooling.enabled:
        assert (f["cooling_kw"] == 0.0).all()
    for key, fl in (("grid_energy_kwh", "grid_import_kw"),
                    ("it_energy_kwh", "it_kw"), ("pv_energy_kwh", "pv_kw"),
                    ("grid_export_kwh", "grid_export_kw"),
                    ("curtailed_kwh", "curtailed_kw"),
                    ("batt_discharged_kwh", "batt_discharge_kw")):
        np.testing.assert_allclose(float(res[key]), f[fl].sum() * DT,
                                   rtol=1e-4, atol=1e-3, err_msg=key)


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("cool,price,renew", COMBOS)
def test_every_step_conserves_energy(cool, price, renew, backend):
    cfg = make_cfg(pconfig, cool, price, renew,
                   policy="blended" if price else "carbon",
                   collect_series=True)
    res, ys = run_port(cfg, dyn=trace_dyn(cfg), backend=backend)
    check_ledger(cfg, res, ys)


@pytest.mark.parametrize("backend", P.BACKENDS)
def test_no_battery_curtailment_conserves_energy(backend):
    cfg = make_cfg(pconfig, True, True, True, batt=False, export=False,
                   collect_series=True)
    res, ys = run_port(cfg, dyn=trace_dyn(cfg), backend=backend)
    check_ledger(cfg, res, ys)
    assert ys["flow"].curtailed_kw.sum() > 0


def test_series_agree_between_backends():
    cfg = make_cfg(pconfig, True, True, True, policy="blended",
                   collect_series=True)
    _, a = run_port(cfg, dyn=trace_dyn(cfg), backend="stage-pipeline")
    _, b = run_port(cfg, dyn=trace_dyn(cfg), backend="megakernel")
    assert set(a) == set(b)
    for k in a:
        x, y = a[k], b[k]
        pairs = zip(x, y) if isinstance(x, P.EnergyFlow) else [(x, y)]
        for u, v in pairs:
            np.testing.assert_allclose(u.numpy(), v.numpy(), rtol=1e-4,
                                       atol=1e-3, err_msg=f"series {k}")


# ---------------------------------------------------------------------------
# validation and what the port refuses
# ---------------------------------------------------------------------------

def _base_cfg(**kw):
    return make_cfg(pconfig, False, False, False, **kw)


def test_backend_validation():
    with pytest.raises(ValueError, match="unknown backend"):
        run_port(_base_cfg(backend="warpdrive"))
    tasks, hosts = port_tables(J_TASKS, J_HOSTS)
    with pytest.raises(ValueError, match="stage-pipeline"):
        P.simulate(tasks, hosts, CI, _base_cfg(backend="megakernel"),
                   stages=[], device="cpu")


def test_trace_validation():
    with pytest.raises(ValueError, match="carbon trace too short"):
        run_port(_base_cfg(), ci=CI[:10])
    with pytest.raises(ValueError, match="pricing subsystem"):
        run_port(make_cfg(pconfig, False, False, False, policy="price"))
    with pytest.raises(ValueError, match="renewables"):
        run_port(_base_cfg(), dyn={"pv_cf_trace": CF})


@pytest.mark.parametrize("field,value", [
    ("failures", ("FailureConfig", {"enabled": True})),
    ("resilience", ("ResilienceConfig", {"enabled": True})),
    ("probes", ("ProbeConfig", {"enabled": True})),
])
def test_unported_subsystems_raise(field, value):
    """Nothing of these is refused any more: failures, the resilience loop
    and the probe bus are ported (tests/test_torch_resilience.py and
    tests/test_torch_telemetry.py hold them to the reference): they run,
    and the probe bus fills its ring."""
    cls, kw = value
    cfg = _base_cfg().replace(**{field: getattr(pconfig, cls)(**kw)})
    got, _ = run_port(cfg)
    assert np.isfinite(got["total_carbon_kg"]) and got["n_done"] > 0
    if field == "probes":
        np.testing.assert_array_equal(got["probes"]["step"], np.arange(S))


@pytest.mark.parametrize("key", ["interactive_frac", "failure_hazard_scale",
                                 "throttle_inlet_c", "pdu_cap_kw", "seed"])
def test_unported_dyn_keys_raise(key):
    """The resilience loop's keys raise the reference's ValueError while
    the loop is off; `interactive_frac` and `seed` are ported and give the
    reference's result."""
    if key in ("failure_hazard_scale", "throttle_inlet_c", "pdu_cap_kw"):
        with pytest.raises(ValueError, match="resilience"):
            run_port(_base_cfg(), dyn={key: 1.0})
        return
    value = {"interactive_frac": 0.5, "seed": 3}[key]
    spec = dict(scheduler=dict(priority_levels=3),
                failures=dict(enabled=True, mtbf_h=10.0))
    cfgs = []
    for C in (jconfig, pconfig):
        cfg = make_cfg(C, False, False, False,
                       scheduler=spec["scheduler"])
        cfgs.append(cfg.replace(failures=C.FailureConfig(**spec["failures"])))
    final, _ = J.simulate(J_TASKS, J_HOSTS, CI, cfgs[0], dyn={key: value})
    got, _ = run_port(cfgs[1], dyn={key: value})
    assert_results_match(got, J.summarize(final, cfgs[0]), rtol=1e-4,
                         atol=1e-4)


def test_unported_table_options_raise():
    """Straggler hosts (ported) carry the reference's speeds.  Every table
    option is ported now (scheduler mode 'aggregate' is held against the
    reference in tests/test_torch_experiments.py)."""
    for seed in (0, 5):
        got = P.make_host_table(40, 4, straggler_frac=0.3, seed=seed,
                                device="cpu")
        want = J.make_host_table(40, 4, straggler_frac=0.3, seed=seed)
        np.testing.assert_array_equal(got.speed.numpy(),
                                      np.asarray(want.speed))


def test_tables_carry_over_exactly():
    tasks, hosts = port_tables(J_TASKS, J_HOSTS)
    for port, ref in ((tasks, J_TASKS), (hosts, J_HOSTS)):
        assert port._fields == ref._fields
        for k, v in _np(ref).items():
            got = getattr(port, k).numpy()
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_port_imports_neither_jax_nor_reference():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert 'repro_torch.core.telemetry' in sys.modules\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n"
        "assert not bad, bad\n")
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    env = dict(os.environ, PYTHONPATH=src)
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 20  # every module was imported
