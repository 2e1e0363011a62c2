"""The port's experiment tooling against the reference package, on the CPU.

The fragmentation-blind `aggregate` scheduler (per task: status, host and
first start exact; whole runs through both executors: outcome counts and
per-task states exact, totals within rtol 1e-5), the §III analytical
shifting model (per-task savings bit-equal, the mean within rtol 1e-5 /
atol 1e-4 in percent: its f32 sum may associate differently), the scaling
search (the same `(best, evaluated)` pair), the public helpers (bit-equal
or within rtol 1e-6), and the CLI's JSON at a small scale (the same keys and
printed values).  The same paths run at full scale on the card in
`chip_smoke.py`'s experiments phase.
"""
from __future__ import annotations

import contextlib
import functools
import io
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.carbontraces import make_region_traces
from repro.core import analytical as janalytical
from repro.core import metrics as jmetrics
from repro.core import scheduler as jsched
from repro.core import state as jstate
from repro.launch import simulate as jcli
from repro.workloads import make_workload as j_make_workload
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro_torch.core import analytical as panalytical
from repro_torch.core import metrics as pmetrics
from repro_torch.core import scheduler as psched
from repro_torch.kernels import ops
from repro_torch.launch import simulate as pcli

torch.set_num_threads(1)

S = 96
DT = 0.25
COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "n_interrupts", "class_n_violations", "class_n_decided",
                "class_n_started")


def _np(table) -> dict:
    return {k: np.asarray(v) for k, v in table._asdict().items()}


def port_tables(tasks, hosts):
    return P.tables_from_numpy(_np(tasks), _np(hosts), device="cpu")


def assert_close(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in COUNT_FIELDS:
            np.testing.assert_array_equal(got[k], v, err_msg=f"count {k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64), rtol=rtol,
                                       atol=atol, err_msg=f"field {k}")


# ---------------------------------------------------------------------------
# schedule_aggregate, one call
# ---------------------------------------------------------------------------

def _sched_case(seed: int, case: str):
    """(reference tables, now, shift_ok) of one scheduler call: 60 tasks on
    7 hosts of 16 cores and 4 GPUs, some already running; `case` takes
    hosts out (down, inactive) or gives tasks no footprint."""
    rng = np.random.default_rng(seed)
    n, h = 60, 7
    cores = rng.integers(1, 6, n).astype(float)
    gpus = rng.integers(0, 2, n).astype(float)
    if case == "zero_footprint":
        zero = rng.uniform(size=n) < 0.3
        cores[zero], gpus[zero] = 0.0, 0.0
    tasks = J.make_task_table(np.sort(rng.uniform(0.0, 4.0, n)),
                              rng.uniform(0.5, 3.0, n), cores, gpus)
    hosts = J.make_host_table(h, 16, 4)
    run = rng.uniform(size=n) < 0.15
    status = np.where(run, jsched.RUNNING, np.asarray(tasks.status))
    host = np.where(run, rng.integers(0, h, n), -1)
    tasks = tasks._replace(status=jnp.asarray(status, jnp.int32),
                           host=jnp.asarray(host, jnp.int32))
    if case in ("down", "zero_footprint"):
        hosts = hosts._replace(up=jnp.asarray(rng.uniform(size=h) < 0.6))
    if case == "inactive":
        hosts = hosts._replace(active=jnp.arange(h) < 4)
    shift_ok = rng.uniform(size=n) < 0.8
    return tasks, hosts, np.float32(rng.uniform(1.0, 4.0)), shift_ok


def _both_aggregate(tasks, hosts, now, shift_ok):
    want = jsched.schedule_aggregate(tasks, hosts, jnp.float32(now),
                                     jnp.asarray(shift_ok),
                                     jconfig.SchedulerConfig())
    pt, ph = port_tables(tasks, hosts)
    got = psched.schedule_aggregate(pt, ph, torch.tensor(now),
                                    torch.tensor(shift_ok),
                                    pconfig.SchedulerConfig())
    return got, want


@pytest.mark.parametrize("case", ["healthy", "down", "inactive",
                                  "zero_footprint"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_schedule_aggregate_bit_equal(seed, case):
    tasks, hosts, now, ok = _sched_case(seed, case)
    got, want = _both_aggregate(tasks, hosts, now, ok)
    for f in ("status", "host", "first_start"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    # admitted tasks sit on usable hosts; a healthy datacenter admits
    new = got.status.numpy() != np.asarray(tasks.status)
    usable = np.asarray(hosts.active & hosts.up)
    assert usable[got.host.numpy()[new]].all()
    assert new.any() or case != "healthy"


def test_schedule_aggregate_rows():
    """[B, T] task rows and [B, H] host rows (one scenario a row, as a grid
    runs them): each row equals the reference's call on that row."""
    cases = [_sched_case(s, c) for s, c in ((0, "down"), (1, "healthy"),
                                            (2, "zero_footprint"))]
    tasks0, hosts0, now, _ = cases[0]
    pt, ph = port_tables(tasks0, hosts0)
    rows = lambda f, tabs: torch.stack([torch.tensor(np.asarray(  # noqa
        getattr(t, f))) for t in tabs])
    pt = pt._replace(status=rows("status", [c[0] for c in cases]),
                     host=rows("host", [c[0] for c in cases]))
    ph = ph._replace(up=rows("up", [c[1] for c in cases]))
    shift_ok = torch.ones(len(cases), pt.arrival.shape[-1], dtype=torch.bool)
    got = psched.schedule_aggregate(pt, ph, torch.tensor(now), shift_ok,
                                    pconfig.SchedulerConfig())
    for r, (t, h, _, _) in enumerate(cases):
        t = t._replace(arrival=tasks0.arrival, duration=tasks0.duration,
                       cores=tasks0.cores, gpus=tasks0.gpus)
        h = h._replace(active=hosts0.active)
        want = jsched.schedule_aggregate(t, h, jnp.float32(now),
                                         jnp.ones(t.n, bool),
                                         jconfig.SchedulerConfig())
        for f in ("status", "host", "first_start"):
            np.testing.assert_array_equal(getattr(got, f)[r].numpy(),
                                          np.asarray(getattr(want, f)),
                                          f"row {r} {f}")


def _zero_footprint_task(M):
    return M.make_task_table([0.0], [1.0], [0.0], [0.0], [0.5], [0.0],
                             **({"device": "cpu"} if M is P else {}))


@pytest.mark.parametrize("flag", ["up", "active"])
def test_aggregate_skips_unusable_hosts_zero_footprint(flag):
    """A zero-need task's midpoint maps onto the first host whatever its
    state; the next-usable bump moves it (tests/test_resilience.py)."""
    hosts = P.make_host_table(2, 2, device="cpu")._replace(
        **{flag: torch.tensor([False, True])})
    out = psched.schedule_aggregate(_zero_footprint_task(P), hosts,
                                    torch.tensor(0.0),
                                    torch.ones(1, dtype=torch.bool),
                                    pconfig.SchedulerConfig())
    jhosts = J.make_host_table(2, 2)._replace(
        **{flag: jnp.asarray([False, True])})
    want = jsched.schedule_aggregate(_zero_footprint_task(J), jhosts,
                                     jnp.float32(0.0), jnp.ones(1, bool),
                                     jconfig.SchedulerConfig())
    assert int(out.host[0]) == int(want.host[0]) == 1
    assert int(out.status[0]) == int(want.status[0]) == P.RUNNING


def test_aggregate_leaves_task_pending_when_no_host_usable():
    hosts = P.make_host_table(2, 2, device="cpu")._replace(
        up=torch.zeros(2, dtype=torch.bool))
    out = psched.schedule_aggregate(_zero_footprint_task(P), hosts,
                                    torch.tensor(0.0),
                                    torch.ones(1, dtype=torch.bool),
                                    pconfig.SchedulerConfig())
    assert int(out.status[0]) == P.PENDING


def test_aggregate_refuses_priority_levels():
    """The reference's ValueError, from the scheduler and from a run."""
    tasks, hosts, now, ok = _sched_case(0, "healthy")
    with pytest.raises(ValueError, match="priority"):
        jsched.schedule_step(tasks, hosts, jnp.float32(now), jnp.asarray(ok),
                             jconfig.SchedulerConfig(mode="aggregate",
                                                     priority_levels=2))
    pt, ph = port_tables(tasks, hosts)
    cfg = pconfig.SchedulerConfig(mode="aggregate", priority_levels=2)
    with pytest.raises(ValueError, match="priority"):
        psched.schedule_step(pt, ph, torch.tensor(now), torch.tensor(ok),
                             cfg)
    for be in P.BACKENDS:
        with pytest.raises(ValueError, match="priority"):
            P.simulate(pt, ph, np.full(S, 300.0, np.float32),
                       pconfig.SimConfig(n_steps=S, scheduler=cfg,
                                         backend=be), device="cpu")
    with pytest.raises(ValueError, match="unknown scheduler mode"):
        psched.schedule_step(pt, ph, torch.tensor(now), torch.tensor(ok),
                             pconfig.SchedulerConfig(mode="best_fit"))


# ---------------------------------------------------------------------------
# whole aggregate runs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _workload():
    """A small Marconi (48 cores, 4 GPUs a host) of one day: reference
    tables and the port's copy of them."""
    jt, jh, _, meta = j_make_workload("marconi", scale=0.05, seed=0,
                                      dt_h=DT, horizon_days=1.0)
    return (jt, jh), port_tables(jt, jh), meta


def _ci():
    return make_region_traces(S, DT, 8, seed=0)[0]


def _run_cfg(C, case: str, meta, **kw):
    agg = C.SchedulerConfig(mode="aggregate")
    if case == "plain":
        return C.SimConfig(n_steps=S, dt_h=DT, embodied=meta["embodied"],
                           scheduler=agg, **kw)
    if case == "techniques":
        return C.SimConfig(
            n_steps=S, dt_h=DT, embodied=meta["embodied"], scheduler=agg,
            cooling=C.CoolingConfig(enabled=True, heat_reuse_fraction=0.3),
            pricing=C.PricingConfig(enabled=True, billing_window_h=12.0),
            battery=C.BatteryConfig(enabled=True, capacity_kwh=40.0),
            shifting=C.ShiftingConfig(enabled=True), **kw)
    assert case == "failures"  # per-row `up` under the closed loop
    return C.SimConfig(
        n_steps=S, dt_h=DT, embodied=meta["embodied"], scheduler=agg,
        seed=3, failures=C.FailureConfig(enabled=True, mtbf_h=40.0),
        resilience=C.ResilienceConfig(enabled=True, reactive_placement=True),
        **kw)


def _run_dyn(case: str) -> dict:
    dyn = {"n_active_hosts": 30}
    if case == "techniques":
        t = np.arange(S) * DT
        dyn["wet_bulb_trace"] = (14.0 + 6.0 * np.sin(2 * np.pi * t / 24)
                                 ).astype(np.float32)
        dyn["price_trace"] = (0.1 * (1 + 0.5 * np.sin(2 * np.pi * t / 24))
                              ).astype(np.float32)
    return dyn


@functools.lru_cache(maxsize=None)
def _reference_run(case: str):
    (jt, jh), _, meta = _workload()
    cfg = _run_cfg(jconfig, case, meta)
    final, _ = J.simulate(jt, jh, _ci(), cfg, dyn=_run_dyn(case))
    return final, {k: np.asarray(v) for k, v in
                   J.summarize(final, cfg)._asdict().items()
                   if v is not None}


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("case", ["plain", "techniques", "failures"])
def test_aggregate_run_matches_reference(case, backend, monkeypatch):
    """Per-task status and host exact, counts exact, totals within rtol
    1e-5; first-fit is never called."""
    def no_first_fit(*a, **k):
        raise AssertionError("first-fit placement under mode 'aggregate'")
    monkeypatch.setattr(ops, "first_fit_place", no_first_fit)
    _, (pt, ph), meta = _workload()
    want_state, want = _reference_run(case)
    cfg = _run_cfg(pconfig, case, meta, backend=backend)
    final, _ = P.simulate(pt, ph, _ci(), cfg, dyn=_run_dyn(case),
                          device="cpu")
    got = P.result_to_numpy(P.summarize(final, cfg))
    assert_close(got, want, 1e-5, 1e-4)
    for f in ("status", "host"):
        np.testing.assert_array_equal(getattr(final.tasks, f).numpy(),
                                      np.asarray(getattr(want_state.tasks,
                                                         f)), f)
    assert want["n_started"] > 0
    if case == "failures":
        assert want["n_interrupts"] > 0


def test_aggregate_grid_matches_reference():
    """Aggregate scheduling on [B, H] host rows: a grid of active-host
    counts x failure seeds (each row its own `active` and `up`), both
    executors, against the reference's grid."""
    (jt, jh), (pt, ph), meta = _workload()

    def axes(M):
        return [M.dyn_axis(n_active_hosts=np.array([12, 30])),
                M.seed_axis(np.array([3, 8]))]

    cfg = _run_cfg(jconfig, "failures", meta)
    want = {k: np.asarray(v) for k, v in J.sweep_grid(
        jt, jh, cfg, axes(J), ci_trace=_ci())._asdict().items()
        if v is not None}
    assert want["n_done"].shape == (2, 2)
    for be in P.BACKENDS:
        got = P.result_to_numpy(P.sweep_grid(
            pt, ph, _run_cfg(pconfig, "failures", meta, backend=be),
            axes(P), ci_trace=_ci(), device="cpu"))
        assert_close(got, want, 1e-5, 1e-4)
    assert want["n_done"][0, 0] != want["n_done"][1, 0]


# ---------------------------------------------------------------------------
# the §III analytical model
# ---------------------------------------------------------------------------

def _analytical_case(seed: int, n: int = 700):
    rng = np.random.default_rng(seed)
    ci = make_region_traces(2 * S, DT, 8, seed=seed)[seed % 8]
    arrival = np.sort(rng.uniform(0.0, 2 * S * DT, n)).astype(np.float32)
    duration = rng.lognormal(0.5, 1.2, n).astype(np.float32)
    duration[:5] = 0.0  # below the model's floor
    return arrival, duration, ci


@pytest.mark.parametrize("form", ["oracle", "threshold", "trace_threshold"])
@pytest.mark.parametrize("seed", [0, 1, 5])
def test_analytical_savings_match_reference(seed, form, monkeypatch):
    """Per-task savings bit-equal; the mean within rtol 1e-5, atol 1e-4
    (percent).  Chunks of 256 tasks cross chunk boundaries."""
    monkeypatch.setattr(panalytical, "_CHUNK_TASKS", 256)
    arrival, duration, ci = _analytical_case(seed)
    kw = dict(oracle=form == "oracle")
    if form == "threshold":
        kw["threshold"] = np.full_like(ci, np.median(ci))
    want_mean, want = janalytical.analytical_shifting_savings(
        arrival, duration, ci, DT, **kw)
    got_mean, got = panalytical.analytical_shifting_savings(
        arrival, duration, ci, DT, device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_allclose(float(got_mean), float(want_mean), rtol=1e-5,
                               atol=1e-4)
    assert float(want_mean) > 0.0


@pytest.mark.parametrize("max_delay,n", [(24.0, 97), (12.0, 7), (5.0, 13),
                                         (1.0 / 3.0, 4), (24.0, 1)])
def test_analytical_delay_grids(max_delay, n):
    """The candidate delays are `jnp.linspace`'s formula with IEEE
    quotients.  XLA's CPU code does not always divide the iota so (5 h over
    13 points: three delays one ulp above), so the delays are held within
    one ulp and the savings within rtol 1e-5, atol 1e-4 (percent); where
    the delays are equal (the default 24 h over 97 points among them), the
    savings are bit-equal."""
    got_d = panalytical._delay_grid(max_delay, n)
    want_d = np.asarray(jnp.linspace(0.0, max_delay, n))
    np.testing.assert_array_max_ulp(got_d, want_d, maxulp=1)
    arrival, duration, ci = _analytical_case(2, 200)
    _, want = janalytical.analytical_shifting_savings(
        arrival, duration, ci, DT, max_delay_h=max_delay, n_delay_grid=n)
    _, got = panalytical.analytical_shifting_savings(
        arrival, duration, ci, DT, max_delay_h=max_delay, n_delay_grid=n,
        device="cpu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    if np.array_equal(got_d, want_d):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if (max_delay, n) == (24.0, 97):
        np.testing.assert_array_equal(got_d, want_d)


# ---------------------------------------------------------------------------
# the scaling search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lo,hi,target", [
    (1, 972, 0.01), (1, 972, 0.3), (1, 972, 0.8), (400, 972, 0.5),
    (5, 5, 0.2), (5, 5, 0.9), (1, 2, 0.6), (1, 100, 0.0)])
def test_find_min_scale_synthetic(lo, hi, target):
    """A monotone SLA curve (sla(n) = 600 / (n + 100) - 0.05, clipped):
    both packages return the same pair; the port evaluates `hi` once."""
    calls = []

    def sla(n):
        calls.append(n)
        return float(np.clip(600.0 / (n + 100) - 0.05, 0.0, 1.0))

    want = J.find_min_scale(sla, lo, hi, target)
    calls.clear()
    got = P.find_min_scale(sla, lo, hi, target)
    assert got == want
    assert calls.count(hi) == 1
    assert set(calls) == set(want[1]) | {hi}


def test_find_min_scale_real_runs():
    """`find_min_scale` over `with_scale` runs of the small Marconi in
    each package: the same pair, every SLA fraction equal."""
    (jt, jh), (pt, ph), meta = _workload()
    jcfg = jconfig.SimConfig(n_steps=S, dt_h=DT, embodied=meta["embodied"],
                             backend="megakernel")
    pcfg = pconfig.SimConfig(n_steps=S, dt_h=DT, embodied=meta["embodied"],
                             backend="megakernel")

    def jsla(n):
        final, _ = J.simulate(jt, J.with_scale(jh, n), _ci(), jcfg)
        return float(J.summarize(final, jcfg).sla_violation_frac)

    def psla(n):
        final, _ = P.simulate(pt, P.with_scale(ph, n), _ci(), pcfg,
                              device="cpu")
        return float(P.summarize(final, pcfg).sla_violation_frac)

    n = ph.cores.shape[0]
    for target in (0.05, 0.4):
        want = J.find_min_scale(jsla, 1, n, target)
        assert P.find_min_scale(psla, 1, n, target) == want
        assert 1 <= want[0] <= n and len(want[1]) > 2


# ---------------------------------------------------------------------------
# the public helpers
# ---------------------------------------------------------------------------

def test_stack_task_tables():
    rng = np.random.default_rng(4)
    tabs = [P.make_task_table(np.sort(rng.uniform(0, 5, 9)),
                              rng.uniform(0.5, 2, 9), np.ones(9),
                              device="cpu") for _ in range(3)]
    got = P.stack_task_tables(tabs)
    want = jstate.stack_task_tables([J.make_task_table(
        t.arrival.numpy(), t.duration.numpy(), t.cores.numpy())
        for t in tabs])
    assert type(got) is P.TaskTable
    for f, g, w in zip(P.TaskTable._fields, got, want):
        assert g.shape == (3, 9), f
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), f)


@functools.lru_cache(maxsize=None)
def _grids():
    """(reference, port) SimResults of a small regions x battery grid with
    cooling and pricing, and the same grid with neither (fields [2, 2])."""
    (jt, jh), (pt, ph), meta = _workload()
    ci = make_region_traces(S, DT, 2, seed=3)
    out = []
    for on in (True, False):
        def cfg(C):
            return C.SimConfig(
                n_steps=S, dt_h=DT, embodied=meta["embodied"],
                cooling=C.CoolingConfig(enabled=on, heat_reuse_fraction=0.3),
                pricing=C.PricingConfig(enabled=on),
                battery=C.BatteryConfig(enabled=True))
        caps = np.array([10.0, 60.0], np.float32)
        want = J.sweep_regions_x_battery(jt, jh, ci, caps, cfg(jconfig))
        got = P.sweep_regions_x_battery(pt, ph, ci, caps, cfg(pconfig),
                                        device="cpu")
        out.append((want, got, cfg(pconfig)))
    return out


def test_carbon_reduction_pct_and_flat_cost():
    """Bit for bit on the same inputs (the two grids' totals agree within
    the grid contract, rtol 1e-5)."""
    (want, got, _), (jbase, pbase, _) = _grids()
    np.testing.assert_allclose(got.total_carbon_kg.numpy(),
                               np.asarray(want.total_carbon_kg), rtol=1e-5)
    jb = jbase._replace(total_carbon_kg=jnp.asarray(
        pbase.total_carbon_kg.numpy()))
    jt = want._replace(total_carbon_kg=jnp.asarray(
        got.total_carbon_kg.numpy()))
    np.testing.assert_array_equal(
        P.carbon_reduction_pct(pbase, got).numpy(),
        np.asarray(J.carbon_reduction_pct(jb, jt)))
    from repro.core.pricing import flat_energy_cost as jflat
    e = got.grid_energy_kwh
    np.testing.assert_array_equal(P.flat_energy_cost(e, 0.12).numpy(),
                                  np.asarray(jflat(jnp.asarray(e.numpy()),
                                                   0.12)))


@pytest.mark.parametrize("mode", ["cfg", "explicit", "inferred"])
def test_sustainability_extras(mode):
    """Simulated water and cost where the subsystems ran, the flat
    estimates where they did not, in each way of saying which ran."""
    for want_res, got_res, cfg in _grids():
        # the port's numbers through both functions: only the extras'
        # arithmetic is compared
        jres = type(want_res)(*(
            None if v is None else jnp.asarray(getattr(got_res, k).numpy())
            for k, v in want_res._asdict().items()))
        if mode == "cfg":
            kw_p, kw_j = {"cfg": cfg}, {"cfg": _jcfg(cfg)}
        elif mode == "explicit":
            on = cfg.cooling.enabled
            kw_p = kw_j = {"simulated_water": on, "simulated_cost": on}
        else:
            kw_p = kw_j = {}
        got = pmetrics.sustainability_extras(got_res, price_per_kwh=0.2,
                                             **kw_p)
        want = jmetrics.sustainability_extras(jres, price_per_kwh=0.2,
                                              **kw_j)
        assert got._fields == want._fields
        for f, g, w in zip(want._fields, got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                       err_msg=f"{mode} {f}")
        if cfg.cooling.enabled:
            assert (got.heat_credit_kg.numpy() > 0).all()


def _jcfg(cfg):
    return jconfig.SimConfig(
        cooling=jconfig.CoolingConfig(enabled=cfg.cooling.enabled),
        pricing=jconfig.PricingConfig(enabled=cfg.pricing.enabled))


@pytest.mark.parametrize("setpoint", [None, 22.0])
def test_dynamic_pue(setpoint):
    from repro.core.thermal import dynamic_pue as jpue
    rng = np.random.default_rng(9)
    it = rng.uniform(0.0, 900.0, 64).astype(np.float32)
    it[:3] = 0.0
    wb = rng.uniform(-5.0, 32.0, 64).astype(np.float32)
    for cfg_kw in ({}, {"economizer_range_c": 2.0, "max_cop": 6.0}):
        jc = jconfig.CoolingConfig(enabled=True, **cfg_kw)
        pc = pconfig.CoolingConfig(enabled=True, **cfg_kw)
        want = np.asarray(jpue(jnp.asarray(it), jnp.asarray(wb), jc,
                               setpoint))
        got = P.dynamic_pue(torch.tensor(it), torch.tensor(wb), pc,
                            setpoint).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert (got >= 1.0).all()


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli_json(main, argv) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("args", [
    ["--techniques", "B,TS"],
    ["--workload", "marconi", "--techniques", "TS", "--active-hosts", "12",
     "--regions", "3", "--battery-kwh", "50"]])
def test_cli_matches_reference(args):
    argv = ["--scale", "0.02", "--days", "2", *args]
    want = _cli_json(jcli.main, argv)
    got = _cli_json(pcli.main, [*argv, "--device", "cpu"])
    assert list(got) == list(want)
    assert got == want
