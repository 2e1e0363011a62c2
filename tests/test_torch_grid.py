"""The PyTorch port's scenario grid against the reference package, on the CPU.

`repro_torch.core.sweep_grid` runs a grid's cells as the scenario rows of
one step loop; the reference composes `jax.vmap`s over `simulate`.  The same
tables, traces and axes go through both, on both of the port's step
executors, and every field must agree under the reference's own grid
contract (tests/test_grid.py): counts exact, every other field within rtol
1e-5, atol 1e-6.  The reference is held through its plain and chunked
executors only (its sharded ones fail on this tree).  Within the port,
every cell of a grid equals the port's own `simulate` of that scenario, and
what the port does not have yet is refused naming its ROADMAP item.  The
same grid on the card is in tests/test_torch_card.py.
"""
from __future__ import annotations

import functools

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro.pricetraces.synthetic import make_price_traces
from repro.renewabletraces.synthetic import make_pv_traces
from repro.tasktraces.synthetic import make_arrival_sets
from repro.weathertraces.synthetic import make_weather_traces

torch.set_num_threads(1)

N_STEPS = 96  # one day at dt = 0.25, as tests/test_grid.py
COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "class_n_violations", "class_n_decided", "class_n_started")


@pytest.fixture(scope="module")
def workload():
    """(reference tables, port tables) of tests/test_grid.py's workload."""
    tasks, hosts = _ref_tables()
    as_np = lambda t: {k: np.asarray(v) for k, v in t._asdict().items()}  # noqa: E731,E501
    return (tasks, hosts), P.tables_from_numpy(as_np(tasks), as_np(hosts),
                                               device="cpu")


def _traces():
    t = np.arange(N_STEPS) * 0.25
    return np.stack([300.0 + 200.0 * np.sin(2 * np.pi * t / 24.0 + p)
                     for p in (0.0, 1.7)]).astype(np.float32)


@pytest.fixture(scope="module")
def traces():
    return _traces()


def _ref_tables():
    rng = np.random.default_rng(0)
    n = 12
    return (J.make_task_table(np.sort(rng.uniform(0.0, 6.0, n)),
                              rng.uniform(0.5, 4.0, n),
                              rng.integers(1, 3, n).astype(float)),
            J.make_host_table(3, 4))


WB = make_weather_traces(N_STEPS, 0.25, 3, seed=2)
PRICES = make_price_traces(N_STEPS, 0.25, 2, seed=5)
PV = make_pv_traces(N_STEPS, 0.25, 2, seed=5)
# three arrival sets of the workload's 12 tasks, on three regions' traffic
ARRIVALS = make_arrival_sets(12, N_STEPS, 0.25, 3, seed=4)


def case(name: str, C, core, traces):
    """(cfg, axes, ci_trace, base dyn) of one grid, built in either package
    (`C` its config module, `core` its core package)."""
    battery = C.BatteryConfig(enabled=True)
    if name == "trace_capacity_quantile":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            shifting=C.ShiftingConfig(enabled=True)),
                [core.trace_axis(traces),
                 core.dyn_axis(batt_capacity_kwh=np.array([2.0, 6.0])),
                 core.dyn_axis(shift_quantile_value=np.array([0.25, 0.6]))],
                None, None)
    if name == "weather_trace_setpoint":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            cooling=C.CoolingConfig(enabled=True)),
                [core.weather_axis(WB), core.trace_axis(traces),
                 core.dyn_axis(cooling_setpoint=np.array([20.0, 26.0]))],
                None, None)
    if name == "price_lambda":
        return (C.SimConfig(
                    n_steps=N_STEPS,
                    pricing=C.PricingConfig(enabled=True,
                                            billing_window_h=12.0),
                    battery=C.BatteryConfig(enabled=True, capacity_kwh=4.0,
                                            policy="blended",
                                            price_window_h=24.0)),
                [core.price_axis(PRICES),
                 core.dyn_axis(dispatch_lambda=np.array([0.0, 0.4, 1.0]))],
                traces[0], None)
    if name == "renewable_pv_capacity":
        return (C.SimConfig(
                    n_steps=N_STEPS, battery=battery,
                    pricing=C.PricingConfig(enabled=True,
                                            export_price_fraction=0.4),
                    renewables=C.RenewableConfig(enabled=True)),
                [core.renewable_axis(PV),
                 core.dyn_axis(pv_capacity_kw=np.array([5.0, 30.0])),
                 core.dyn_axis(batt_capacity_kwh=np.array([2.0, 8.0]))],
                traces[1], {"price_trace": PRICES[0]})
    if name == "zipped_capacity_rate":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery),
                [core.dyn_axis(batt_capacity_kwh=np.array([3.0, 8.0]),
                               batt_rate_kw=np.array([6.0, 10.0]))],
                traces[0], None)
    if name == "hosts_x_slots":
        return (C.SimConfig(n_steps=N_STEPS,
                            shifting=C.ShiftingConfig(enabled=True),
                            scheduler=C.SchedulerConfig(slots_per_step=4)),
                [core.dyn_axis(n_active_hosts=np.array([1, 2, 3])),
                 core.dyn_axis(slots_per_step=np.array([1, 4]))],
                traces[0], None)
    if name == "tasktrace":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            shifting=C.ShiftingConfig(enabled=True)),
                [core.tasktrace_axis(ARRIVALS)], traces[0], None)
    if name == "tasktrace_x_trace":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery),
                [core.trace_axis(traces), core.tasktrace_axis(ARRIVALS),
                 core.dyn_axis(batt_capacity_kwh=np.array([2.0, 6.0]))],
                None, None)
    if name == "tasktrace_priority":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            shifting=C.ShiftingConfig(enabled=True),
                            scheduler=C.SchedulerConfig(priority_levels=3,
                                                        slots_per_step=4)),
                [core.tasktrace_axis(ARRIVALS),
                 core.dyn_axis(interactive_frac=np.array([0.0, 0.5]))],
                traces[1], None)
    store = name.split("_")[-1]  # "stores_bf16", "stores_int8"
    return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                        cooling=C.CoolingConfig(enabled=True),
                        pricing=C.PricingConfig(enabled=True)),
            [core.trace_axis(traces, store=store),
             core.weather_axis(WB[:2], store=store),
             core.price_axis(PRICES, store=store)],
            None, None)


CASES = ("trace_capacity_quantile", "weather_trace_setpoint", "price_lambda",
         "renewable_pv_capacity", "zipped_capacity_rate", "hosts_x_slots",
         "stores_bf16", "stores_int8", "tasktrace", "tasktrace_x_trace",
         "tasktrace_priority")
TASKTRACE_CASES = ("tasktrace", "tasktrace_x_trace", "tasktrace_priority")


@functools.lru_cache(maxsize=None)
def reference(name: str):
    """The reference's grid result of case `name`, as numpy fields."""
    cfg, axes, ci, dyn = case(name, jconfig, J, _traces())
    return as_numpy(J.sweep_grid(*_ref_tables(), cfg, axes, ci_trace=ci,
                                 dyn=dyn))


def as_numpy(res) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in res._asdict().items() if v is not None}


def port(workload, traces, name, backend, **kw):
    cfg, axes, ci, dyn = case(name, pconfig, P, traces)
    tasks, hosts = workload[1]
    return P.sweep_grid(tasks, hosts, cfg.replace(backend=backend), axes,
                        ci_trace=ci, dyn=dyn, device="cpu", **kw)


def assert_fields_match(got: dict, want: dict, rtol=1e-5, atol=1e-6):
    assert set(got) == set(want)
    for k, v in want.items():
        g = np.asarray(got[k], np.float64)
        assert g.shape == np.shape(v), k
        if k in COUNT_FIELDS:
            np.testing.assert_array_equal(g, v, err_msg=f"count {k}")
        else:
            np.testing.assert_allclose(g, np.asarray(v, np.float64),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"field {k}")


# ---------------------------------------------------------------------------
# every axis kind, both executors of the port == the reference grid
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("name", CASES)
def test_grid_matches_reference(workload, traces, name, backend):
    got = as_numpy(port(workload, traces, name, backend))
    assert_fields_match(got, reference(name))
    assert (got["n_done"] > 0).all()


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("name", CASES)
def test_every_cell_matches_its_own_simulate(workload, traces, name,
                                             backend):
    """Each cell of the grid == `simulate` of that one scenario (its axis
    values as dyn scalars and traces), counts exact, rtol 1e-5."""
    cfg, axes, ci, dyn = case(name, pconfig, P, traces)
    cfg = cfg.replace(backend=backend)
    tasks, hosts = workload[1]
    res = as_numpy(P.sweep_grid(tasks, hosts, cfg, axes, ci_trace=ci,
                                dyn=dyn, device="cpu"))
    for cell in np.ndindex(*(ax.length for ax in axes)):
        one = dict(dyn or {})
        trace = ci
        for ax, i in zip(axes, cell):
            for n, v in zip(ax.names, ax.values):
                v = P.maybe_dequantize(v)[i]
                if n == "ci_trace":
                    trace = v
                else:
                    one[n] = v
        final, _ = P.simulate(tasks, hosts, trace, cfg, dyn=one,
                              device="cpu")
        want = P.result_to_numpy(P.summarize(final, cfg))
        assert_fields_match({k: v[cell] for k, v in res.items()}, want)


# ---------------------------------------------------------------------------
# execution modes: chunked, ragged, auto-chunked; reductions
# ---------------------------------------------------------------------------

def _chunk_case(C, core, traces):
    cfg = C.SimConfig(n_steps=N_STEPS, battery=C.BatteryConfig(enabled=True))
    return cfg, [core.dyn_axis(batt_capacity_kwh=np.array([1.0, 4.0, 8.0])),
                 core.trace_axis(traces)]


@functools.lru_cache(maxsize=None)
def chunk_reference(reduce=None, chunk_size=None):
    cfg, axes = _chunk_case(jconfig, J, _traces())
    return as_numpy(J.sweep_grid(*_ref_tables(), cfg, axes, reduce=reduce,
                                 chunk_size=chunk_size))


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("mode", [dict(chunk_size=1), dict(chunk_size=2),
                                  dict(chunk_size=3), dict(),
                                  dict(memory_budget_bytes=1.0)])
def test_chunked_runs_match_reference(workload, traces, mode, backend):
    """Chunks of 1 and 3 divide the leading 3; 2 leaves a ragged tail; an
    omitted chunk size runs unchunked under the default budget, and a
    1-byte budget chunks one leading point at a time."""
    cfg, axes = _chunk_case(pconfig, P, traces)
    tasks, hosts = workload[1]
    got = P.sweep_grid(tasks, hosts, cfg.replace(backend=backend), axes,
                       device="cpu", **mode)
    assert got.total_carbon_kg.shape == (3, 2)
    assert_fields_match(as_numpy(got), chunk_reference())


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("chunk", [1, 2])
@pytest.mark.parametrize("name", TASKTRACE_CASES)
def test_tasktrace_grids_chunked_match_reference(workload, traces, name,
                                                 chunk, backend):
    """A task-trace grid run a leading point (or two, with a ragged tail)
    at a time equals the reference's unchunked grid."""
    got = as_numpy(port(workload, traces, name, backend, chunk_size=chunk))
    assert_fields_match(got, reference(name))


def test_tasktrace_rows_differ_and_validate(workload, traces):
    """Each arrival set is its own outcome; the axis sorts its rows; a
    width other than the table's is the reference's ValueError; so is a
    fleet grid crossed with a task-trace axis."""
    res = reference("tasktrace")
    assert len({float(x) for x in res["mean_start_delay_h"]}) == 3
    shuffled = ARRIVALS[:, ::-1]
    ax = P.tasktrace_axis(shuffled)
    np.testing.assert_array_equal(ax.values[0].numpy(),
                                  np.sort(shuffled, axis=-1))
    np.testing.assert_array_equal(ax.values[0].numpy(),
                                  np.asarray(J.tasktrace_axis(shuffled)
                                             .values[0]))
    with pytest.raises(ValueError, match=r"f32\[A, T\]"):
        P.tasktrace_axis(ARRIVALS[0])
    (jt, jh), (tasks, hosts) = workload
    wide = make_arrival_sets(13, N_STEPS, 0.25, 2, seed=4)
    cfg = pconfig.SimConfig(n_steps=N_STEPS)
    with pytest.raises(ValueError, match="arrivals per point"):
        J.sweep_grid(jt, jh, jconfig.SimConfig(n_steps=N_STEPS),
                     [J.tasktrace_axis(wide)], ci_trace=traces[0])
    with pytest.raises(ValueError, match="arrivals per point"):
        P.sweep_grid(tasks, hosts, cfg, [P.tasktrace_axis(wide)],
                     ci_trace=traces[0], device="cpu")
    with pytest.raises(ValueError, match="tasktrace_axis re-times"):
        P.ScenarioGrid([P.tasktrace_axis(ARRIVALS),
                        P.region_axis(P.FleetSpec(ci_traces=traces))])


def test_tasktrace_rows_count_in_the_memory_estimate(workload, traces):
    """A swept arrival set makes `arrival` a row's own column; under
    priority levels every task column is."""
    tasks, hosts = workload[1]
    cfg = pconfig.SimConfig(n_steps=N_STEPS)
    t = tasks.n
    base = P.ScenarioGrid([P.trace_axis(traces)])._per_lead_bytes(
        tasks, hosts, cfg)
    tt = P.ScenarioGrid([P.tasktrace_axis(ARRIVALS[:2])])._per_lead_bytes(
        tasks, hosts, cfg)
    assert tt - base == 2 * 4 * t
    prio = cfg.replace(scheduler=pconfig.SchedulerConfig(priority_levels=2))
    tp = P.ScenarioGrid([P.tasktrace_axis(ARRIVALS[:2])])._per_lead_bytes(
        tasks, hosts, prio)
    every = sum(c.element_size() for c in tasks) * t
    written = sum(getattr(tasks, f).element_size()
                  for f in ("remaining", "status", "host", "first_start",
                            "finish")) * t
    assert tp - base == 2 * (every - written)


def test_auto_chunk_size_follows_the_budget(workload, traces):
    cfg, axes = _chunk_case(pconfig, P, traces)
    tasks, hosts = workload[1]
    grid = P.ScenarioGrid(axes)
    assert grid._auto_chunk_size(tasks, hosts, cfg, None) == 3
    assert grid._auto_chunk_size(tasks, hosts, cfg, 1.0) == 1
    per_lead = grid._per_lead_bytes(tasks, hosts, cfg)
    assert grid._auto_chunk_size(tasks, hosts, cfg, 2.5 * per_lead) == 2
    # the reference's default budget and variable
    jcfg, jaxes = _chunk_case(jconfig, J, _traces())
    jgrid = J.ScenarioGrid(jaxes)
    (jt, jh), _ = workload
    assert (grid._auto_chunk_size(tasks, hosts, cfg, None)
            == jgrid._auto_chunk_size(jt, jh, jcfg, None))


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("reduce,chunk", [
    (("min", 1), None), (("max", 1), None), (("argmin", -1), None),
    (("argmax", 1), None), (("max", 0), None), (("min", 1), 2),
    (("argmax", -1), 1)])
def test_reductions_match_reference(workload, traces, reduce, chunk,
                                    backend):
    cfg, axes = _chunk_case(pconfig, P, traces)
    tasks, hosts = workload[1]
    got = as_numpy(P.sweep_grid(tasks, hosts, cfg.replace(backend=backend),
                                axes, reduce=reduce, chunk_size=chunk,
                                device="cpu"))
    want = chunk_reference(reduce=reduce, chunk_size=chunk)
    if reduce[0].startswith("arg"):
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    else:
        assert_fields_match(got, want)


def test_reduce_over_a_chunked_leading_axis_is_refused(workload, traces):
    cfg, axes = _chunk_case(pconfig, P, traces)
    jcfg, jaxes = _chunk_case(jconfig, J, traces)
    (jt, jh), (tasks, hosts) = workload
    with pytest.raises(ValueError, match="leading axis"):
        J.sweep_grid(jt, jh, jcfg, jaxes, chunk_size=1, reduce=("min", 0))
    with pytest.raises(ValueError, match="leading axis"):
        P.sweep_grid(tasks, hosts, cfg, axes, chunk_size=1,
                     reduce=("min", 0), device="cpu")
    with pytest.raises(ValueError, match="memory budget"):
        P.sweep_grid(tasks, hosts, cfg, axes, memory_budget_bytes=1.0,
                     reduce=("max", 0), device="cpu")


# ---------------------------------------------------------------------------
# the sweep.py wrappers
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def sweep_reference(which: str):
    return as_numpy(_sweep(J, which, *_ref_tables(), _traces(), jconfig))


def _sweep(core, which, tasks, hosts, traces, C, **kw):
    cfg = C.SimConfig(n_steps=N_STEPS, battery=C.BatteryConfig(enabled=True))
    caps = np.array([2.0, 5.0, 9.0])
    if which == "regions":
        return core.sweep_regions(tasks, hosts, traces, cfg, **kw)
    if which == "battery":
        return core.sweep_battery_sizes(tasks, hosts, traces[1], caps, cfg,
                                        **kw)
    if which == "battery_rates":
        return core.sweep_battery_sizes(tasks, hosts, traces[1], caps, cfg,
                                        rates_kw=[3, 4, 12], **kw)
    return core.sweep_regions_x_battery(tasks, hosts, traces, caps, cfg,
                                        **kw)


@pytest.mark.parametrize("which", ["regions", "battery", "battery_rates",
                                   "regions_x_battery"])
def test_sweep_wrappers_match_reference(workload, traces, which):
    tasks, hosts = workload[1]
    got = as_numpy(_sweep(P, which, tasks, hosts, traces, pconfig,
                          device="cpu"))
    assert_fields_match(got, sweep_reference(which))


# ---------------------------------------------------------------------------
# validation: the reference's errors, raised by both packages
# ---------------------------------------------------------------------------

def _validation(core, C, tasks, hosts, traces, what: str):
    """Call the grid the way `what` misuses it."""
    cfg = C.SimConfig(n_steps=N_STEPS)
    two = np.ones(2)
    if what == "duplicate name":
        return core.sweep_grid(tasks, hosts, cfg, [
            core.dyn_axis(batt_capacity_kwh=two),
            core.dyn_axis(batt_capacity_kwh=np.ones(3))])
    if what == "missing trace":
        return core.sweep_grid(tasks, hosts, cfg,
                               [core.dyn_axis(batt_capacity_kwh=two)])
    if what == "trace twice":
        return core.sweep_grid(tasks, hosts, cfg, [core.trace_axis(traces)],
                               ci_trace=traces[0])
    if what == "zip lengths":
        return core.dyn_axis(batt_capacity_kwh=two, batt_rate_kw=np.ones(3))
    if what == "no names":
        return core.dyn_axis()
    if what == "no axes":
        return core.ScenarioGrid([])
    if what == "shadowed base dyn":
        return core.sweep_grid(tasks, hosts, cfg, [
            core.trace_axis(traces), core.dyn_axis(batt_capacity_kwh=two)],
            dyn={"batt_capacity_kwh": 3.0})
    if what in ("weather", "price", "renewable"):
        axis = getattr(core, f"{what}_axis")(traces)
        return core.sweep_grid(tasks, hosts, cfg, [axis], ci_trace=traces[0])
    if what == "unknown store":
        return core.trace_axis(traces, store="fp8")
    if what == "chunk size":
        return core.sweep_grid(tasks, hosts, cfg, [core.trace_axis(traces)],
                               chunk_size=0)
    if what == "executor":
        return core.sweep_grid(tasks, hosts, cfg, [core.trace_axis(traces)],
                               executor="pmap")
    if what == "reduce op":
        return core.sweep_grid(tasks, hosts, cfg, [core.trace_axis(traces)],
                               reduce=("median", 0))
    assert what == "reduce axis"
    return core.sweep_grid(tasks, hosts, cfg, [core.trace_axis(traces)],
                           reduce=("min", 2))


@pytest.mark.parametrize("what,match", [
    ("duplicate name", "declared twice"), ("missing trace", "pass ci_trace"),
    ("trace twice", "trace_axis"), ("zip lengths", "disagree on length"),
    ("no names", "at least one"), ("no axes", "at least one axis"),
    ("shadowed base dyn", "shadow"), ("weather", "cooling.enabled"),
    ("price", "pricing.enabled"), ("renewable", "renewables.enabled"),
    ("unknown store", "unknown trace store"), ("chunk size", "chunk_size"),
    ("executor", "unknown executor"), ("reduce op", "unknown reduce op"),
    ("reduce axis", "out of range")])
def test_validation_errors_match_reference(workload, traces, what, match):
    (jt, jh), (tasks, hosts) = workload
    with pytest.raises(ValueError, match=match):
        _validation(J, jconfig, jt, jh, traces, what)
    with pytest.raises(ValueError, match=match):
        _validation(P, pconfig, tasks, hosts, traces, what)


def test_trace_axes_want_rows_of_series(traces):
    """The reference asserts [L, S] traces; the port raises ValueError."""
    for name in ("trace_axis", "weather_axis", "price_axis",
                 "renewable_axis"):
        with pytest.raises(AssertionError):
            getattr(J, name)(traces[0])
        with pytest.raises(ValueError, match=r"\[L, S\]"):
            getattr(P, name)(traces[0])


# ---------------------------------------------------------------------------
# what the port refuses, naming the ROADMAP item that brings it
# ---------------------------------------------------------------------------

def _fleet_grid(a):
    """A fleet grid (a swept axis and a region axis) of the workload."""
    return P.ScenarioGrid([P.dyn_axis(batt_capacity_kwh=np.ones(2)),
                           P.region_axis(P.FleetSpec(ci_traces=a[3]))])


@pytest.mark.parametrize("call,item", [
    (lambda g, a: _fleet_grid(a).run(*a[:3], mesh=object(), device="cpu"),
     "item 6f"),
    (lambda g, a: _fleet_grid(a).run_shard_map(*a[:3]), "item 6f"),
    (lambda g, a: g.run(*a, mesh=object(), device="cpu"), "item 6f"),
    (lambda g, a: P.sweep_grid(*a[:3], g.axes, executor="shard_map",
                               device="cpu"), "item 6f"),
    (lambda g, a: g.run_shard_map(*a), "item 6f"),
    (lambda g, a: g.shard_map_callable(*a), "item 6f"),
    (lambda g, a: g.lower(*a), "item 6f"),
    (lambda g, a: P.sharded_sweep(None, *a[:2], a[3], a[2]), "item 6f"),
    (lambda g, a: P.lower_sweep(None, *a[:3], 4, N_STEPS), "item 6f"),
    (lambda g, a: P.sweep_step_fn(*a[:3]), "item 6f"),
])
def test_unported_grid_parts_raise(workload, traces, call, item):
    tasks, hosts = workload[1]
    grid = P.ScenarioGrid([P.trace_axis(traces)])
    args = (tasks, hosts, pconfig.SimConfig(n_steps=N_STEPS), traces)
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        call(grid, args)


def test_engine_refusals_hold_per_grid(workload, traces):
    """What the engine refuses it refuses per grid too: the resilience
    loop's dyn keys while the loop is off (the reference's ValueError).
    The probe bus, once refused, runs per grid: a ring a cell."""
    tasks, hosts = workload[1]
    with pytest.raises(ValueError, match="resilience"):
        P.sweep_grid(tasks, hosts, pconfig.SimConfig(n_steps=N_STEPS),
                     [P.dyn_axis(failure_hazard_scale=np.array([0.5, 1.0]))],
                     ci_trace=traces[0], device="cpu")
    res = P.sweep_grid(tasks, hosts, pconfig.SimConfig(
        n_steps=N_STEPS, probes=pconfig.ProbeConfig(enabled=True)),
        [P.trace_axis(traces)], device="cpu")
    assert res.probes.step.shape == (len(traces), N_STEPS)


# ---------------------------------------------------------------------------
# the kernels' plain versions on scenario rows
# ---------------------------------------------------------------------------

def test_plain_facility_totals_take_rows(traces):
    """The megakernel's facility half on [B, S] rows with [B] parameters
    (the grid's CPU path, and kernel 3's oracle at grid shapes) == each row
    alone with scalar parameters, bit for bit."""
    from repro_torch.kernels import ref
    cfg = pconfig.SimConfig(
        n_steps=N_STEPS, cooling=pconfig.CoolingConfig(enabled=True),
        pricing=pconfig.PricingConfig(enabled=True, billing_window_h=12.0),
        renewables=pconfig.RenewableConfig(enabled=True),
        battery=pconfig.BatteryConfig(enabled=True, policy="blended",
                                      price_window_h=24.0))
    rows = {"soc0": [0.0, 3.0, 1.0], "setpoint_c": [18.0, 22.0, 26.0],
            "batt_capacity_kwh": [4.0, 6.0, 60.0],
            "batt_rate_kw": [2.0, 12.0, 30.0],
            "dispatch_lambda": [0.0, 0.5, 1.0],
            "pv_capacity_kw": [0.0, 10.0, 40.0]}
    rng = np.random.default_rng(3)
    it_kw = torch.tensor(rng.uniform(5.0, 30.0, (3, N_STEPS)),
                         dtype=torch.float32)
    ci = torch.tensor(np.concatenate([traces, traces[:1] * 0.7]))
    x = P.build_step_inputs(ci, cfg, {"price_trace": PRICES[0],
                                      "wet_bulb_trace": WB[0],
                                      "pv_cf_trace": PV[0]}, device="cpu")
    series = (x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi, x.pv_cf,
              x.batt_threshold, x.ci_rising)
    got = ref.fused_facility_totals(
        it_kw, *series, cfg,
        **{k: torch.tensor(v, dtype=torch.float32) for k, v in rows.items()})
    for r in range(3):
        one = ref.fused_facility_totals(
            it_kw[r], *(s.expand(3, -1)[r] for s in series), cfg,
            **{k: np.float32(v[r]) for k, v in rows.items()})
        for k, v in one.items():
            assert got[k].shape == (3,), k
            assert torch.equal(got[k][r], v), (k, r)
