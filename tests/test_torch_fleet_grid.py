"""The PyTorch port's fleet grids and cross-region spill against the
reference package, on the CPU.

A fleet grid (`region_axis`, `fleet_axis`) runs each grid point's R regions
as R consecutive scenario rows of one step loop; the reference nests
`jax.vmap`s.  The acceptance grid of the reference's tests/test_fleet.py
(spatial shifting x per-region host counts x battery sizes, 3 regions)
goes through both packages, plain, chunked and reduced, and through a loop
of the port's own `simulate_fleet`; counts exact, every other field within
rtol 1e-5, atol 1e-6.  The coupled fleet (`spill_interrupted`) moves
interrupted tasks between regions after each step; it is held to the
reference's spill executor with its counts and spills exact.
"""
from __future__ import annotations

import dataclasses
import functools

import jax  # noqa: F401  (the reference runs on JAX's CPU backend)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro.tasktraces.synthetic import make_arrival_sets

torch.set_num_threads(1)

N_STEPS = 96
COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "n_interrupts", "n_spills", "class_n_violations",
                "class_n_decided", "class_n_started")
COUNTS = np.array([[4, 4, 4], [2, 4, 3], [1, 2, 4]], np.int32)
CAPS = np.array([2.0, 6.0], np.float32)


def _np_table(t) -> dict:
    return {k: np.asarray(v) for k, v in t._asdict().items()}


def _ref_workload():
    rng = np.random.default_rng(7)
    n = 40
    tasks = J.make_task_table(np.sort(rng.uniform(0.0, 8.0, n)),
                              rng.uniform(0.5, 4.0, n),
                              rng.integers(1, 3, n).astype(float))
    return tasks, J.make_host_table(4, 4)


@pytest.fixture(scope="module")
def workload():
    jt, jh = _ref_workload()
    return (jt, jh), P.tables_from_numpy(_np_table(jt), _np_table(jh),
                                         device="cpu")


def _series(base, amp, phases):
    t = np.arange(N_STEPS) * 0.25
    return np.stack([base + amp * np.sin(2 * np.pi * t / 24.0 + p)
                     for p in phases]).astype(np.float32)


TRACES = _series(300.0, 200.0, (0.0, 1.7, 3.1))
WB = _series(15.0, 8.0, (0.3, 2.0, 4.0))


def as_numpy(res) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in res._asdict().items() if v is not None}


def assert_fields_match(got, want, idx=(), rtol=1e-5, atol=1e-6):
    """Counts exact, every other field within rtol / atol; `idx` picks a
    cell of `want`."""
    got, want = as_numpy(got), as_numpy(want)
    assert set(got) == set(want)
    for k, v in want.items():
        g, w = np.asarray(got[k], np.float64), np.asarray(v, np.float64)[idx]
        assert g.shape == w.shape, k
        if k in COUNT_FIELDS:
            np.testing.assert_array_equal(g, w, err_msg=f"count {k}")
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)


def _grid(C, core):
    """(cfg, fleet, axes) of the acceptance grid in either package."""
    cfg = C.SimConfig(n_steps=N_STEPS, battery=C.BatteryConfig(enabled=True),
                      cooling=C.CoolingConfig(enabled=True))
    fleet = core.FleetSpec(ci_traces=TRACES, wb_traces=WB, capacity_frac=1.5)
    return cfg, fleet, [core.fleet_axis(n_active_hosts=COUNTS),
                        core.dyn_axis(batt_capacity_kwh=CAPS),
                        core.region_axis(fleet)]


@functools.lru_cache(maxsize=None)
def _reference_grid(backend: str, reduce=None):
    cfg, _, axes = _grid(jconfig, J)
    return J.sweep_grid(*_ref_workload(), cfg.replace(backend=backend), axes,
                        reduce=reduce)


def _port_grid(workload, backend, **kw):
    cfg, _, axes = _grid(pconfig, P)
    return P.sweep_grid(*workload[1], cfg.replace(backend=backend), axes,
                        device="cpu", **kw)


# ---------------------------------------------------------------------------
# the acceptance grid: reference, chunks, reduce, the simulate_fleet loop
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("chunk", [None, 1, 2])
def test_fleet_grid_matches_reference(workload, backend, chunk):
    """Plain and chunked (a point or two of the leading axis a step loop,
    a ragged tail) equal the reference's grid: totals [K, C], per-region
    fields [K, C, R]."""
    got = _port_grid(workload, backend, chunk_size=chunk)
    want = _reference_grid(backend)
    assert got.total.total_carbon_kg.shape == (3, 2)
    assert got.per_region.total_carbon_kg.shape == (3, 2, 3)
    assert got.per_region.class_n_decided.shape == (3, 2, 3, 3)
    assert_fields_match(got.total, want.total)
    assert_fields_match(got.per_region, want.per_region)


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("op", ["min", "argmin"])
def test_fleet_grid_reduce_matches_reference(workload, backend, op):
    """`reduce` folds the total and every region's fields over a grid
    axis, as the reference's tree map does."""
    got = _port_grid(workload, backend, reduce=(op, 1))
    want = _reference_grid(backend, reduce=(op, 1))
    assert got.total.total_carbon_kg.shape == (3,)
    assert got.per_region.total_carbon_kg.shape == (3, 3)
    if op == "argmin":
        for part in ("total", "per_region"):
            for k, v in as_numpy(getattr(want, part)).items():
                np.testing.assert_array_equal(
                    getattr(getattr(got, part), k).numpy(), v, err_msg=k)
        return
    assert_fields_match(got.total, want.total)
    assert_fields_match(got.per_region, want.per_region)


@pytest.mark.parametrize("backend", P.BACKENDS)
def test_fleet_grid_matches_simulate_fleet_loop(workload, backend):
    """Every cell equals the port's `simulate_fleet` with that cell's
    per-region host counts and battery."""
    cfg, fleet, _ = _grid(pconfig, P)
    cfg = cfg.replace(backend=backend)
    full = _port_grid(workload, backend)
    for k in range(3):
        for c in range(2):
            one = P.simulate_fleet(*workload[1], cfg, fleet, dyn={
                "n_active_hosts": COUNTS[k], "batt_capacity_kwh": CAPS[c]},
                device="cpu")
            assert_fields_match(one.total, full.total, idx=(k, c))
            assert_fields_match(one.per_region, full.per_region, idx=(k, c))


@pytest.mark.parametrize("backend", P.BACKENDS)
def test_region_only_grid_equals_simulate_fleet(workload, backend):
    """A lone region axis: nothing swept, one fleet, the result's totals
    0-d and its per-region fields [R]."""
    cfg = pconfig.SimConfig(n_steps=N_STEPS, backend=backend)
    fleet = P.FleetSpec(ci_traces=TRACES)
    solo = P.sweep_grid(*workload[1], cfg, [P.region_axis(fleet)],
                        device="cpu")
    base = P.simulate_fleet(*workload[1], cfg, fleet, device="cpu")
    assert solo.total.n_done.shape == () and solo.per_region.n_done.shape \
        == (3,)
    assert_fields_match(solo.total, base.total)
    assert_fields_match(solo.per_region, base.per_region)
    grid = P.ScenarioGrid([P.region_axis(fleet)])
    assert grid.shape == () and grid.n_scenarios == 1


@pytest.mark.parametrize("backend", P.BACKENDS)
def test_seed_axis_composes_with_fleet(workload, backend):
    """Host failures across a fleet grid: seed axis x fleet, against the
    reference's grid and the port's own `simulate_fleet` a seed."""
    (jt, jh), (pt, ph) = workload
    seeds = [0, 3]
    want = J.sweep_grid(jt, jh, jconfig.SimConfig(
        n_steps=N_STEPS, backend=backend,
        failures=jconfig.FailureConfig(enabled=True, mtbf_h=30.0)),
        [J.seed_axis(seeds), J.region_axis(J.FleetSpec(ci_traces=TRACES))])
    cfg = pconfig.SimConfig(n_steps=N_STEPS, backend=backend,
                            failures=pconfig.FailureConfig(enabled=True,
                                                           mtbf_h=30.0))
    fleet = P.FleetSpec(ci_traces=TRACES)
    got = P.sweep_grid(pt, ph, cfg, [P.seed_axis(seeds), P.region_axis(fleet)],
                       device="cpu")
    assert_fields_match(got.total, want.total)
    assert_fields_match(got.per_region, want.per_region)
    for j, s in enumerate(seeds):
        one = P.simulate_fleet(pt, ph, cfg, fleet, dyn={"seed": s},
                               device="cpu")
        assert_fields_match(one.total, got.total, idx=(j,))
    per = got.per_region.n_interrupts.numpy()
    assert not np.array_equal(per[0], per[1])


def test_fleet_grid_base_dyn_and_spec_values(workload):
    """Base dyn values hold for every row (a length-R one region by
    region), and the spec's per-region values win over a swept dyn value,
    as in `simulate_fleet`."""
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS,
                            battery=pconfig.BatteryConfig(enabled=True))
    fleet = P.FleetSpec(ci_traces=TRACES, batt_capacity_kwh=[1.0, 4.0, 9.0])
    got = P.sweep_grid(pt, ph, cfg, [
        P.dyn_axis(batt_capacity_kwh=CAPS, batt_rate_kw=CAPS),
        P.region_axis(fleet)], dyn={"n_active_hosts": np.array([3, 2, 4])},
        device="cpu")
    for c in range(2):
        one = P.simulate_fleet(pt, ph, cfg, fleet, dyn={
            "n_active_hosts": np.array([3, 2, 4]),
            "batt_rate_kw": CAPS[c]}, device="cpu")
        assert_fields_match(one.per_region, got.per_region, idx=(c,))


def test_fleet_rows_count_in_the_memory_estimate(workload):
    """A fleet grid's point is R rows, each holding every task column of
    its own [W] table."""
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS)
    fleet = P.FleetSpec(ci_traces=TRACES)
    stacked = P.split_by_region(pt, np.zeros(40, np.int32), 3, device="cpu")
    plain = P.ScenarioGrid([P.trace_axis(TRACES)])
    grid = P.ScenarioGrid([P.dyn_axis(batt_capacity_kwh=CAPS),
                           P.region_axis(fleet)])
    every = sum(c.element_size() for c in stacked)
    written = sum(getattr(stacked, f).element_size()
                  for f in P.state.WRITTEN_TASK_COLUMNS)
    per_row = plain._per_lead_bytes(stacked, ph, cfg)
    assert grid._per_lead_bytes(stacked, ph, cfg) == pytest.approx(
        3 * (per_row + 2 * (every - written) * 40))


# ---------------------------------------------------------------------------
# validation: the reference's refusals, and what stays unported
# ---------------------------------------------------------------------------

def _axes(core, what):
    fleet = core.FleetSpec(ci_traces=TRACES)
    dyn = core.dyn_axis(batt_capacity_kwh=np.ones(2))
    if what == "fleet_axis without region_axis":
        return [core.fleet_axis(n_active_hosts=np.ones((2, 3), np.int32))]
    if what == "region_axis leading":
        return [core.region_axis(fleet), dyn]
    if what == "region_axis beside trace_axis":
        return [dyn, core.trace_axis(TRACES), core.region_axis(fleet)]
    if what == "region_axis beside weather_axis":
        return [core.weather_axis(WB), core.region_axis(fleet)]
    if what == "region_axis beside tasktrace_axis":
        return [core.tasktrace_axis(make_arrival_sets(40, N_STEPS, 0.25, 2,
                                                      seed=4)),
                core.region_axis(fleet)]
    if what == "two region axes":
        return [dyn, core.region_axis(fleet), core.region_axis(fleet)]
    return [core.fleet_axis(n_active_hosts=np.ones((2, 4), np.int32)),
            core.region_axis(fleet)]


@pytest.mark.parametrize("what", [
    "fleet_axis without region_axis", "region_axis leading",
    "region_axis beside trace_axis", "region_axis beside weather_axis",
    "region_axis beside tasktrace_axis", "two region axes",
    "fleet_axis region count"])
def test_fleet_grid_validation(what):
    """The reference's `ScenarioGrid` refusals, with its messages."""
    with pytest.raises(ValueError) as want:
        J.ScenarioGrid(_axes(J, what))
    with pytest.raises(ValueError) as got:
        P.ScenarioGrid(_axes(P, what))
    assert str(got.value) == str(want.value)


def test_fleet_axis_values_validation():
    for core in (J, P):
        with pytest.raises(ValueError, match=r"\[K, R\]"):
            core.fleet_axis(n_active_hosts=np.ones(3))
        with pytest.raises(ValueError, match="disagree on length"):
            core.fleet_axis(n_active_hosts=np.ones((2, 3)),
                            batt_capacity_kwh=np.ones((3, 3)))
        with pytest.raises(ValueError, match="at least one"):
            core.fleet_axis()


def test_fleet_grid_checks_cfg_and_trace(workload):
    """Per-region weather without cooling is the reference's ValueError; a
    fleet grid takes no `ci_trace`."""
    (jt, jh), (pt, ph) = workload
    for core, C, (tasks, hosts), kw in ((J, jconfig, (jt, jh), {}),
                                        (P, pconfig, (pt, ph),
                                         {"device": "cpu"})):
        fleet = core.FleetSpec(ci_traces=TRACES, wb_traces=WB)
        axes = [core.dyn_axis(batt_capacity_kwh=np.ones(2)),
                core.region_axis(fleet)]
        with pytest.raises(ValueError, match="cooling.enabled"):
            core.sweep_grid(tasks, hosts, C.SimConfig(n_steps=N_STEPS), axes,
                            **kw)
        with pytest.raises(ValueError, match="drop the ci_trace"):
            core.sweep_grid(tasks, hosts, C.SimConfig(
                n_steps=N_STEPS, cooling=C.CoolingConfig(enabled=True)),
                axes, ci_trace=TRACES[0], **kw)


def test_fleet_grid_mesh_refusals(workload, tmp_path):
    """`mesh=` on a lone region axis is the reference's ValueError; a fleet
    grid with a swept axis runs on a mesh (here a gloo world of one, in a
    process of its own) and equals the unsharded fleet grid bit for bit."""
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS)
    fleet = P.FleetSpec(ci_traces=TRACES)
    with pytest.raises(ValueError, match="only axis is the region_axis"):
        P.sweep_grid(pt, ph, cfg, [P.region_axis(fleet)], mesh=object(),
                     device="cpu")
    want = P.sweep_grid(pt, ph, cfg, [P.dyn_axis(batt_capacity_kwh=CAPS),
                                      P.region_axis(fleet)], device="cpu")
    torch.save({"tables": (pt, ph), "want": want}, tmp_path / "in.pt")
    script = f"""
import torch, numpy as np
import repro_torch.core as P, repro_torch.core.config as C
from repro_torch.launch import mesh as M
torch.set_num_threads(1)
d = torch.load({str(tmp_path / "in.pt")!r}, weights_only=False)
M.init_distributed("cpu", store_dir={str(tmp_path / "pg")!r})
mesh = M.make_test_mesh(data=1, model=1, device_type="cpu")
traces = np.asarray({TRACES.tolist()!r}, np.float32)
got = P.sweep_grid(*d["tables"], C.SimConfig(n_steps={N_STEPS}),
                   [P.dyn_axis(batt_capacity_kwh=np.asarray({CAPS.tolist()!r},
                                                            np.float32)),
                    P.region_axis(P.FleetSpec(ci_traces=traces))],
                   mesh=mesh, device="cpu")
for part in ("total", "per_region"):
    g, w = getattr(got, part), getattr(d["want"], part)
    for k, v in w._asdict().items():
        if v is not None:
            assert torch.equal(getattr(g, k), v), (part, k)
M.shutdown()
print("ok")
"""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=240,
                         env=dict(os.environ, PYTHONPATH=src))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), \
        out.stderr[-3000:]


# ---------------------------------------------------------------------------
# the coupled fleet: cross-region spill after every step
# ---------------------------------------------------------------------------

def _spill_case(C, core, failures: bool, spill: bool = True):
    """(cfg, fleet, dyn) of a fleet whose regions lose hosts for good (6 h
    MTBF, no repair) with one seed a region; facility failures off."""
    cfg = C.SimConfig(n_steps=N_STEPS, resilience=C.ResilienceConfig(
        enabled=True, chiller_mtbf_h=1e12, pdu_mtbf_h=1e12, pdu_cap_kw=2.0,
        spill_interrupted=spill))
    if failures:
        cfg = cfg.replace(failures=C.FailureConfig(enabled=True, mtbf_h=6.0,
                                                   repair_h=1e6))
    return (cfg, core.FleetSpec(ci_traces=TRACES, capacity_frac=1.0),
            {"seed": np.asarray([1, 2, 3])})


@functools.lru_cache(maxsize=None)
def _reference_spill(failures: bool, spill: bool = True):
    cfg, fleet, dyn = _spill_case(jconfig, J, failures, spill)
    jt, jh = _ref_workload()
    return J.simulate_fleet(jt, jh, cfg, fleet, dyn=dyn,
                            width=None if spill else jt.n)


def test_spill_without_failures_is_the_plain_fleet(workload):
    """With no host failing the spill moves nothing: the coupled loop
    equals the plain fleet at full width (and the reference's)."""
    (_, _), (pt, ph) = workload
    cfg, fleet, dyn = _spill_case(pconfig, P, failures=False)
    out_s = P.simulate_fleet(pt, ph, cfg, fleet, dyn=dyn, device="cpu")
    plain = cfg.replace(resilience=dataclasses.replace(
        cfg.resilience, spill_interrupted=False))
    out_p = P.simulate_fleet(pt, ph, plain, fleet, dyn=dyn, width=pt.n,
                             device="cpu")
    assert float(out_s.total.n_spills) == 0.0
    assert_fields_match(out_s.total, out_p.total, rtol=1e-6)
    assert_fields_match(out_s.per_region, out_p.per_region, rtol=1e-6)
    assert_fields_match(out_s.per_region, _reference_spill(False).per_region)


def test_spill_under_failures_matches_reference(workload):
    """Under failures tasks spill (per region, the reference's count) and
    every region's counts and interrupts are the reference's; the spill
    changes the outcome against the same fleet uncoupled."""
    (_, _), (pt, ph) = workload
    cfg, fleet, dyn = _spill_case(pconfig, P, failures=True)
    got = P.simulate_fleet(pt, ph, cfg, fleet, dyn=dyn, device="cpu")
    want = _reference_spill(True)
    assert float(got.total.n_spills) > 0
    assert_fields_match(got.total, want.total)
    assert_fields_match(got.per_region, want.per_region)
    cfg_p, _, _ = _spill_case(pconfig, P, failures=True, spill=False)
    plain = P.simulate_fleet(pt, ph, cfg_p, fleet, dyn=dyn, width=pt.n,
                             device="cpu")
    want_plain = _reference_spill(True, spill=False)
    assert_fields_match(plain.per_region, want_plain.per_region)
    assert not np.array_equal(plain.per_region.n_done.numpy(),
                              got.per_region.n_done.numpy())


def test_spill_loop_is_the_stage_pipeline_step(workload):
    """`prepare_spill` + `spill_loop` (what `simulate_fleet` runs) leave
    the rows in arrival order under priority levels, as the reference's
    coupled executor does."""
    (jt, jh), (pt, ph) = workload
    out = []
    for C, core, tasks, hosts, kw in ((jconfig, J, jt, jh, {}),
                                      (pconfig, P, pt, ph,
                                       {"device": "cpu"})):
        cfg, fleet, dyn = _spill_case(C, core, failures=True)
        cfg = cfg.replace(scheduler=C.SchedulerConfig(priority_levels=3))
        out.append(core.simulate_fleet(tasks, hosts, cfg, fleet, dyn=dyn,
                                       **kw))
    assert_fields_match(out[1].per_region, out[0].per_region)


@pytest.mark.parametrize("backend", P.BACKENDS)
def test_shared_host_order_on_per_row_columns(workload, backend):
    """Reactive placement without host failures: the host order is one
    shared [1, H] row while the free capacities are a row's own [B, H]
    (a grid's rows, a fleet's regions); the scheduler reads each row's
    capacities in the shared order, as the reference does."""
    (jt, jh), (pt, ph) = workload
    res = dict(enabled=True, reactive_placement=True, chiller_mtbf_h=30.0,
               pdu_mtbf_h=40.0, pdu_cap_kw=3.0)
    want = J.sweep_grid(jt, jh, jconfig.SimConfig(
        n_steps=N_STEPS, backend=backend,
        resilience=jconfig.ResilienceConfig(**res)),
        [J.dyn_axis(throttle_inlet_c=np.array([20.0, 30.0]))],
        ci_trace=TRACES[0])
    got = P.sweep_grid(pt, ph, pconfig.SimConfig(
        n_steps=N_STEPS, backend=backend,
        resilience=pconfig.ResilienceConfig(**res)),
        [P.dyn_axis(throttle_inlet_c=np.array([20.0, 30.0]))],
        ci_trace=TRACES[0], device="cpu")
    assert_fields_match(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("max_spills", [1, 3, 8])
@pytest.mark.parametrize("p_invalid", [0.2, 0.5])
def test_cross_region_spill_matches_reference_on_random_tables(
        seed, max_spills, p_invalid):
    """The spill's moves made at once equal the reference's one at a time,
    bit for bit, on random [R, W] tables: candidates in several regions,
    fewer free slots in the target than candidates or more, ties in
    health, and [R] or [R, 1] counters."""
    from repro.core import resilience as jres
    from repro.core import state as jstate
    rng = np.random.default_rng(seed)
    r, w, h = 4, 9, 5
    p_rest = (1.0 - p_invalid) / 4
    status = rng.choice([0, 1, 2, 3], size=(r, w),
                        p=[2 * p_rest, p_rest, p_rest, p_invalid])
    first = np.where(rng.uniform(size=(r, w)) < 0.6,
                     rng.uniform(0, 5, (r, w)), np.inf)
    up = rng.uniform(size=(r, h)) < 0.7
    active = rng.uniform(size=(r, h)) < 0.9
    cols = {f: rng.uniform(0, 4, (r, w)).astype(np.float32)
            for f in J.TaskTable._fields}
    cols.update(status=status.astype(np.int32),
                first_start=first.astype(np.float32),
                host=rng.integers(-1, h, (r, w)).astype(np.int32),
                job_class=rng.integers(0, 3, (r, w)).astype(np.int32),
                priority=rng.integers(0, 3, (r, w)).astype(np.int32),
                shiftable=rng.uniform(size=(r, w)) < 0.5)
    hcols = {f: np.ones((r, h), np.float32) for f in J.HostTable._fields}
    hcols.update(active=active, up=up)
    jt = J.TaskTable(**{k: jnp.asarray(v) for k, v in cols.items()})
    jh = J.HostTable(**{k: jnp.asarray(v) for k, v in hcols.items()})
    jm = jstate.init_metrics()._replace(n_spills=jnp.asarray(
        np.zeros(r, np.float32)))
    want_t, want_m = jres.cross_region_spill(jt, jh, jm, max_spills)
    pt, ph = P.tables_from_numpy(cols, hcols, device="cpu")
    for shape in ((r,), (r, 1)):
        pm = P.state.init_metrics("cpu", shape)
        got_t, got_m = P.cross_region_spill(pt, ph, pm, max_spills)
        for f in J.TaskTable._fields:
            np.testing.assert_array_equal(getattr(got_t, f).numpy(),
                                          np.asarray(getattr(want_t, f)),
                                          err_msg=f)
        np.testing.assert_array_equal(got_m.n_spills.numpy().reshape(r),
                                      np.asarray(want_m.n_spills))
    health = (active & up).sum(1) / np.maximum(active.sum(1), 1)
    target = int(np.argmax(health))
    n_cand = int(((status == 0) & np.isfinite(first)
                  & (health < health[target])[:, None]).sum())
    n_free = int((status[target] == 3).sum())
    assert float(got_m.n_spills.sum()) == min(max_spills, n_cand, n_free)
