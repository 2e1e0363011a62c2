"""The PyTorch port's fleet engine and spatial placement against the
reference package, on the CPU.

The same tables and traces go through `repro.core` (JAX) and
`repro_torch.core` (the port).  Placement is the reference's numpy
arithmetic, so region ids are bit-equal for every policy; a fleet is one
`engine.run_cells` call with a region a scenario row, held to the
reference's `simulate_fleet` (counts exact, every other field within rtol
1e-5, atol 1e-6, the reference's own fleet-grid tolerance), and a fleet of
one region equals the port's own `simulate` bit for bit.  The workload is
that of the reference's tests/test_fleet.py: 40 tasks, 4 hosts, 96 steps,
3 regions.  Fleet grids and the cross-region spill are in
tests/test_torch_fleet_grid.py.
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
from repro.core.fleet import fleet_place as j_fleet_place
from repro_torch.core.fleet import fleet_place as p_fleet_place

torch.set_num_threads(1)

N_STEPS = 96
COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "n_interrupts", "n_spills", "class_n_violations",
                "class_n_decided", "class_n_started")


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
    """(reference tables, port tables) of tests/test_fleet.py's workload."""
    jt, jh = _ref_workload()
    return (jt, jh), P.tables_from_numpy(_np_table(jt), _np_table(jh),
                                         device="cpu")


def _traces():
    t = np.arange(N_STEPS) * 0.25
    return np.stack([300.0 + 200.0 * np.sin(2 * np.pi * t / 24.0 + p)
                     for p in (0.0, 1.7, 3.1)]).astype(np.float32)


def _wb_traces():
    t = np.arange(N_STEPS) * 0.25
    return np.stack([15.0 + 8.0 * np.sin(2 * np.pi * t / 24.0 + p)
                     for p in (0.3, 2.0, 4.0)]).astype(np.float32)


TRACES = _traces()
WB = _wb_traces()


def as_numpy(res) -> dict:
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in res._asdict().items() if v is not None}


def assert_fields_match(got, want, rtol=1e-5, atol=1e-6):
    """Counts exact, every other field within rtol / atol."""
    got, want = as_numpy(got), as_numpy(want)
    assert set(got) == set(want)
    for k, v in want.items():
        g = np.asarray(got[k], np.float64)
        assert g.shape == np.shape(v), k
        if k in COUNT_FIELDS:
            np.testing.assert_array_equal(g, v, err_msg=f"count {k}")
        else:
            np.testing.assert_allclose(g, np.asarray(v, np.float64),
                                       rtol=rtol, atol=atol, err_msg=k)


def assert_bitwise(got, want):
    got, want = as_numpy(got), as_numpy(want)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


def _placement_tasks(seed: int, n: int = 200):
    """(reference table, port table) of the reference's placement tier."""
    rng = np.random.default_rng(seed)
    jt = J.make_task_table(np.sort(rng.uniform(0.0, 20.0, n)),
                           rng.uniform(0.25, 6.0, n),
                           rng.integers(1, 5, n).astype(float))
    pt, _ = P.tables_from_numpy(_np_table(jt), _np_table(J.make_host_table(
        1, 1)), device="cpu")
    return jt, pt


# ---------------------------------------------------------------------------
# placement: region ids bit-equal to the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("capped", [False, True])
def test_greedy_placement_bit_equal(seed, capped):
    """`spatial_assign` and the sequential spec give the reference's ids,
    capped (tight caps, so the least-loaded fallback runs) and not."""
    jt, pt = _placement_tasks(seed)
    cap = None
    if capped:
        total = float(np.sum(np.asarray(jt.cores) * np.asarray(jt.duration)))
        cap = total * np.array([0.15, 0.3, 0.2])
    want = J.spatial_assign(jt, TRACES, 0.25, capacity_core_h=cap)
    np.testing.assert_array_equal(
        J.spatial_assign_reference(jt, TRACES, 0.25, capacity_core_h=cap),
        want)
    got = P.spatial_assign(pt, TRACES, 0.25, capacity_core_h=cap)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        P.spatial_assign_reference(pt, TRACES, 0.25, capacity_core_h=cap),
        want)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_online_placement_bit_equal(seed):
    """The online router (`spill` policy) gives the reference's ids, with
    caps that saturate (spills and the least-overflow fallback)."""
    jt, pt = _placement_tasks(seed)
    for cap in ([4.0, 4.0, 4.0], [6.0, 2.0, 9.0], [40.0, 40.0, 40.0]):
        want = J.spatial_assign_online(jt, TRACES, 0.25,
                                       capacity_cores=np.array(cap),
                                       n_steps=N_STEPS)
        got = P.spatial_assign_online(pt, TRACES, 0.25,
                                      capacity_cores=np.array(cap),
                                      n_steps=N_STEPS)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("policy", ["greedy", "spill", "round_robin"])
def test_fleet_place_bit_equal(workload, policy):
    """Every policy through `fleet_place`, with per-region host counts and
    a core-hour cap (greedy), on the workload's tables."""
    (jt, jh), (pt, ph) = workload
    kw = dict(ci_traces=TRACES, capacity_frac=1.2, policy=policy,
              n_active_hosts=[4, 2, 3])
    want = j_fleet_place(jt, jh, J.FleetSpec(**kw), 0.25, n_steps=N_STEPS)
    got = p_fleet_place(pt, ph, P.FleetSpec(**kw), 0.25, n_steps=N_STEPS)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        P.FleetSpec(**kw).capacity_core_h(pt, ph),
        J.FleetSpec(**kw).capacity_core_h(jt, jh))
    np.testing.assert_array_equal(P.FleetSpec(**kw).region_cores(ph),
                                  J.FleetSpec(**kw).region_cores(jh))


def test_torch_backend_matches_numpy(workload):
    """`backend='torch'` is the reference's device argmin (`'jax'`, which
    the port refuses naming its counterpart)."""
    (jt, _), (pt, _) = workload
    want = J.spatial_assign(jt, TRACES, 0.25, backend="jax")
    got = P.spatial_assign(pt, TRACES, 0.25, backend="torch", device="cpu")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, P.spatial_assign(pt, TRACES, 0.25, backend="numpy"))
    with pytest.raises(ValueError, match="'torch'"):
        P.spatial_assign(pt, TRACES, 0.25, backend="jax")


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_padding_rows_unassigned(backend):
    tasks = P.pad_task_table(P.make_task_table([0.0, 1.0], [2.0, 2.0],
                                               [1.0, 1.0], device="cpu"), 6)
    region = P.spatial_assign(tasks, TRACES, 0.25, backend=backend,
                              device="cpu")
    assert (region[2:] == -1).all() and (region[:2] >= 0).all()
    online = P.spatial_assign_online(tasks, TRACES, 0.25,
                                     capacity_cores=np.array([4.0] * 3))
    assert (online[2:] == -1).all() and (online[:2] >= 0).all()


def test_split_by_region_field_by_field():
    """The stacked [R, W] tables equal the reference's column by column,
    class columns included, at the default width and at the table's."""
    rng = np.random.default_rng(3)
    n = 30
    cols = (np.sort(rng.uniform(0.0, 8.0, n)), rng.uniform(0.5, 4.0, n),
            rng.integers(1, 3, n).astype(float),
            rng.integers(0, 2, n).astype(float), rng.uniform(0.3, 0.9, n),
            rng.uniform(0.2, 0.8, n))
    cls = dict(job_class=rng.integers(0, 3, n),
               priority=rng.integers(0, 3, n),
               shiftable=rng.uniform(size=n) < 0.5,
               sla_grace=np.where(rng.uniform(size=n) < 0.5, 2.0, -1.0))
    jt = J.make_task_table(*cols, **cls)
    pt = P.make_task_table(*cols, **cls, device="cpu")
    region = np.where(rng.uniform(size=n) < 0.1, -1,
                      rng.integers(0, 4, n)).astype(np.int32)
    region[region == 2] = 1          # region 2 empty
    for width in (None, n):
        want = J.split_by_region(jt, region, 4, width=width)
        got = P.split_by_region(pt, region, 4, width=width, device="cpu")
        assert got.arrival.shape == np.asarray(want.arrival).shape
        for f in want._fields:
            g, w = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert g.dtype == w.dtype, f
            np.testing.assert_array_equal(g, w, err_msg=f)
    with pytest.raises(ValueError, match="largest region"):
        P.split_by_region(pt, region, 4, width=2, device="cpu")


# ---------------------------------------------------------------------------
# fleet_totals
# ---------------------------------------------------------------------------

def test_fleet_totals_matches_reference_on_same_inputs():
    """The same per-region SimResult (random fields, [R] and class [R, C],
    an empty region) through both packages' `fleet_totals`."""
    rng = np.random.default_rng(5)
    fields = {}
    for f in J.SimResult._fields:
        if f == "probes":
            continue
        shape = (3, 3) if f.startswith("class_") else (3,)
        x = rng.uniform(0.0, 50.0, shape).astype(np.float32)
        if f.startswith("n_") or f.startswith("class_n_"):
            x = np.round(x)
        fields[f] = x
    for f in ("n_done", "n_started", "n_decided", "n_tasks"):
        fields[f][1] = 0.0  # an empty region
    want = J.fleet_totals(J.SimResult(**{k: np.asarray(v)
                                         for k, v in fields.items()}))
    got = P.fleet_totals(P.SimResult(**{k: torch.from_numpy(v)
                                        for k, v in fields.items()}))
    assert_fields_match(got, want, rtol=1e-6)


def test_totals_are_sums_and_exact_weighted_means(workload):
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS)
    res = P.simulate_fleet(pt, ph, cfg, P.FleetSpec(ci_traces=TRACES),
                           device="cpu")
    per = res.per_region
    for f in ("total_carbon_kg", "grid_energy_kwh", "dc_energy_kwh",
              "it_energy_kwh", "water_l", "n_done", "n_decided",
              "peak_power_kw", "lost_work_h"):
        np.testing.assert_allclose(float(getattr(res.total, f)),
                                   float(getattr(per, f).sum()), rtol=1e-6,
                                   err_msg=f)
    want = (np.sum(per.mean_delay_h.numpy() * per.n_done.numpy())
            / max(float(per.n_done.sum()), 1.0))
    np.testing.assert_allclose(float(res.total.mean_delay_h), want,
                               rtol=1e-6)
    assert float(res.total.pue) >= 1.0 - 1e-6


def test_empty_region_counts_zero_not_one(workload):
    """An uncapped greedy fleet on flat traces sends every task to the
    cleanest region; the empty regions count 0 tasks, and the fleet's
    done_frac is that region's."""
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS)
    flat = np.stack([np.full(N_STEPS, v, np.float32)
                     for v in (100.0, 200.0, 300.0)])
    res = P.simulate_fleet(pt, ph, cfg, P.FleetSpec(ci_traces=flat),
                           device="cpu")
    n_valid = int(torch.isfinite(pt.arrival).sum())
    np.testing.assert_array_equal(res.per_region.n_tasks.numpy(),
                                  [n_valid, 0, 0])
    assert float(res.total.n_tasks) == n_valid
    assert float(res.total.done_frac) == pytest.approx(
        float(res.per_region.done_frac[0]))


# ---------------------------------------------------------------------------
# simulate_fleet: R = 1 is simulate; R = 3 is the reference's fleet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["greedy", "spill", "round_robin"])
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_r1_fleet_bit_equal_to_simulate(workload, policy, backend):
    """One region: the fleet path (placement, split, the [1, W] row,
    aggregation) adds nothing to the port's own `simulate`."""
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS, backend=backend,
                            battery=pconfig.BatteryConfig(enabled=True))
    want = P.summarize(P.simulate(pt, ph, TRACES[0], cfg, device="cpu")[0],
                       cfg)
    res = P.simulate_fleet(pt, ph, cfg, P.FleetSpec(ci_traces=TRACES[:1],
                                                    policy=policy),
                           device="cpu")
    assert_bitwise(res.total, want)
    assert_bitwise(P.SimResult(*(None if x is None else x[0]
                                 for x in res.per_region)), want)


def test_r1_fleet_with_weather_bit_equal(workload):
    (_, _), (pt, ph) = workload
    cfg = pconfig.SimConfig(n_steps=N_STEPS,
                            cooling=pconfig.CoolingConfig(enabled=True))
    want = P.summarize(P.simulate(pt, ph, TRACES[0], cfg,
                                  weather_trace=WB[0], device="cpu")[0], cfg)
    res = P.simulate_fleet(pt, ph, cfg, P.FleetSpec(ci_traces=TRACES[:1],
                                                    wb_traces=WB[:1]),
                           device="cpu")
    assert_bitwise(res.total, want)


def _fleet_case(C, core, name):
    """(cfg, FleetSpec, dyn) of one fleet, built in either package."""
    battery = C.BatteryConfig(enabled=True)
    if name == "plain":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery),
                core.FleetSpec(ci_traces=TRACES, capacity_frac=1.5), None)
    if name == "weather":
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            cooling=C.CoolingConfig(enabled=True)),
                core.FleetSpec(ci_traces=TRACES, wb_traces=WB,
                               capacity_frac=1.5), None)
    if name == "per_region":
        # per-region host counts, batteries and setpoints on the spec, a
        # per-region dyn rate and a shared dyn capacity override
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            cooling=C.CoolingConfig(enabled=True),
                            shifting=C.ShiftingConfig(enabled=True)),
                core.FleetSpec(ci_traces=TRACES, wb_traces=WB,
                               n_active_hosts=[4, 2, 3],
                               batt_capacity_kwh=[2.0, 6.0, 4.0],
                               cooling_setpoint=[18.0, 24.0, 21.0],
                               capacity_frac=1.5),
                {"batt_rate_kw": np.array([1.0, 3.0, 2.0], np.float32)})
    if name == "failures":
        # host failures with one seed a region
        return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                            failures=C.FailureConfig(enabled=True,
                                                     mtbf_h=10.0)),
                core.FleetSpec(ci_traces=TRACES, capacity_frac=1.5,
                               seeds=[1, 2, 3]), None)
    # price and PV traces a region
    return (C.SimConfig(n_steps=N_STEPS, battery=battery,
                        pricing=C.PricingConfig(enabled=True),
                        renewables=C.RenewableConfig(enabled=True,
                                                     pv_capacity_kw=10.0)),
            core.FleetSpec(ci_traces=TRACES, price_traces=TRACES / 3000.0,
                           pv_traces=np.clip(np.sin(WB / 5.0), 0, 1),
                           policy="round_robin"), None)


FLEET_CASES = ("plain", "weather", "per_region", "failures", "price_pv")


@functools.lru_cache(maxsize=None)
def _reference_fleet(name: str, backend: str):
    cfg, fleet, dyn = _fleet_case(jconfig, J, name)
    return J.simulate_fleet(*_ref_workload(), cfg.replace(backend=backend),
                            fleet, dyn=dyn)


@pytest.mark.parametrize("backend", P.BACKENDS)
@pytest.mark.parametrize("name", FLEET_CASES)
def test_fleet_matches_reference(workload, name, backend):
    """R = 3 through both executors: the total and every region's fields
    equal the reference's (counts exact, the rest within rtol 1e-5)."""
    (_, _), (pt, ph) = workload
    cfg, fleet, dyn = _fleet_case(pconfig, P, name)
    got = P.simulate_fleet(pt, ph, cfg.replace(backend=backend), fleet,
                           dyn=dyn, device="cpu")
    want = _reference_fleet(name, backend)
    assert got.per_region.n_done.shape == (3,)
    assert_fields_match(got.total, want.total)
    assert_fields_match(got.per_region, want.per_region)


def test_precomputed_region_and_scalar_dyn(workload):
    """`region=` overrides the policy; a scalar dyn value holds for every
    region, a length-R one is one a region."""
    (jt, jh), (pt, ph) = workload
    region = (np.arange(40) % 3).astype(np.int32)[::-1].copy()
    dyn = {"n_active_hosts": np.array([2, 4, 3]), "batt_capacity_kwh": 3.0}
    cfg_j = jconfig.SimConfig(n_steps=N_STEPS,
                              battery=jconfig.BatteryConfig(enabled=True))
    cfg_p = pconfig.SimConfig(n_steps=N_STEPS,
                              battery=pconfig.BatteryConfig(enabled=True))
    want = J.simulate_fleet(jt, jh, cfg_j, J.FleetSpec(ci_traces=TRACES),
                            dyn=dyn, region=region)
    got = P.simulate_fleet(pt, ph, cfg_p, P.FleetSpec(ci_traces=TRACES),
                           dyn=dyn, region=region, device="cpu")
    assert_fields_match(got.per_region, want.per_region)
    np.testing.assert_array_equal(got.per_region.n_tasks.numpy(),
                                  np.bincount(region, minlength=3))


# ---------------------------------------------------------------------------
# validation: the reference's errors, in its order, with its messages
# ---------------------------------------------------------------------------

def _bad(C, core, what):
    """(cfg, FleetSpec, dyn) of a fleet the reference refuses."""
    res_on = C.ResilienceConfig(enabled=True, spill_interrupted=True)
    base = C.SimConfig(n_steps=N_STEPS)
    fleet = core.FleetSpec(ci_traces=TRACES)
    if what == "weather without cooling":
        return base, core.FleetSpec(ci_traces=TRACES, wb_traces=WB), None
    if what == "prices without pricing":
        return base, core.FleetSpec(ci_traces=TRACES,
                                    price_traces=TRACES), None
    if what == "pv without renewables":
        return base, core.FleetSpec(ci_traces=TRACES, pv_traces=WB), None
    if what == "spill without resilience":
        return (base.replace(resilience=C.ResilienceConfig(
            spill_interrupted=True)), fleet, None)
    if what == "spill on the megakernel":
        return (base.replace(backend="megakernel", resilience=res_on),
                fleet, None)
    if what == "spill with collect_series":
        return base.replace(collect_series=True, resilience=res_on), \
            fleet, None
    if what == "spill with probes":
        return base.replace(probes=C.ProbeConfig(enabled=True),
                            resilience=res_on), fleet, None
    if what in ("arrival_trace", "interactive_frac"):
        return (base.replace(resilience=res_on), fleet,
                {what: np.zeros(40, np.float32) if what == "arrival_trace"
                 else 0.5})
    return base, fleet, {"n_active_hosts": np.array([1, 2])}


@pytest.mark.parametrize("what", [
    "weather without cooling", "prices without pricing",
    "pv without renewables", "spill without resilience",
    "spill on the megakernel", "spill with collect_series",
    "spill with probes", "arrival_trace", "interactive_frac",
    "per-region length"])
def test_simulate_fleet_validation(workload, what):
    """Each refusal of the reference's `simulate_fleet`: the port raises
    ValueError with the reference's message (the reference asserts the
    per-region length)."""
    (jt, jh), (pt, ph) = workload
    cfg, fleet, dyn = _bad(jconfig, J, what)
    with pytest.raises((ValueError, AssertionError)) as want:
        J.simulate_fleet(jt, jh, cfg, fleet, dyn=dyn)
    cfg, fleet, dyn = _bad(pconfig, P, what)
    with pytest.raises(ValueError) as got:
        P.simulate_fleet(pt, ph, cfg, fleet, dyn=dyn, device="cpu")
    assert str(got.value) == str(want.value)


def test_fleet_spec_validation():
    with pytest.raises(ValueError, match="policy"):
        P.FleetSpec(ci_traces=TRACES, policy="telepathy")
    with pytest.raises(ValueError, match=r"f32\[R, S\]"):
        P.FleetSpec(ci_traces=TRACES[0])
    with pytest.raises(ValueError, match="wb_traces regions 2 != 3"):
        P.FleetSpec(ci_traces=TRACES, wb_traces=WB[:2])
    spec = P.FleetSpec(ci_traces=TRACES, n_active_hosts=2, seeds=[1, 2, 3])
    np.testing.assert_array_equal(spec.n_active_hosts, [2, 2, 2])
    again = spec.replace(policy="spill")
    assert again.policy == "spill" and again.n_regions == 3
    assert sorted(again.per_region_dyn()) == ["n_active_hosts", "seed"]
