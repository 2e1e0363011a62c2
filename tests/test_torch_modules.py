"""The port's precompute, scheduling and generator modules against the
reference package, on the CPU and on the same numpy inputs.

  * battery signals: threshold rtol 1e-5, `ci_rising` exact;
  * forward-window quantiles (shifting threshold, price bands): at most
    1 ULP apart, compared as int32 views, NaN where a window holds one;
  * `quantize_trace`: q exact, scale and zero rtol 1e-6;
  * `schedule_first_fit`: status, host and first_start bit-equal over
    random states -- priority levels 1 and 3, presorted or not, down and
    inactive hosts, zero-footprint tasks;
  * `make_workload` and `make_region_traces`: the same arrays per seed.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.carbontraces.synthetic import make_region_traces as j_traces
from repro.core import battery as jbattery
from repro.core import scheduler as jsched
from repro.core import shifting as jshift
from repro.core import state as jstate
from repro.workloads.synthetic import make_workload as j_workload
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro_torch.carbontraces import make_region_traces as p_traces
from repro_torch.core import battery as pbattery
from repro_torch.core import scheduler as psched
from repro_torch.core import shifting as pshift
from repro_torch.core import state as pstate
from repro_torch.workloads import make_workload as p_workload

torch.set_num_threads(1)

DT = 0.25
T = torch.tensor


def _np(table) -> dict:
    return {k: np.asarray(v) for k, v in table._asdict().items()}


def _golden_traces(s=96):
    t = np.arange(s) * 0.25
    return [(300.0 + 200.0 * np.sin(2 * np.pi * t / 24.0 + p)).astype(
        np.float32) for p in (0.0, 1.7, 3.1)]


def _random_trace(s, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(s) * DT
    return (rng.uniform(50, 600) * (1 + 0.5 * np.sin(2 * np.pi * t / 24))
            + rng.normal(0, 20, s)).clip(1.0).astype(np.float32)


TRACES = _golden_traces() + [_random_trace(96, s) for s in range(3)]


# ---------------------------------------------------------------------------
# exogenous precompute
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window_h", [168.0, 6.0, 1.0])
@pytest.mark.parametrize("i", range(len(TRACES)))
def test_battery_signals_match_reference(i, window_h):
    ci = TRACES[i]
    want_t, want_r = jbattery.precompute_battery_signals(
        ci, DT, jconfig.BatteryConfig(threshold_window_h=window_h))
    got_t, got_r = pbattery.precompute_battery_signals(
        T(ci), DT, pconfig.BatteryConfig(threshold_window_h=window_h))
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), rtol=1e-5)
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def assert_within_ulp(got: np.ndarray, want: np.ndarray, ulps: int = 1):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    diff = np.abs(got[~nan].view(np.int32).astype(np.int64)
                  - want[~nan].view(np.int32).astype(np.int64))
    assert diff.max(initial=0) <= ulps, f"{diff.max()} ULP apart"


# W = 672 steps (a week) is wider than S = 96; 6 h (24 steps) narrower
@pytest.mark.parametrize("window_h,q", [(168.0, 0.35), (6.0, 0.35),
                                        (6.0, 1.0), (168.0, 0.0)])
@pytest.mark.parametrize("i", range(len(TRACES)))
def test_shift_threshold_within_one_ulp(i, window_h, q):
    ci = TRACES[i]
    want = jshift.precompute_shift_threshold(
        ci, DT, jconfig.ShiftingConfig(enabled=True,
                                       forecast_window_h=window_h,
                                       quantile=q))
    got = pshift.precompute_shift_threshold(
        T(ci), DT, pconfig.ShiftingConfig(enabled=True,
                                          forecast_window_h=window_h,
                                          quantile=q))
    assert_within_ulp(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window_h", [168.0, 6.0])
def test_window_quantiles_poison_nan_windows(window_h):
    x = _random_trace(96, 9)
    x[40] = np.nan
    want = jshift.forward_window_quantiles(x, DT, window_h,
                                           np.float32([0.25, 0.75]))
    got = pshift.forward_window_quantiles(T(x), DT, window_h,
                                          np.float32([0.25, 0.75]))
    assert_within_ulp(got.numpy(), np.asarray(want))
    assert np.isnan(got.numpy()).any()


@pytest.mark.parametrize("s", [40, 96])
def test_window_quantiles_row_chunks_agree(s):
    """Sorting the windows in row chunks changes nothing."""
    x = T(_random_trace(s, s))
    whole = pshift.forward_window_quantiles(x, DT, 6.0, [0.2, 0.8])
    chunked = pshift.forward_window_quantiles(x, DT, 6.0, [0.2, 0.8],
                                              chunk_rows=7)
    assert torch.equal(whole, chunked)


@pytest.mark.parametrize("window_h", [168.0, 6.0])
@pytest.mark.parametrize("i", range(3, len(TRACES)))
def test_price_signals_within_one_ulp(i, window_h):
    price = TRACES[i] / np.float32(1000.0)
    jc = jconfig.BatteryConfig(price_window_h=window_h)
    pc = pconfig.BatteryConfig(price_window_h=window_h)
    want = J.precompute_price_signals(price, DT, jc)
    got = P.precompute_price_signals(T(price), DT, pc)
    for g, w in zip(got, want):
        assert_within_ulp(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("store", ["bf16", "int8"])
@pytest.mark.parametrize("i", range(len(TRACES)))
def test_quantize_trace_matches_reference(i, store):
    x = np.stack([TRACES[i], TRACES[(i + 1) % len(TRACES)]])
    want = J.quantize_trace(x, store)
    got = P.quantize_trace(T(x), store)
    np.testing.assert_array_equal(got.q.float().numpy(),
                                  np.asarray(want.q, np.float32))
    np.testing.assert_allclose(got.scale.numpy(), np.asarray(want.scale),
                               rtol=1e-6)
    np.testing.assert_allclose(got.zero.numpy(), np.asarray(want.zero),
                               rtol=1e-6)
    np.testing.assert_allclose(P.dequantize_trace(got).numpy(),
                               np.asarray(J.dequantize_trace(want)),
                               rtol=1e-6, atol=1e-4)


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------

def random_state(seed: int, t: int = 40, h: int = 6):
    """A mid-run task table and host table, as numpy dicts."""
    rng = np.random.default_rng(seed)
    job_class = rng.integers(0, 3, t).astype(np.int32)
    cores = rng.integers(0, 5, t).astype(np.float64)  # 0: zero footprint
    gpus = np.where(rng.uniform(size=t) < 0.3, rng.integers(0, 3, t), 0)
    tasks = jstate.make_task_table(
        np.sort(rng.uniform(0.0, 6.0, t)), rng.uniform(0.5, 4.0, t), cores,
        gpus.astype(np.float64), job_class=job_class)
    tasks = _np(tasks)
    status = rng.choice([0, 0, 1, 2], t).astype(np.int32)
    host = np.where(status == 1, rng.integers(0, h, t), -1).astype(np.int32)
    tasks["status"], tasks["host"] = status, host
    tasks["first_start"] = np.where(status > 0, rng.uniform(0, 3, t),
                                    np.inf).astype(np.float32)
    hosts = _np(jstate.make_host_table(h, 8.0, 2.0, n_active=h - 1))
    hosts["up"] = rng.uniform(size=h) > 0.25
    return tasks, hosts


def _j_tables(tasks, hosts):
    return (jstate.TaskTable(**{k: jnp.asarray(v) for k, v in tasks.items()}),
            jstate.HostTable(**{k: jnp.asarray(v) for k, v in hosts.items()}))


@pytest.mark.parametrize("slots", [None, 3])
@pytest.mark.parametrize("presorted", [False, True])
@pytest.mark.parametrize("levels", [1, 3])
@pytest.mark.parametrize("seed", range(4))
def test_schedule_first_fit_bit_equal(seed, levels, presorted, slots):
    tasks, hosts = random_state(seed)
    jt, jh = _j_tables(tasks, hosts)
    pt, ph = P.tables_from_numpy(tasks, hosts, device="cpu")
    if presorted:
        order = jstate.priority_schedule_order(jt, levels)
        jt = jstate.permute_task_table(jt, order)
        pt = pstate.permute_task_table(
            pt, pstate.priority_schedule_order(pt, levels))
        for k, v in _np(jt).items():
            np.testing.assert_array_equal(getattr(pt, k).numpy(), v)
    rng = np.random.default_rng(seed + 100)
    shift_ok = rng.uniform(size=jt.arrival.shape[0]) < 0.8
    now = np.float32(4.5)
    jcfg = jconfig.SchedulerConfig(slots_per_step=8, priority_levels=levels)
    pcfg = pconfig.SchedulerConfig(slots_per_step=8, priority_levels=levels)
    want = jsched.schedule_first_fit(jt, jh, now, jnp.asarray(shift_ok),
                                     jcfg, slots=slots, presorted=presorted)
    got = psched.schedule_first_fit(pt, ph, T(now), T(shift_ok), pcfg,
                                    slots=slots, presorted=presorted)
    for k in ("status", "host", "first_start"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert getattr(got, "status").dtype == torch.int32
    placed = (got.status.numpy() == 1) & (tasks["status"] != 1)
    assert placed.any() or not (tasks["status"] == 0).any()


@pytest.mark.parametrize("seed", range(3))
def test_capacity_and_utilization_match_reference(seed):
    tasks, hosts = random_state(seed, h=300)  # above the one-hot threshold
    jt, jh = _j_tables(tasks, hosts)
    pt, ph = P.tables_from_numpy(tasks, hosts, device="cpu")
    for g, w in zip(psched.free_capacity(pt, ph),
                    jsched.free_capacity(jt, jh)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(psched.host_utilization(pt, ph),
                    jsched.host_utilization(jt, jh)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_first_k_indices_matches_reference():
    mask = np.random.default_rng(5).uniform(size=50) < 0.3
    for k in (1, 4, 64):
        want = jsched._first_k_indices(jnp.asarray(mask), k)
        got = psched._first_k_indices(T(mask), k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_permutation_helpers_match_reference():
    tasks, _ = random_state(7)
    jt, _ = _j_tables(tasks, random_state(7)[1])
    pt, _ = P.tables_from_numpy(tasks, random_state(7)[1], device="cpu")
    order_j = jstate.priority_schedule_order(jt, 3)
    order_p = pstate.priority_schedule_order(pt, 3)
    np.testing.assert_array_equal(order_p.numpy(), np.asarray(order_j))
    np.testing.assert_array_equal(
        pstate.inverse_permutation(order_p).numpy(),
        np.asarray(jstate.inverse_permutation(order_j)))
    back = pstate.permute_task_table(
        pstate.permute_task_table(pt, order_p),
        pstate.inverse_permutation(order_p))
    for k in pt._fields:
        assert torch.equal(getattr(back, k), getattr(pt, k))


def test_pad_and_default_tables_match_reference():
    rng = np.random.default_rng(11)
    args = (rng.uniform(0, 5, 9), rng.uniform(0.5, 3, 9),
            rng.integers(1, 4, 9).astype(float))
    for jt, pt in ((jstate.make_task_table(*args),
                    pstate.make_task_table(*args, device="cpu")),):
        for k, v in _np(jstate.pad_task_table(jt, 13)).items():
            got = getattr(pstate.pad_task_table(pt, 13), k).numpy()
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    for k, v in _np(jstate.make_host_table(5, 16, 2, n_active=3)).items():
        got = getattr(pstate.make_host_table(5, 16, 2, n_active=3,
                                             device="cpu"), k).numpy()
        np.testing.assert_array_equal(got, v, err_msg=k)


# ---------------------------------------------------------------------------
# numpy generators: the same arrays per seed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,kw", [
    ("marconi", dict(scale=0.05, horizon_days=3.0)),
    ("surf", dict(scale=0.1, horizon_days=2.0)),
    ("borg", dict(scale=0.02, horizon_days=1.0, n_tasks_cap=300)),
    ("marconi", dict(scale=0.03, horizon_days=2.0,
                     class_mix=(0.5, 0.3, 0.2))),
])
def test_make_workload_matches_reference(kind, kw):
    jt, jh, jspec, jmeta = j_workload(kind, seed=3, **kw)
    pt, ph, pspec, pmeta = p_workload(kind, seed=3, device="cpu", **kw)
    assert jspec.__dict__ == pspec.__dict__
    assert {k: v for k, v in jmeta.items() if k != "embodied"} == \
        {k: v for k, v in pmeta.items() if k != "embodied"}
    assert jmeta["embodied"].host_kg == pmeta["embodied"].host_kg
    for port, ref in ((pt, jt), (ph, jh)):
        for k, v in _np(ref).items():
            got = getattr(port, k).numpy()
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)


@pytest.mark.parametrize("seed", [0, 4])
def test_region_traces_match_reference(seed):
    np.testing.assert_array_equal(p_traces(96, DT, 8, seed=seed),
                                  j_traces(96, DT, 8, seed=seed))
