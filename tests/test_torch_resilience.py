"""The port's host failures, checkpointing and resilience loop against the
reference package, on the CPU.

Each function of `repro_torch.core.failures` / `resilience` and the
derated cooling model of `thermal` meets its reference counterpart on the
same numpy-seeded inputs bit for bit (the draws are the same threefry bits
and the same f32 thresholds).  The plain facility chain with a derate
series meets the reference's at the facility tests' tolerance (rtol 1e-4,
atol 1e-3: sums reassociate).  Whole runs with failures, and with failures
plus the closed loop, on both executors at a small size (the resilience
configuration of tests/test_megakernel.py): outcome counts and
`n_interrupts` exact, the rest within rtol 1e-4 of the reference and
within rtol 1e-5 / atol 1e-4 between the executors; the final keys, host
states and repair times equal.  A seed x hazard grid against the
reference's grid; `with_interactive_frac` and straggler hosts bit for bit;
kernel 3's wrapper lays out the derate flags.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.core import failures as jfail
from repro.core import state as jstate
from repro.core import thermal as jthermal
from repro.kernels import ref as jref
import repro_torch.core as P
import repro_torch.core.config as pconfig
from repro_torch.core import failures as pfail
from repro_torch.core import state as pstate
from repro_torch.core import thermal as pthermal
from repro_torch.core import threefry
from repro_torch.kernels import build, ref
from repro_torch.kernels import fused_step as fs

torch.set_num_threads(1)

S = 96
DT = 0.25
T = torch.tensor

# the workload of tests/test_torch_engine.py (tests/test_megakernel.py's)
_rng0 = np.random.default_rng(21)
_N = 12
J_TASKS = J.make_task_table(np.sort(_rng0.uniform(0.0, 8.0, _N)),
                            _rng0.uniform(0.5, 4.0, _N),
                            _rng0.integers(1, 3, _N).astype(float))
J_HOSTS = J.make_host_table(3, 4)

COUNT_FIELDS = ("n_done", "n_started", "n_decided", "n_tasks",
                "n_interrupts", "class_n_violations", "class_n_decided",
                "class_n_started")


def _np(table) -> dict:
    return {k: np.asarray(v) for k, v in table._asdict().items()}


def port_tables(tasks=J_TASKS, hosts=J_HOSTS):
    return P.tables_from_numpy(_np(tasks), _np(hosts), device="cpu")


def _traces():
    t = np.arange(S) * DT
    ci = (300.0 + 200.0 * np.sin(2 * np.pi * t / 24.0)).astype(np.float32)
    price = (0.1 * (1 + 0.5 * np.sin(2 * np.pi * t / 24))).astype(np.float32)
    wb = (18.0 + 7.0 * np.sin(2 * np.pi * t / 24.0)).astype(np.float32)
    cf = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0, 1.0).astype(
        np.float32)
    return ci, price, wb, cf


CI, PRICE, WB, CF = _traces()


def _host_table(C, mod, seed: int, h: int = 9):
    """An [H] host table with some hosts down, some inactive and repair
    times in the past and future, in package `mod` (J or P)."""
    rng = np.random.default_rng(seed)
    up = rng.uniform(size=h) < 0.7
    active = rng.uniform(size=h) < 0.85
    repair_at = np.where(up, 0.0, rng.uniform(0.0, 6.0, h)).astype(
        np.float32)
    kw = {} if mod is J else {"device": "cpu"}
    hosts = mod.make_host_table(h, 4, **kw)
    cast = jnp.asarray if mod is J else torch.tensor
    return hosts._replace(up=cast(up), active=cast(active),
                          repair_at=cast(repair_at))


# ---------------------------------------------------------------------------
# the functions, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hazard", [None, 0.0, 1.0, 2.5])
@pytest.mark.parametrize("seed", [0, 7, -1])
def test_step_host_failures_bit_equal(seed, hazard):
    """Eight steps of the reference's step from one key: keys, up flags,
    repair times and the newly-down masks equal."""
    cfg_j = jconfig.FailureConfig(enabled=True, mtbf_h=5.0, repair_h=0.75)
    cfg_p = pconfig.FailureConfig(enabled=True, mtbf_h=5.0, repair_h=0.75)
    jh, ph = _host_table(jconfig, J, seed + 3), _host_table(pconfig, P,
                                                            seed + 3)
    jk, pk = jax.random.PRNGKey(seed), threefry.prng_key(seed)
    for step in range(8):
        now = np.float32(step * DT)
        jk, jh, jdown = jfail.step_host_failures(jk, jh, jnp.float32(now),
                                                 DT, cfg_j, hazard=hazard)
        pk, ph, pdown = pfail.step_host_failures(pk, ph, T(now), DT, cfg_p,
                                                 hazard=hazard)
        np.testing.assert_array_equal(pk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(pdown.numpy(), np.asarray(jdown))
        for f in ("up", "repair_at"):
            np.testing.assert_array_equal(getattr(ph, f).numpy(),
                                          np.asarray(getattr(jh, f)), f)


def test_step_host_failures_off_is_inert():
    hosts = _host_table(pconfig, P, 1)
    key = threefry.prng_key(4)
    k, h, down = pfail.step_host_failures(key, hosts, T(1.0), DT,
                                          pconfig.FailureConfig())
    assert k is key and h is hosts and not down.any()


def test_draws_before_the_loop_equal_the_step_by_step_draws():
    """`draw_host_failures` (the engine's up-front draws, [S, B, H], per-row
    seeds and per-step probabilities) == each row's step-by-step draws."""
    seeds = np.array([3, -1, 12345])
    p = torch.rand(3, 10, generator=torch.Generator().manual_seed(0)) * 0.5
    keys, draws = pfail.draw_host_failures(seeds, p, 7, device="cpu")
    assert keys.shape == (11, 3, 2) and draws.shape == (10, 3, 7)
    for b, seed in enumerate(seeds):
        k = jax.random.PRNGKey(int(seed))
        for i in range(10):
            k, sub = jax.random.split(k)
            np.testing.assert_array_equal(keys[i + 1, b].numpy(),
                                          np.asarray(k))
            np.testing.assert_array_equal(draws[i, b].numpy(), np.asarray(
                jax.random.bernoulli(sub, np.float32(p[b, i]), (7,))))


@pytest.mark.parametrize("checkpointing", [False, True])
def test_interrupt_tasks_bit_equal(checkpointing):
    rng = np.random.default_rng(5)
    n, h = 40, 6
    jt = J.make_task_table(np.sort(rng.uniform(0, 4, n)),
                           rng.uniform(0.5, 4.0, n), np.ones(n))
    status = rng.integers(0, 3, n).astype(np.int32)
    host = np.where(status == 1, rng.integers(-1, h, n), -1).astype(np.int32)
    remaining = (np.asarray(jt.duration) * rng.uniform(0.1, 1.0, n)).astype(
        np.float32)
    ckpt = np.maximum(remaining, np.asarray(jt.duration)
                      * np.float32(0.9)).astype(np.float32)
    jt = jt._replace(status=jnp.asarray(status), host=jnp.asarray(host),
                     remaining=jnp.asarray(remaining),
                     ckpt_remaining=jnp.asarray(ckpt))
    pt, _ = port_tables(jt)
    down = rng.uniform(size=h) < 0.4
    cj = jconfig.FailureConfig(enabled=True, checkpointing=checkpointing)
    cp = pconfig.FailureConfig(enabled=True, checkpointing=checkpointing)
    want, wn = jfail.interrupt_tasks(jt, jnp.asarray(down), cj)
    got, gn = pfail.interrupt_tasks(pt, T(down), cp)
    assert float(gn) == float(wn) > 0
    for f in ("status", "host", "remaining", "lost_work"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


@pytest.mark.parametrize("interval_h", [0.25, 1.0, 1.6])
def test_checkpoint_tick_bit_equal(interval_h):
    rng = np.random.default_rng(9)
    n = 20
    jt = J.make_task_table(np.sort(rng.uniform(0, 4, n)),
                           rng.uniform(0.5, 4.0, n), np.ones(n))
    jt = jt._replace(status=jnp.asarray(rng.integers(0, 3, n), jnp.int32),
                     remaining=jnp.asarray(rng.uniform(0, 2, n), jnp.float32))
    pt, _ = port_tables(jt)
    cj = jconfig.FailureConfig(enabled=True, checkpoint_interval_h=interval_h)
    cp = pconfig.FailureConfig(enabled=True, checkpoint_interval_h=interval_h)
    k = pfail.checkpoint_interval_steps(cp, DT)
    assert k == jfail.checkpoint_interval_steps(cj, DT)
    for step in range(9):
        want = jfail.checkpoint_tick(jt, jnp.int32(step), k, cj)
        for s in (step, T(step, dtype=torch.int32)):
            got = pfail.checkpoint_tick(pt, s, k, cp)
            np.testing.assert_array_equal(got.ckpt_remaining.numpy(),
                                          np.asarray(want.ckpt_remaining))


def _res_cfg(C, **kw):
    base = dict(chiller_mtbf_h=15.0, chiller_repair_h=3.0, pdu_mtbf_h=25.0,
                pdu_repair_h=2.0, pdu_cap_kw=3.0, throttle_inlet_c=24.0,
                heat_hazard_mult=2.0)
    base.update(kw)
    return C.ResilienceConfig(enabled=True, **base)


@pytest.mark.parametrize("hazard", [None, 0.0, 1.0, 3.0])
@pytest.mark.parametrize("seed", [0, 42, -1])
def test_facility_failure_series_bit_equal(seed, hazard):
    want = J.facility_failure_series(seed, 2880, DT, _res_cfg(jconfig),
                                     hazard_scale=hazard)
    got = P.facility_failure_series(seed, 2880, DT, _res_cfg(pconfig),
                                    hazard_scale=hazard, device="cpu")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if hazard != 0.0:
        assert got[1].any() and (got[0] < 1.0).any()
    else:
        assert not got[1].any() and (got[0] == 1.0).all()


def test_facility_failure_series_rows():
    """One row a seed, or a hazard a row: each row equals its own call."""
    cfg = _res_cfg(pconfig)
    seeds, hz = np.array([0, 42, -1]), np.array([0.5, 1.0, 2.0], np.float32)
    for kw, rows in (({"seed": seeds}, [{"seed": s} for s in seeds]),
                     ({"seed": 5, "hazard_scale": hz},
                      [{"seed": 5, "hazard_scale": h} for h in hz])):
        derate, pdu = P.facility_failure_series(n_steps=500, dt_h=DT,
                                                cfg=cfg, device="cpu", **kw)
        assert derate.shape == pdu.shape == (3, 500)
        for r, one in enumerate(rows):
            d1, p1 = P.facility_failure_series(n_steps=500, dt_h=DT, cfg=cfg,
                                               device="cpu", **one)
            assert torch.equal(derate[r], d1) and torch.equal(pdu[r], p1)


def test_next_throttle_and_inlet_bit_equal():
    rng = np.random.default_rng(2)
    n = 64
    it = rng.uniform(0.0, 12.0, n).astype(np.float32)
    raw = (it * rng.uniform(1.0, 1.5, n)).astype(np.float32)
    wb = rng.uniform(5.0, 30.0, n).astype(np.float32)
    derate = np.where(rng.uniform(size=n) < 0.5, 0.5, 1.0).astype(np.float32)
    cap = np.where(rng.uniform(size=n) < 0.5, 3.0, np.inf).astype(np.float32)
    cj, cp = _res_cfg(jconfig), _res_cfg(pconfig)
    for th in (None, 24.0):
        want = jax.vmap(lambda *a: J.next_throttle(
            *a, cj, threshold_c=th))(it, raw, wb, derate, cap)
        got = P.next_throttle(T(it), T(raw), T(wb), T(derate), T(cap), cp,
                              threshold_c=th)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert 0.0 < float(got.min()) < 1.0 == float(got.max())
    np.testing.assert_array_equal(
        P.inlet_proxy_c(T(it), T(wb), T(derate), cp).numpy(),
        np.asarray(J.inlet_proxy_c(it, wb, derate, cj)))


def test_host_rank_bit_equal():
    for seed in range(4):
        jh, ph = _host_table(jconfig, J, seed), _host_table(pconfig, P, seed)
        want = J.host_rank(jh, jnp.float32(4.0))
        got = P.host_rank(ph, T(4.0))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # rows of hosts rank row by row
    rows = pstate.HostTable(*(torch.stack([getattr(_host_table(
        pconfig, P, s), f) for s in range(3)]) for f in pstate.HostTable._fields))
    got = P.host_rank(rows, T(4.0))
    for s in range(3):
        np.testing.assert_array_equal(got[s].numpy(), np.asarray(J.host_rank(
            _host_table(jconfig, J, s), jnp.float32(4.0))))


def _stack(*trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _spill_case(healthy: bool):
    """[R, W] tables of three regions: interrupted tasks (PENDING, started
    once) in the unhealthy ones, free slots in the healthy one."""
    w = 5
    tables = []
    for r in range(3):
        t = jstate.pad_task_table(J.make_task_table(
            [0.0, 0.25, 0.5][: 3 - r], [2.0, 1.0, 3.0][: 3 - r],
            [1.0, 2.0, 1.0][: 3 - r]), w)
        t = t._replace(first_start=t.first_start.at[0].set(0.5))
        tables.append(t)
    hosts = [J.make_host_table(4, 4) for _ in range(3)]
    if not healthy:
        hosts[0] = hosts[0]._replace(up=jnp.asarray([False, False, True,
                                                     True]))
        hosts[2] = hosts[2]._replace(up=jnp.asarray([False, True, True,
                                                     True]))
    return (_stack(*tables), _stack(*hosts),
            _stack(*[jstate.init_metrics()] * 3))


@pytest.mark.parametrize("healthy,max_spills", [(False, 1), (False, 4),
                                                (True, 4)])
def test_cross_region_spill_bit_equal(healthy, max_spills):
    jt, jh, jm = _spill_case(healthy)
    pt, ph = port_tables(jt, jh)
    pm = pstate.MetricsAcc(*(T(np.asarray(x)) for x in jm))
    want_t, want_m = J.cross_region_spill(jt, jh, jm, max_spills)
    got_t, got_m = P.cross_region_spill(pt, ph, pm, max_spills)
    for f in pstate.TaskTable._fields:
        np.testing.assert_array_equal(getattr(got_t, f).numpy(),
                                      np.asarray(getattr(want_t, f)), f)
    np.testing.assert_array_equal(got_m.n_spills.numpy(),
                                  np.asarray(want_m.n_spills))
    moved = float(got_m.n_spills.sum())
    assert moved == (0.0 if healthy else min(max_spills, 2))


# ---------------------------------------------------------------------------
# the derated cooling model and the facility chain
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("setpoint", [None, 22.0])
def test_derated_cooling_bit_equal(setpoint):
    rng = np.random.default_rng(4)
    n = 200
    it = rng.uniform(1.0, 30.0, n).astype(np.float32)
    wb = rng.uniform(0.0, 35.0, n).astype(np.float32)
    derate = np.where(rng.uniform(size=n) < 0.5, 0.5, 1.0).astype(np.float32)
    cj = jconfig.CoolingConfig(enabled=True, heat_reuse_fraction=0.3)
    cp = pconfig.CoolingConfig(enabled=True, heat_reuse_fraction=0.3)
    spj = None if setpoint is None else jnp.float32(setpoint)
    spp = None if setpoint is None else T(setpoint)
    for d in (None, derate):
        dj = None if d is None else jnp.asarray(d)
        dp = None if d is None else T(d)
        want = jthermal.cooling_step(it, wb, cj, spj, chiller_derate=dj)
        got = pthermal.cooling_step(T(it), T(wb), cp, spp, chiller_derate=dp)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        np.testing.assert_array_equal(
            pthermal.reclaimable_heat_kw(T(it), got[0], T(wb), cp, spp,
                                         chiller_derate=dp).numpy(),
            np.asarray(jthermal.reclaimable_heat_kw(
                it, want[0], wb, cj, spj, chiller_derate=dj)))


def _chain_cfg(C, cool, price, renew):
    return C.SimConfig(
        n_steps=S, dt_h=DT,
        cooling=C.CoolingConfig(enabled=cool, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=price, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=renew, pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=True, capacity_kwh=6.0,
                                policy="blended" if price else "carbon",
                                price_window_h=24.0),
        resilience=_res_cfg(C))


@pytest.mark.parametrize("cool,price,renew", [(True, True, True)])
def test_plain_chain_with_derate_matches_reference(cool, price, renew):
    cj, cp = (_chain_cfg(C, cool, price, renew) for C in (jconfig, pconfig))
    dyn = {"price_trace": PRICE, "wet_bulb_trace": WB, "pv_cf_trace": CF}
    dyn = {k: v for k, v in dyn.items()
           if (k != "price_trace" or price) and (k != "pv_cf_trace"
                                                 or renew)}
    ji = J.build_step_inputs(CI, cj, dyn)
    pi = P.build_step_inputs(CI, cp, dyn, device="cpu")
    np.testing.assert_array_equal(pi.chiller_derate.numpy(),
                                  np.asarray(ji.chiller_derate))
    np.testing.assert_array_equal(pi.pdu_cap_kw.numpy(),
                                  np.asarray(ji.pdu_cap_kw))
    assert (pi.chiller_derate < 1.0).any()
    it = np.random.default_rng(3).uniform(2.0, 12.0, S).astype(np.float32)
    args = lambda x: (x.ci, x.wet_bulb_c, x.price, x.price_lo,  # noqa: E731
                      x.price_hi, x.pv_cf, x.batt_threshold, x.ci_rising)
    want = jref.fused_facility_chain(it, *args(ji), DT, cj,
                                     chiller_derate=ji.chiller_derate)
    got = ref.fused_facility_chain(T(it), *args(pi), DT, cp,
                                   chiller_derate=pi.chiller_derate)
    for k, g in got.items():
        np.testing.assert_allclose(g.numpy().astype(np.float64),
                                   np.asarray(want[k], np.float64),
                                   rtol=1e-4, atol=1e-3, err_msg=k)
    healthy = ref.fused_facility_chain(T(it), *args(pi), DT, cp)
    assert (got["cooling_kw"] > healthy["cooling_kw"]).any()


def test_kernel_wrapper_lays_out_the_derate_flags(monkeypatch):
    """Kernel 3's wrapper: without a series, the flag byte is the rising
    bit and the derate route is off; with one, bit 1 marks the derated
    steps and the config carries the derate."""
    monkeypatch.setattr(build, "require_cuda", lambda *a: None)
    cfg = _chain_cfg(pconfig, True, True, True)
    x = P.build_step_inputs(CI, cfg, {"price_trace": PRICE,
                                      "wet_bulb_trace": WB,
                                      "pv_cf_trace": CF}, device="cpu")
    it = torch.full((S,), 5.0)
    args = (it, x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
            x.pv_cf, x.batt_threshold, x.ci_rising, cfg)
    tensors, fcfg, _, _ = fs.prepare(*args)
    assert fcfg.derate == 0
    assert torch.equal(tensors[7][0], x.ci_rising.to(torch.uint8))
    tensors, fcfg, _, _ = fs.prepare(*args, chiller_derate=x.chiller_derate)
    assert fcfg.derate == 1 and fcfg.chiller_derate == np.float32(0.5)
    flags = tensors[7][0]
    assert torch.equal(flags & fs.RISING, x.ci_rising.to(torch.uint8))
    assert torch.equal((flags & fs.DERATED) > 0, x.chiller_derate < 1.0)


# ---------------------------------------------------------------------------
# state: interactive share, stragglers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_with_interactive_frac_bit_equal(frac):
    rng = np.random.default_rng(8)
    n = 500
    jt = J.make_task_table(np.sort(rng.uniform(0, 8, n)),
                           rng.uniform(0.5, 4, n), np.ones(n),
                           gpus=rng.integers(0, 2, n).astype(float),
                           job_class=rng.integers(0, 2, n).astype(np.int32))
    jt = jstate.pad_task_table(jt, n + 12)
    pt, _ = port_tables(jt)
    want = J.with_interactive_frac(jt, frac, 0.25, seed=3)
    got = P.with_interactive_frac(pt, frac, 0.25, seed=3)
    for f in pstate.TaskTable._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)


def test_with_interactive_frac_rows():
    """A [B, 1] share gives [B, T] class columns, row b as its own share."""
    pt, _ = port_tables(J.make_task_table(np.arange(50.0), np.ones(50),
                                          np.ones(50)))
    fracs = np.array([0.1, 0.5, 0.9], np.float32)
    got = P.with_interactive_frac(pt, T(fracs).reshape(3, 1), 0.25, seed=1)
    assert got.job_class.shape == (3, 50)
    for b, fr in enumerate(fracs):
        one = P.with_interactive_frac(pt, fr, 0.25, seed=1)
        for f in ("job_class", "priority", "shiftable", "sla_grace",
                  "cpu_util", "gpu_util"):
            assert torch.equal(getattr(got, f)[b], getattr(one, f)), f


@pytest.mark.parametrize("seed", [0, 11])
def test_straggler_hosts_bit_equal(seed):
    want = J.make_host_table(200, 48, 4, straggler_frac=0.2,
                             straggler_speed=0.4, seed=seed)
    got = P.make_host_table(200, 48, 4, straggler_frac=0.2,
                            straggler_speed=0.4, seed=seed, device="cpu")
    for f in pstate.HostTable._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert 0 < int((got.speed < 1.0).sum()) < 200


# ---------------------------------------------------------------------------
# whole runs against the reference
# ---------------------------------------------------------------------------

MODES = ("failures", "resilience", "reactive")


def run_cfg(C, mode: str, cool: bool, **kw):
    """tests/test_megakernel.py's resilience configuration (host failures
    at a 30 h MTBF); `failures` leaves the loop off, `reactive` adds
    failure-reactive placement and checkpointing every 2 h."""
    fail = C.FailureConfig(enabled=True, mtbf_h=30.0,
                           checkpoint_interval_h=2.0 if mode == "reactive"
                           else 1.0)
    res = (C.ResilienceConfig() if mode == "failures"
           else _res_cfg(C, reactive_placement=mode == "reactive"))
    return C.SimConfig(
        n_steps=S, dt_h=DT, seed=42,
        cooling=C.CoolingConfig(enabled=cool, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=True, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=True, pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=True, capacity_kwh=6.0,
                                policy="blended", price_window_h=24.0),
        failures=fail, resilience=res, **kw)


def run_dyn(cool: bool) -> dict:
    d = {"price_trace": PRICE, "pv_cf_trace": CF}
    if cool:
        d["wet_bulb_trace"] = WB
    return d


@functools.lru_cache(maxsize=None)
def _reference(mode: str, cool: bool):
    cfg = run_cfg(jconfig, mode, cool)
    final, _ = J.simulate(J_TASKS, J_HOSTS, CI, cfg, dyn=run_dyn(cool))
    return final, {k: np.asarray(v) for k, v in
                   J.summarize(final, cfg)._asdict().items()
                   if v is not None}


def _port(mode: str, cool: bool, backend: str):
    cfg = run_cfg(pconfig, mode, cool, backend=backend)
    final, _ = P.simulate(*port_tables(), CI, cfg, dyn=run_dyn(cool),
                          device="cpu")
    return final, P.result_to_numpy(P.summarize(final, cfg))


def assert_close(got: dict, want: dict, rtol: float, atol: float):
    assert set(got) == set(want)
    for k, v in want.items():
        if k in COUNT_FIELDS:
            np.testing.assert_array_equal(got[k], v, err_msg=f"count {k}")
        else:
            np.testing.assert_allclose(np.asarray(got[k], np.float64),
                                       np.asarray(v, np.float64), rtol=rtol,
                                       atol=atol, err_msg=f"field {k}")


@pytest.mark.parametrize("cool", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_run_matches_reference(mode, cool):
    want_state, want = _reference(mode, cool)
    runs = {be: _port(mode, cool, be) for be in P.BACKENDS}
    for be, (state, got) in runs.items():
        assert_close(got, want, 1e-4, 1e-4)
        np.testing.assert_array_equal(state.rng.numpy(),
                                      np.asarray(want_state.rng))
        for f in ("up", "repair_at"):
            np.testing.assert_array_equal(
                getattr(state.hosts, f).numpy(),
                np.asarray(getattr(want_state.hosts, f)), f"{be} {f}")
        np.testing.assert_allclose(state.tasks.lost_work.numpy(),
                                   np.asarray(want_state.tasks.lost_work),
                                   rtol=1e-4, atol=1e-5)
    assert_close(runs["megakernel"][1], runs["stage-pipeline"][1], 1e-5,
                 1e-4)
    assert want["n_interrupts"] > 0 and want["lost_work_h"] > 0
    if mode != "failures":
        assert want["derate_h"] > 0
        if cool:  # the wet-bulb trace passes the trip point
            assert want["throttled_h"] > 0


def test_healthy_loop_matches_the_open_loop():
    """`failure_hazard_scale` 0.0 (no host or facility failures) with the
    trip point out of reach: the loop never acts, and the run equals the
    one without failures or resilience."""
    cfg = run_cfg(pconfig, "resilience", True).replace(
        resilience=_res_cfg(pconfig, throttle_inlet_c=1e6))
    for be in P.BACKENDS:
        c = cfg.replace(backend=be)
        final, _ = P.simulate(*port_tables(), CI, c, device="cpu",
                              dyn={**run_dyn(True),
                                   "failure_hazard_scale": 0.0})
        got = P.result_to_numpy(P.summarize(final, c))
        open_cfg = c.replace(failures=pconfig.FailureConfig(),
                             resilience=pconfig.ResilienceConfig())
        final, _ = P.simulate(*port_tables(), CI, open_cfg, device="cpu",
                              dyn=run_dyn(True))
        want = P.result_to_numpy(P.summarize(final, open_cfg))
        assert got["n_interrupts"] == got["derate_h"] == 0.0
        assert_close(got, want, 1e-5, 1e-4)


def test_seed_by_hazard_grid_matches_reference():
    """`seed_axis` x `failure_hazard_scale` x `interactive_frac` with
    priority levels (one presort a row) and reactive placement, against
    the reference's grid, both executors."""
    seeds = np.array([0, 7, -1])
    hz = np.array([0.0, 1.0, 2.5], np.float32)
    fr = np.array([0.0, 0.4], np.float32)

    def axes(M):
        return [M.seed_axis(seeds), M.dyn_axis(failure_hazard_scale=hz),
                M.dyn_axis(interactive_frac=fr)]

    cj = run_cfg(jconfig, "reactive", True).replace(
        scheduler=jconfig.SchedulerConfig(priority_levels=3))
    want = J.sweep_grid(J_TASKS, J_HOSTS, cj, axes(J), ci_trace=CI,
                        dyn=run_dyn(True))
    want = {k: np.asarray(v) for k, v in want._asdict().items()
            if v is not None}
    assert want["n_interrupts"].shape == (3, 3, 2)
    for be in P.BACKENDS:
        cp = run_cfg(pconfig, "reactive", True, backend=be).replace(
            scheduler=pconfig.SchedulerConfig(priority_levels=3))
        got = P.result_to_numpy(P.sweep_grid(
            *port_tables(), cp, axes(P), ci_trace=CI, dyn=run_dyn(True),
            device="cpu"))
        assert_close(got, want, 1e-4, 1e-4)
    # hazard 0 fails nothing, and the seeds differ where failures happen
    assert (want["n_interrupts"][:, 0] == 0).all()
    assert len({float(x) for x in want["n_interrupts"][:, 2, 0]}) > 1
