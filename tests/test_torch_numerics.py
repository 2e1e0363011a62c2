"""The port's f32 arithmetic at the reference's divisions by a constant, its
per-host sums, and the simulator's leftover public functions, against the
reference package.

Under `jax.jit` XLA computes `x / c`, with `c` known at compile time, as
`x * (1 / c)` (the reciprocal rounded once in f32), and the reference's
simulator and its Pallas kernels (in interpret mode) run jitted.  The port
takes the same product (`config.inv_f32`), so each site below is held to
the jitted reference bit for bit on 10^5 random f32 inputs; a division by a
traced value (the chiller's COP) stays IEEE on both sides.  XLA on the CPU
also contracts a multiply and an add into one fused multiply-add and folds
chains of constant additions (`wb + approach + lift - sp` becomes `wb +
(approach + lift - sp)`), which the port does not (PyTorch's CPU kernels;
the CUDA kernels build with --fmad=false).  Where a site's function holds
such an expression (the power curves' `idle + span * f(u)`, the COP's
lift, the SoC update), the tests hold the quotients themselves bit for bit
(inputs on which the expression is exact, or the outputs that carry the
quotient) and the rest within 4 ulps (3 measured).
The per-host sums of `ops.per_host_sum` (the scheduler's call on the task
table's columns) are bit-equal on the CPU to `jax.ops.segment_sum`, which
the reference takes above 256 hosts; at 256 and fewer it takes a one-hot
matmul, held to the reference's own margin
(tests/test_megakernel.py: rtol 1e-6, atol 1e-5).  The card's kernel for
these sums (repeatable run to run, the CPU's bits) is held to the plain
version in tests/test_torch_card.py, which imports no JAX.
"""
from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.config as JC
from repro.core import battery as jbattery
from repro.core import carbon as jcarbon
from repro.core import engine as jengine
from repro.core import power as jpower
from repro.core import scheduler as jscheduler
from repro.core import thermal as jthermal
from repro.core.state import BatteryState as JBatteryState
from repro.kernels import fused_step as jfused
from repro.kernels import power_carbon as jpc
import repro_torch.core.config as PC
from repro_torch.core import battery as pbattery
from repro_torch.core import carbon as pcarbon
from repro_torch.core import engine as pengine
from repro_torch.core import power as ppower
from repro_torch.core import scheduler as pscheduler
from repro_torch.core import state as pstate
from repro_torch.core import thermal as pthermal
from repro_torch.core.state import BatteryState as PBatteryState
from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
N = 100_000
T = torch.tensor


def _u(seed, lo, hi, n=N):
    return np.random.default_rng(seed).uniform(lo, hi, n).astype(np.float32)


def _bits(got, want, what=""):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got, want, err_msg=what)


# ---------------------------------------------------------------------------
# divisions by a constant
# ---------------------------------------------------------------------------

def test_inv_f32_is_the_jitted_quotient():
    x = _u(0, -50.0, 50.0)
    for c in (1000.0, 6.0, 0.1, 1 / 6, 3.0):
        want = jax.jit(lambda v, c=c: v / c)(x)
        _bits(T(x) * PC.inv_f32(c), want, str(c))


@pytest.mark.parametrize("setpoint", [None, 22.5])
def test_economizer_fraction_bit_for_bit(setpoint):
    wb = _u(1, 5.0, 35.0)
    jcfg, pcfg = JC.CoolingConfig(enabled=True), PC.CoolingConfig(enabled=True)
    if setpoint is None:
        want = jax.jit(lambda w: jthermal.economizer_fraction(w, jcfg))(wb)
        got = pthermal.economizer_fraction(T(wb), pcfg)
    else:  # a traced setpoint (a grid axis): the range stays a constant
        want = jax.jit(lambda w, s: jthermal.economizer_fraction(
            w, jcfg, setpoint_c=s))(wb, np.float32(setpoint))
        got = pthermal.economizer_fraction(T(wb), pcfg,
                                           setpoint_c=T(np.float32(setpoint)))
    _bits(got, want)
    # the eager reference divides IEEE-exactly: the test tells them apart
    eager = jthermal.economizer_fraction(jnp.asarray(wb), jcfg)
    if setpoint is None:
        assert (np.asarray(eager) != np.asarray(want)).sum() > 1000


def test_cooling_step_within_the_contractions():
    """cooling_step: its economizer fraction is the product above (bit for
    bit, test_economizer_fraction_bit_for_bit); the COP's folded lift and
    the contracted sums move cooling and water by at most 4 ulps."""
    it, wb = _u(2, 100.0, 1500.0), _u(3, 5.0, 35.0)
    jcfg, pcfg = JC.CoolingConfig(enabled=True), PC.CoolingConfig(enabled=True)
    want = jax.jit(lambda i, w: jthermal.cooling_step(i, w, jcfg))(it, wb)
    got = pthermal.cooling_step(T(it), T(wb), pcfg)
    for g, w in zip(got, want):
        np.testing.assert_array_max_ulp(g.numpy(), np.asarray(w), 4)


def test_operational_carbon_bit_for_bit():
    e, ci = _u(4, 0.0, 500.0), _u(5, 20.0, 900.0)
    want = jax.jit(jcarbon.operational_carbon_kg)(e, ci)
    _bits(pcarbon.operational_carbon_kg(T(e), T(ci)), want)


def test_facility_totals_op_carbon_bit_for_bit():
    """engine.facility_totals_from_flows's `/ 1000.0`, one-step rows (so the
    sums of the two packages are the same single value)."""
    grid, ci = _u(6, 0.0, 2000.0), _u(7, 20.0, 900.0)
    keys = ("it_kw", "cooling_kw", "batt_discharge_kw", "water_l_per_h",
            "heat_reuse_kw", "pv_kw", "grid_export_kw", "curtailed_kw",
            "soc")
    jcfg = JC.SimConfig(pricing=JC.PricingConfig(enabled=False))
    pcfg = PC.SimConfig(pricing=PC.PricingConfig(enabled=False))

    def one(g, c):
        flows = {k: jnp.zeros(1) for k in keys}
        flows.update(grid_import_kw=g[None],
                     want_charge=jnp.zeros(1, bool))
        return jengine.facility_totals_from_flows(
            flows, SimpleNamespace(ci=c[None], price=c[None]),
            jcfg)["op_carbon"]

    want = jax.jit(jax.vmap(one))(grid, ci)
    flows = {k: torch.zeros(N, 1) for k in keys}
    flows.update(grid_import_kw=T(grid)[:, None],
                 want_charge=torch.zeros(N, 1, dtype=torch.bool))
    got = pengine.facility_totals_from_flows(flows, T(ci)[:, None], None,
                                             pcfg)["op_carbon"]
    _bits(got, want)


def _power_inputs(seed, n, dyadic=False):
    """Utilizations (k / 64 with `dyadic`: the linear and square curves'
    `idle + span * f(u)` is then exact, so XLA's fused multiply-add changes
    nothing), GPU counts and on flags."""
    rng = np.random.default_rng(seed)
    if dyadic:
        u = lambda: rng.integers(-3, 68, n) / np.float32(64)  # noqa: E731
    else:
        u = lambda: rng.uniform(-0.05, 1.05, n)  # noqa: E731
    return (u().astype(np.float32), u().astype(np.float32),
            rng.integers(0, 5, n).astype(np.float32),
            (rng.uniform(size=n) < 0.8).astype(np.float32))


@pytest.mark.parametrize("curves", [("sqrt", "linear"), ("linear", "square")])
def test_host_power_bit_for_bit_with_the_reference_kernel(curves):
    """power.host_power_kw (associated as the Pallas kernel's power block)
    against the jitted kernel's per-host power, 25 rows of 4096 hosts:
    linear and square curves at dyadic utilizations bit for bit (the `/
    1000`), every curve at random ones within 4 ulps."""
    jcpu = JC.PowerModelConfig(80.0, 250.0, curves[0])
    jgpu = JC.PowerModelConfig(40.0, 300.0, curves[1])
    pcpu = PC.PowerModelConfig(80.0, 250.0, curves[0])
    pgpu = PC.PowerModelConfig(40.0, 300.0, curves[1])
    kw = dict(cpu_idle=jcpu.idle_w, cpu_max=jcpu.max_w, cpu_curve=curves[0],
              gpu_idle=jgpu.idle_w, gpu_max=jgpu.max_w, gpu_curve=curves[1])
    exact = "sqrt" not in curves and "cubic" not in curves
    for r in range(25):
        x = _power_inputs(10 + r, 4096, dyadic=r % 2 == 0)
        want, _, _ = jpc.fused_power_carbon(*x, 400.0, 0.25, **kw)
        got = ppower.host_power_kw(*(T(a) for a in x), pcpu, pgpu)
        if exact and r % 2 == 0:
            _bits(got, want, f"row {r}")
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), 4)


def test_facility_power_tail_bit_for_bit_with_the_reference_kernel():
    """Kernel 2 on one host at a dyadic utilization on linear and square
    curves: the IT sum (that host's power, the `/ 1000`) bit for bit; the
    cooling tail (thermal.py's model: the economizer's product, the COP's
    folded lift) within 4 ulps."""
    cool = JC.CoolingConfig(enabled=True)
    pcool = PC.CoolingConfig(enabled=True)
    kw = dict(cpu_idle=80.0, cpu_max=250.0, cpu_curve="linear",
              gpu_idle=40.0, gpu_max=300.0, gpu_curve="square",
              econ_range=cool.economizer_range_c,
              tower_approach=cool.tower_approach_c,
              condenser_lift=cool.condenser_lift_c,
              carnot_eff=cool.carnot_efficiency, max_cop=cool.max_cop,
              fan_overhead=cool.fan_pump_overhead,
              evap_l_per_kwh=cool.evap_l_per_kwh_heat)
    pm = (PC.PowerModelConfig(80.0, 250.0, "linear"),
          PC.PowerModelConfig(40.0, 300.0, "square"))
    wb, sp = _u(20, 5.0, 35.0, 400), _u(21, 18.0, 27.0, 400)
    cu, gu, ng, _ = _power_inputs(22, 400, dyadic=True)
    for i in range(400):
        x = (cu[i:i + 1], gu[i:i + 1], ng[i:i + 1], np.ones(1, np.float32))
        _, it, c, w = jpc.fused_facility_power(*x, wb[i], sp[i], **kw)
        _, pit, pc_, pw = ref.fused_facility_power(
            *(T(a) for a in x), T(wb[i]), T(sp[i]), *pm, pcool)
        _bits(pit.reshape(()), it, f"it {i}")
        for g, want in ((pc_, c), (pw, w)):
            np.testing.assert_array_max_ulp(g.reshape(()).numpy(),
                                            np.asarray(want), 4)


@pytest.mark.parametrize("dt_h", [0.1, 0.25])
def test_battery_flow_step_quotients_bit_for_bit(dt_h):
    rng = np.random.default_rng(30)
    cap = 500.0
    charge = rng.uniform(0.0, cap, N).astype(np.float32)
    was = rng.uniform(size=N) < 0.5
    load, ci = _u(31, 0.0, 800.0), _u(32, 20.0, 900.0)
    thr, rising = _u(33, 20.0, 900.0), rng.uniform(size=N) < 0.5
    jcfg = JC.BatteryConfig(enabled=True, capacity_kwh=cap)
    pcfg = PC.BatteryConfig(enabled=True, capacity_kwh=cap)

    def fn(c, wc, l, i, t, r):
        return jbattery.battery_flow_step(JBatteryState(c, wc), l, i, t, r,
                                          dt_h, jcfg)

    (st, ck, dk) = jax.jit(fn)(charge, was, load, ci, thr, rising)
    pst, pck, pdk = pbattery.battery_flow_step(
        PBatteryState(T(charge), T(was)), T(load), T(ci), T(thr), T(rising),
        dt_h, pcfg)
    for g, w, k in ((pck, ck, "charge_kw"), (pdk, dk, "discharge_kw"),
                    (pst.was_charging, st.was_charging, "was_charging")):
        _bits(g, w, k)
    # the SoC update `charge + (ck * eff - dk) * dt`, which XLA contracts:
    # within an ulp of the capacity
    np.testing.assert_allclose(pst.charge.numpy(), np.asarray(st.charge),
                               rtol=0.0, atol=float(np.spacing(np.float32(cap))))


def _chain_cfgs(dt_h, s):
    """(reference, port) configurations of the facility chain with cooling,
    PV and pricing off: the chain's inputs are then exact."""
    return tuple(M.SimConfig(
        dt_h=dt_h, n_steps=s, cooling=M.CoolingConfig(enabled=False),
        renewables=M.RenewableConfig(enabled=False),
        pricing=M.PricingConfig(enabled=False),
        battery=M.BatteryConfig(enabled=True, capacity_kwh=300.0))
        for M in (JC, PC))


def test_facility_chain_quotients_bit_for_bit_with_the_reference_kernel():
    """Kernel 3's `(cap - soc) / dt` and `soc / dt` at a step of 0.1 h,
    where the product with the reciprocal and IEEE division differ: one
    step from 300 initial SoCs, whose charge or discharge is the quotient
    (or the rate); the plain chain's grid energy and discharged energy
    against the jitted reference kernel's, bit for bit."""
    jcfg, pcfg = _chain_cfgs(0.1, 1)
    rng = np.random.default_rng(41)
    ones = np.ones(1, np.float32)
    for r in range(300):
        soc0 = np.float32(rng.uniform(0.0, 300.0))
        charge = r % 2 == 0   # below the threshold: charge, else discharge
        args = (np.float32([rng.uniform(20.0, 9000.0)]),
                np.float32([100.0 if charge else 500.0]), ones * 15.0, ones,
                ones, ones, ones * 0.0, np.float32([300.0]),
                np.zeros(1, bool))
        want = jfused.fused_facility_totals(*args, cfg=jcfg, soc0=soc0,
                                            trace_store="f32")
        got = ref.fused_facility_totals(*(T(a) for a in args), pcfg,
                                        soc0=float(soc0))
        for k in ("grid_energy", "batt_discharged"):
            _bits(got[k], want[k], f"row {r} {k}")


def test_facility_chain_soc_bit_for_bit_with_the_reference_kernel():
    """300 steps at 0.25 h (the main path's step, where the SoC update's
    product is exact, so XLA's contraction changes nothing): the plain
    chain's last SoC, decision and peak equal the jitted reference
    kernel's."""
    s = 300
    jcfg, pcfg = _chain_cfgs(0.25, s)
    rng = np.random.default_rng(40)
    for r in range(3):
        it = rng.uniform(20.0, 400.0, s).astype(np.float32)
        ci = rng.uniform(50.0, 600.0, s).astype(np.float32)
        ones = np.ones(s, np.float32)
        thr = np.full(s, 300.0, np.float32)
        rising = rng.uniform(size=s) < 0.3
        args = (it, ci, ones * 15.0, ones, ones, ones, ones * 0.0, thr,
                rising)
        want = jfused.fused_facility_totals(*args, cfg=jcfg,
                                            trace_store="f32")
        got = ref.fused_facility_totals(*(T(a) for a in args), pcfg)
        for k in ("soc_final", "was_charging", "peak_power"):
            _bits(got[k], want[k], f"row {r} {k}")


# ---------------------------------------------------------------------------
# per-host sums
# ---------------------------------------------------------------------------

def _tasks(seed, b, t, h, running=0.3, shared="own", lo=-1, hi=None):
    """Task columns: status and host [B, T] ([T] for b = 0; a RUNNING task
    may carry host -1, and hosts up to `hi` - 1 are clipped into h), cores
    and utilizations [B, T] ("own", a grid's written rows' width), or one
    row shared by the rows, [T] ("flat") or [1, T] ("row")."""
    rng = np.random.default_rng(seed)
    shape = (b, t) if b else (t,)
    vshape = {"own": shape, "flat": (t,), "row": (1, t)}[shared]
    status = np.where(rng.uniform(size=shape) < running, pscheduler.RUNNING,
                      pscheduler.PENDING).astype(np.int32)
    host = rng.integers(lo, h if hi is None else hi, shape).astype(np.int32)
    cores = rng.choice(np.float32([4, 8, 16, 32, 48]), vshape)
    gpus = rng.integers(0, 5, vshape).astype(np.float32)
    utils = [rng.uniform(size=vshape).astype(np.float32) for _ in range(2)]
    return status, host, cores, gpus, utils


def _segment_sums(status, host, v, h):
    """The reference's sums: jax.ops.segment_sum of the running, placed
    tasks' values over the clipped hosts, row by row."""
    run = (status == pscheduler.RUNNING) & (host >= 0)
    v = np.where(run, np.broadcast_to(v, run.shape), np.float32(0))
    seg = np.clip(host, 0, h - 1)
    if run.ndim == 2:
        return jax.vmap(lambda x, s: jax.ops.segment_sum(x, s, h))(v, seg)
    return jax.ops.segment_sum(v, seg, h)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("b,shared", [(0, "flat"), (3, "own"), (3, "flat"),
                                      (3, "row")])
def test_per_host_sum_bit_equal_to_segment_sum(b, shared, weighted):
    """Above 256 hosts: the CPU's sums (`ops.per_host_sum` from the task
    table's columns, the scheduler's call) are jax.ops.segment_sum's bits,
    integer and fractional values, [T] and [B, T] rows, written [B, T]
    value columns and shared [T] / [1, T] ones, with and without
    utilization weights (the product rounded to f32 first)."""
    h, t = 972, 20_000
    status, host, cores, gpus, utils = _tasks(50 + b, b, t, h,
                                              shared=shared)
    w = [T(u) for u in utils] if weighted else [None, None]
    got = ops.per_host_sum(T(status), T(host), T(cores), T(gpus), h, *w)
    for g, v, u in zip(got, (cores, gpus), utils):
        _bits(g, _segment_sums(status, host, v * u if weighted else v, h))


@pytest.mark.parametrize("case", ["host_minus_one", "host_past_h", "empty",
                                  "all_running_few_hosts"])
def test_per_host_sum_edges_bit_equal_to_segment_sum(case):
    """A RUNNING task carrying host -1 adds nothing (it is not billed to
    host 0); hosts >= h are clipped into the last host, as the reference
    clips; T = 0 gives zeros; every task running on 3 of 972 hosts."""
    h, t, b = 972, 5_000, 2
    kw = {"host_minus_one": dict(running=1.0, lo=-1, hi=2),
          "host_past_h": dict(lo=h - 3, hi=h + 40),
          "empty": dict(), "all_running_few_hosts": dict(running=1.0, lo=0,
                                                         hi=3)}[case]
    status, host, cores, gpus, utils = _tasks(
        7, b, 0 if case == "empty" else t, h, shared="row", **kw)
    got = ops.per_host_sum(T(status), T(host), T(cores), T(gpus), h,
                           T(utils[0]), T(utils[1]))
    for g, v, u in zip(got, (cores, gpus), utils):
        assert g.shape == (b, h)
        _bits(g, _segment_sums(status, host, v * u, h))
    if case == "host_minus_one":
        assert bool((got[0][:, 2:] == 0).all()) and float(got[0].sum()) > 0
    if case == "empty":
        assert not bool(got[0].any()) and not bool(got[1].any())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("h", [3, 17, 256])
def test_per_host_sum_within_the_reference_margin_at_few_hosts(h, weighted):
    """At 256 hosts and fewer the reference takes a one-hot matmul; the
    port's task-order sums hold its own margin (rtol 1e-6, atol 1e-5)."""
    status, host, cores, gpus, utils = _tasks(60 + h, 0, 257 * 8, h,
                                              shared="flat")
    w = [T(u) for u in utils] if weighted else [None, None]
    got = ops.per_host_sum(T(status), T(host), T(cores), T(gpus), h, *w)
    run = (status == pscheduler.RUNNING) & (host >= 0)
    jseg = jnp.asarray(np.clip(host, 0, h - 1))
    for g, v, u in zip(got, (cores, gpus), utils):
        v = v * u if weighted else v
        want = jscheduler._per_host_sum(np.where(run, v, np.float32(0)),
                                        jseg, h)
        np.testing.assert_allclose(g.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-5)


@pytest.mark.parametrize("b", [0, 4])
def test_scheduler_sums_bit_equal_to_the_reference_scheduler(b):
    """`free_capacity` and `host_utilization` of the port against the
    reference's on the same table (972 hosts, a [B, T] table as rows of
    the reference's, vmapped): free cores and GPUs bit for bit, the
    utilizations within 2 ulps (the reference's jitted divide may take a
    reciprocal)."""
    from repro.core import state as jstate
    h, t = 972, 6_000
    rng = np.random.default_rng(90 + b)
    jtasks = jstate.make_task_table(
        rng.uniform(0, 10, t).astype(np.float32),
        rng.uniform(1, 5, t).astype(np.float32),
        rng.choice(np.float32([4, 8, 16]), t),
        gpus=rng.integers(0, 3, t).astype(np.float32),
        cpu_util=rng.uniform(size=t).astype(np.float32),
        gpu_util=rng.uniform(size=t).astype(np.float32))
    jhosts = jstate.make_host_table(h, 48.0, 4.0, n_active=750)
    shape = (b, t) if b else (t,)
    status = np.where(rng.uniform(size=shape) < 0.3, pscheduler.RUNNING,
                      pscheduler.PENDING).astype(np.int32)
    host = rng.integers(-1, h, shape).astype(np.int32)
    np_tasks = {k: np.asarray(v) for k, v in jtasks._asdict().items()}
    ptasks, phosts = pstate.tables_from_numpy(
        np_tasks, {k: np.asarray(v) for k, v in jhosts._asdict().items()},
        device="cpu")
    if b:
        ptasks, phosts = pstate.cell_tables(ptasks, phosts, b)
    ptasks = ptasks._replace(status=T(status), host=T(host))
    for name in ("free_capacity", "host_utilization"):
        fn = getattr(jscheduler, name)
        if b:
            want = jax.vmap(lambda s, hh: fn(jtasks._replace(
                status=s, host=hh), jhosts))(status, host)
        else:
            want = fn(jtasks._replace(status=jnp.asarray(status),
                                      host=jnp.asarray(host)), jhosts)
        got = getattr(pscheduler, name)(ptasks, phosts)
        for g, w in zip(got, want):
            g = g.numpy().reshape(np.shape(w))
            if name == "free_capacity":
                _bits(g, w, name)
            else:
                np.testing.assert_array_max_ulp(g, np.asarray(w), 2)


# ---------------------------------------------------------------------------
# the leftover public functions (ROADMAP item 3c)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("present", [False, True])
@pytest.mark.parametrize("model", ["linear", "sqrt", "square", "cubic"])
def test_component_power_kw_matches_reference(model, present):
    """Bit for bit where `idle + span * f(u)` is exact (linear and square
    curves at dyadic utilizations: the `/ 1000` alone), else within 4 ulps
    (XLA's contraction of it)."""
    jcfg = JC.PowerModelConfig(70.0, 310.0, model)
    pcfg = PC.PowerModelConfig(70.0, 310.0, model)
    for dyadic in (True, False):
        u, _, ng, _ = _power_inputs(70, N, dyadic=dyadic)
        if present:
            want = jax.jit(lambda x, p: jpower.component_power_kw(
                x, jcfg, p))(u, ng)
            got = ppower.component_power_kw(T(u), pcfg, T(ng))
        else:
            want = jax.jit(lambda x: jpower.component_power_kw(x, jcfg))(u)
            got = ppower.component_power_kw(T(u), pcfg)
        if dyadic and model in ("linear", "square"):
            _bits(got, want)
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(want), 4)
    with pytest.raises(ValueError, match="unknown power model"):
        ppower.component_power_kw(T(u), PC.PowerModelConfig(model="x"))


@pytest.mark.parametrize("model", ["linear", "sqrt", "square", "cubic"])
def test_calibrate_power_model_and_mape_match_reference(model):
    rng = np.random.default_rng(80)
    u = rng.uniform(-0.1, 1.1, 500)
    f = {"linear": u, "sqrt": np.sqrt(np.clip(u, 0, 1)),
         "square": np.clip(u, 0, 1) ** 2, "cubic": np.clip(u, 0, 1) ** 3}
    watts = 90.0 + 160.0 * f[model] + rng.normal(0.0, 3.0, 500)
    want = jpower.calibrate_power_model(u, watts, model=model)
    got = ppower.calibrate_power_model(u, watts, model=model)
    assert (got.idle_w, got.max_w, got.model) == (want.idle_w, want.max_w,
                                                   want.model)
    pred = got.idle_w + (got.max_w - got.idle_w) * f[model]
    assert ppower.mape(pred, watts) == jpower.mape(pred, watts)
    actual = np.array([0.0, 2.0, -4.0, 1e-12])
    assert ppower.mape(np.ones(4), actual) == jpower.mape(np.ones(4), actual)


@pytest.mark.parametrize("enabled", [False, True])
def test_battery_step_matches_reference(enabled):
    rng = np.random.default_rng(90)
    n = 2_000
    charge = rng.uniform(0.0, 400.0, n).astype(np.float32)
    was = rng.uniform(size=n) < 0.5
    dc, ci = _u(91, 0.0, 800.0, n), _u(92, 20.0, 900.0, n)
    thr, rising = _u(93, 20.0, 900.0, n), rng.uniform(size=n) < 0.5
    jcfg = JC.BatteryConfig(enabled=enabled, capacity_kwh=400.0)
    pcfg = PC.BatteryConfig(enabled=enabled, capacity_kwh=400.0)

    def fn(c, wc, d, i, t, r):
        return jbattery.battery_step(JBatteryState(c, wc), d, i, t, r, 0.1,
                                     jcfg)

    st, grid, dis = jax.jit(fn)(charge, was, dc, ci, thr, rising)
    pst, pgrid, pdis = pbattery.battery_step(
        PBatteryState(T(charge), T(was)), T(dc), T(ci), T(thr), T(rising),
        0.1, pcfg)
    _bits(pgrid, grid, "grid")
    _bits(pdis, dis, "discharged")
    _bits(pst.was_charging, st.was_charging, "was_charging")
    # the SoC update, which XLA contracts: within an ulp of the capacity
    np.testing.assert_allclose(pst.charge.numpy(), np.asarray(st.charge),
                               rtol=0.0, atol=float(np.spacing(np.float32(400.0))))
