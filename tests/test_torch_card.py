"""The port's hand-written kernels and its main path on the card.

Every test here needs an NVIDIA GPU: it carries the `cuda` marker and skips
itself (inside the `cuda_device` fixture) where `torch.cuda.is_available()`
is false.  The file imports neither JAX nor the reference package, so it
runs on a machine that has only the port's dependencies (`--noconftest`:
tests/conftest.py imports JAX):

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_card.py

Each kernel meets its plain version (repro_torch/kernels/ref.py, held to the
reference package by the CPU tests) on the same CUDA inputs, at the CPU
tests' tolerances; a whole simulation on the card meets the same one on the
CPU, with exact launch counts, and so does a scenario grid (one launch a
step for all its cells) and a run with host failures and the resilience
loop (threefry draws bit for bit, kernel 3's derate route), and so do
aggregate scheduling (no first-fit launch), a task-trace grid and the §III
analytical model, and a run with the probe bus (kernel 3's series route,
held bit for bit to the plain chain on the CPU); a reduced zamba2 / mamba2
prefill launches exactly its SSD and flash kernels, and serving never waits
for the card; the kernel entries refuse a tensor that requires grad, and a
train step launches no kernel and gives the CPU's loss.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core as P
import repro_torch.core.config as C
from repro_torch.kernels import ops, ref

S = 96
DT = 0.25


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")
    return torch.device("cuda")


def _host_inputs(h, seed, dev):
    rng = np.random.default_rng(seed)
    return [torch.tensor(x, device=dev) for x in (
        rng.uniform(0, 1, h).astype(np.float32),
        rng.uniform(0, 1, h).astype(np.float32),
        rng.integers(0, 4, h).astype(np.float32),
        (rng.uniform(size=h) < 0.8).astype(np.float32))]


@pytest.mark.cuda
@pytest.mark.parametrize("h", [7, 972, 1025, 2048, 4096])
def test_power_kernels_match_plain(cuda_device, h):
    from repro_torch.kernels import power_carbon as pc
    d = cuda_device
    cpu_u, gpu_u, ngpu, on = _host_inputs(h, h, d)
    cpu = C.PowerModelConfig(80.0, 250.0, "sqrt")
    gpu = C.PowerModelConfig(40.0, 300.0, "linear")
    ci = torch.tensor(350.0, device=d)
    got = pc.fused_power_carbon(cpu_u, gpu_u, ngpu, on, ci, 0.25, cpu, gpu)
    want = ref.fused_power_carbon(cpu_u, gpu_u, ngpu, on, ci, 0.25, cpu, gpu)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=0.0)
    wb, sp = torch.tensor(27.0, device=d), torch.tensor(24.0, device=d)
    cool = C.CoolingConfig(enabled=True)
    got = pc.fused_facility_power(cpu_u, gpu_u, ngpu, on, wb, sp, cpu, gpu,
                                  cool)
    want = ref.fused_facility_power(cpu_u, gpu_u, ngpu, on, wb, sp, cpu, gpu,
                                    cool)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("h", [7, 972, 1025, 4096])
def test_power_kernel_without_carbon_matches_plain(cuda_device, h):
    """The megakernel's call (ops.host_power, `ci` None): per-host power
    and its sum as the plain version's, carbon 0."""
    from repro_torch.kernels import power_carbon as pc
    cpu_u, gpu_u, ngpu, on = _host_inputs(h, h + 1, cuda_device)
    cpu = C.PowerModelConfig(80.0, 250.0, "cubic")
    gpu = C.PowerModelConfig(40.0, 300.0, "square")
    got = pc.fused_power_carbon(cpu_u, gpu_u, ngpu, on, None, 0.25, cpu, gpu)
    want = ref.fused_power_carbon(cpu_u, gpu_u, ngpu, on, None, 0.25, cpu,
                                  gpu)
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got[1], want[1], rtol=1e-4, atol=0.0)
    assert bool((got[2] == 0).all())
    p, it = ops.host_power(cpu_u, gpu_u, ngpu, on, cpu, gpu)
    assert torch.equal(p, got[0]) and torch.equal(it, got[1])


def _ff_inputs(k, h, seed, case, dev):
    """Candidates and free vectors with many ties: every slot live ("live"),
    the scheduler's inert tail with down (-inf) hosts and zero GPU demands
    ("inert"), or every host down ("down")."""
    rng = np.random.default_rng(seed)
    cc = rng.integers(1, 8, k).astype(np.float32)
    cg = rng.integers(0, 2, k).astype(np.float32)
    fc = rng.integers(0, 16, h).astype(np.float32)
    fg = rng.integers(0, 4, h).astype(np.float32)
    if case in ("inert", "down"):
        cc[k // 2:] = cg[k // 2:] = np.inf   # the scheduler's inert tail
        cg[:max(k // 8, 1)] = 0.0            # zero-footprint GPU demand
        down = (rng.uniform(size=h) < 0.2) | (case == "down")
        fc[down] = fg[down] = -np.inf        # unusable hosts
    return [torch.tensor(x, device=dev) for x in (cc, cg, fc, fg)]


def _assert_same_placement(got, want):
    """Assignments equal, free vectors bit for bit (inf patterns too)."""
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["live", "inert", "down"])
@pytest.mark.parametrize("k", [4, 64, 100])
@pytest.mark.parametrize("h", [1, 3, 31, 32, 972, 1024, 1025, 2048])
def test_first_fit_kernel_matches_plain(cuda_device, k, h, case):
    """Both variants (one warp a row up to 1024 hosts, one block a row
    beyond) on both sides of each boundary of the warp's layout."""
    from repro_torch.kernels import first_fit as ff
    args = _ff_inputs(k, h, k * h, case, cuda_device)
    got = ff.first_fit_place(*args)
    _assert_same_placement(got, ref.first_fit_place(*args))
    if case == "down":
        assert bool((got[0] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("h", [972, 2048])
def test_first_fit_kernel_rows_match_plain(cuda_device, h):
    """B = 3 rows of different data in one launch, each row its own."""
    from repro_torch.kernels import first_fit as ff
    rows = [_ff_inputs(64, h, s, "inert", cuda_device) for s in range(3)]
    args = [torch.stack(x) for x in zip(*rows)]
    got = ff.first_fit_place(*args)
    for i in range(3):
        _assert_same_placement([g[i] for g in got],
                               ref.first_fit_place(*rows[i]))


def _traces(seed: int, s: int = S):
    rng = np.random.default_rng(seed)
    t = np.arange(s) * DT
    ci = (rng.uniform(50, 600)
          * (1 + 0.5 * np.sin(2 * np.pi * t / 24 + rng.uniform(0, 6)))
          + rng.normal(0, 10, s)).clip(5.0).astype(np.float32)
    price = (0.1 * (1 + 0.5 * np.sin(2 * np.pi * t / 24))).astype(np.float32)
    wb = (14.0 + 6.0 * np.sin(2 * np.pi * t / 24)).astype(np.float32)
    cf = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0, 1.0).astype(
        np.float32)
    return ci, {"price_trace": price, "wet_bulb_trace": wb,
                "pv_cf_trace": cf}


def _cfg(**kw):
    return C.SimConfig(
        n_steps=S,
        cooling=C.CoolingConfig(enabled=True, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=True, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=True, pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=True, capacity_kwh=6.0,
                                policy="blended", price_window_h=24.0),
        shifting=C.ShiftingConfig(enabled=True), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_facility_kernel_matches_plain(cuda_device, store):
    from repro_torch.kernels import fused_step as fs
    ci, dyn = _traces(7)
    cfg = _cfg()
    x = P.build_step_inputs(ci, cfg, dyn, device=cuda_device)
    it_kw = torch.tensor(np.random.default_rng(3).uniform(20.0, 80.0, S),
                         dtype=torch.float32, device=cuda_device)
    args = (it_kw, x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
            x.pv_cf, x.batt_threshold, x.ci_rising)
    got = fs.fused_facility_totals(*args, cfg, trace_store=store)
    want = ref.fused_facility_totals(*args, cfg, trace_store=store)
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k].double(), want[k].double(),
                                   rtol=1e-4, atol=1e-3)


# [4, S] rows of different batteries (capacity kWh, rate kW, initial SoC),
# dispatch lambdas and PV capacities (kW); row 0's battery fills and empties
# in one step
ROWS = {"batt_capacity_kwh": (1.5, 6.0, 20.0, 60.0),
        "batt_rate_kw": (6.0, 3.0, 10.0, 40.0),
        "soc0": (0.0, 6.0, 10.0, 60.0),
        "dispatch_lambda": (0.0, 0.3, 0.7, 1.0),
        "pv_capacity_kw": (0.0, 10.0, 25.0, 100.0)}


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 255, 2880, 35040])
def test_facility_kernel_rows_match_plain(cuda_device, s):
    """Kernel 3 on the scenario grid's layout: one launch over [4, S] rows
    that differ in every per-row parameter, each row against the plain
    version (rtol 1e-4, atol 1e-3); S within one tile, across three and
    across 35 (a year at 15 minutes); a battery driven to its capacity and
    to 0."""
    from repro_torch.core.engine import facility_totals_from_flows
    from repro_torch.kernels import fused_step as fs
    d = cuda_device
    ci, dyn = _traces(11, s)
    cfg = _cfg().replace(n_steps=s)
    x = P.build_step_inputs(ci, cfg, dyn, device=d)
    it_kw = torch.tensor(np.random.default_rng(s).uniform(20.0, 80.0, (4, s)),
                         dtype=torch.float32, device=d)
    args = (x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi, x.pv_cf,
            x.batt_threshold, x.ci_rising)
    got = fs.fused_facility_totals(
        it_kw, *args, cfg,
        **{k: torch.tensor(v, device=d) for k, v in ROWS.items()})
    full = empty = False
    for r in range(4):
        kw = {k: v[r] for k, v in ROWS.items()}
        flows = ref.fused_facility_chain(it_kw[r], *args, cfg.dt_h, cfg, **kw)
        want = facility_totals_from_flows(flows, x.ci, x.price, cfg)
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k][r].double(), want[k].double(),
                                       rtol=1e-4, atol=1e-3)
        soc = flows["soc"]
        full |= bool((soc == kw["batt_capacity_kwh"]).any())
        empty |= bool(((soc[1:] == 0.0) & (soc[:-1] > 0.0)).any())
    assert s < 255 or (full and empty)


# rows at the edges of kernel 3's SoC chain (capacity kWh, rate kW, initial
# SoC): an initial SoC above the capacity (the charge's clamp at 0); a rate
# of 2^-100 kW from an empty battery, whose SoC stays in (0, 2^-100); the
# same from 40 x 2^-100 kWh; and the main path's battery
ROUTE_ROWS = {"batt_capacity_kwh": (60.0, 2.0 ** -60, 2.0 ** -60, 8748.0),
              "batt_rate_kw": (240.0, 2.0 ** -100, 2.0 ** -100, 2187.0),
              "soc0": (90.0, 0.0, 40 * 2.0 ** -100, 4374.0)}


def _demand_in_window_order(grid, ws, dc):
    """(demand charge, last window's peak) billed as the reference bills
    them: each window's peak taken from 0, the closed windows' charges
    added in window order in f32."""
    f = np.float32
    demand, peak = f(0), f(0)
    for w0 in range(0, len(grid), ws):
        if w0:
            demand = f(demand + f(peak * f(dc)))
        peak = max(f(0), grid[w0:w0 + ws].max())
    return demand, peak


@pytest.mark.cuda
@pytest.mark.parametrize("s,ws,dt", [
    (1, 96, 0.25), (90, 7, 0.1), (255, 33, 0.25), (2880, 1, 0.1),
    (2880, 96, 0.1), (3000, 5000, 2.0 ** -21)])
def test_facility_kernel_chain_matches_the_sequential_walk(cuda_device, s, ws,
                                                           dt):
    """Kernel 3's chain against a sequential walk, the plain version on the
    CPU (products with the step's f32 reciprocal, as the kernel's), with
    cooling and PV off so that the chain's inputs are exact: SoC, last
    decision, grid peak, last window's peak and the demand charge (windows
    billed in order) equal in f32; the other totals at rtol 1e-4, atol
    1e-3.  Tiles of 32, 96, 256 and 1024 steps; billing windows of 1, 7,
    33, 96 and 5000 steps (cut at tile edges, or longer than the run); the
    edge rows of ROUTE_ROWS at steps of 0.25, 0.1 and 2^-21 h."""
    from repro_torch.core.engine import facility_totals_from_flows
    from repro_torch.kernels import fused_step as fs
    d = cuda_device
    cfg = C.SimConfig(
        dt_h=dt, n_steps=s, cooling=C.CoolingConfig(enabled=False),
        renewables=C.RenewableConfig(enabled=False),
        pricing=C.PricingConfig(enabled=True, billing_window_h=ws * dt),
        battery=C.BatteryConfig(enabled=True, policy="carbon"))
    ci, dyn = _traces(11, s)
    dyn.pop("pv_cf_trace")
    x = P.build_step_inputs(ci, cfg, dyn, device="cpu")
    it_kw = torch.tensor(np.random.default_rng(s).uniform(20.0, 80.0, (4, s)),
                         dtype=torch.float32)
    args = (x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi, x.pv_cf,
            x.batt_threshold, x.ci_rising)
    acc = fs.launch(*fs.prepare(
        it_kw.to(d), *(a.to(d) for a in args), cfg,
        **{k: torch.tensor(v, device=d) for k, v in ROUTE_ROWS.items()}))
    acc = acc.cpu()
    got = fs.totals_from_rows(acc, cfg)
    for r in range(4):
        kw = {k: v[r] for k, v in ROUTE_ROWS.items()}
        flows = ref.fused_facility_chain(it_kw[r], *args, dt, cfg, **kw)
        want = facility_totals_from_flows(flows, x.ci, x.price, cfg)
        grid = flows["grid_import_kw"].numpy()
        want["demand_cost"], want["window_peak_kw"] = _demand_in_window_order(
            grid, ws, cfg.pricing.demand_charge_per_kw)
        assert set(got) == set(want)
        for k in want:
            g = got[k][r]
            if k in ("soc_final", "was_charging", "peak_power",
                     "window_peak_kw", "demand_cost"):
                assert g.item() == np.float32(want[k]).item(), k
            else:
                torch.testing.assert_close(g.double(), want[k].double(),
                                           rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_simulation_on_card_matches_cpu(cuda_device, backend):
    """A whole run through the kernels == the same run through the plain
    versions on the CPU: counts exact, the rest within rtol 1e-4."""
    from repro_torch.workloads import make_workload
    ci, dyn = _traces(11)
    cfg = _cfg(backend=backend)
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=1,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        ops.reset_launch_counts()
        final, _ = P.simulate(tasks, hosts, ci, cfg,
                              dyn={**dyn, "n_active_hosts": 20}, device=dev)
        results[dev.type] = P.result_to_numpy(P.summarize(final, cfg))
        counts = ops.launch_counts()
    want = {"first_fit_place": S, "per_host_sum": 2 * S}
    if backend == "megakernel":
        want.update(fused_power_carbon=S, fused_facility_totals=1)
    else:
        want["fused_facility_power"] = S
    assert {k: v for k, v in counts.items() if v} == want
    got, ref_res = results["cuda"], results["cpu"]
    assert ref_res["n_done"] > 0
    for k, v in ref_res.items():
        if k.startswith("n_") or k.startswith("class_n_"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_grid_on_card_matches_cpu(cuda_device, backend):
    """A 2 x 3 grid (carbon regions x battery sizes, every technique on)
    through the kernels == the same grid through the plain versions on the
    CPU, cell by cell: counts exact, the rest within rtol 1e-4.  Its six
    cells take each kernel's launches of one run."""
    from repro_torch.workloads import make_workload
    ci, dyn = _traces(11)
    axes = [P.trace_axis(np.stack([ci, _traces(12)[0]])),
            P.dyn_axis(batt_capacity_kwh=np.array([2.0, 20.0, 60.0]))]
    cfg = _cfg(backend=backend)
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=1,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        ops.reset_launch_counts()
        res = P.sweep_grid(tasks, hosts, cfg, axes,
                           dyn={**dyn, "n_active_hosts": 20}, device=dev)
        results[dev.type] = P.result_to_numpy(res)
        counts = ops.launch_counts()
    want = {"first_fit_place": S, "per_host_sum": 2 * S}
    if backend == "megakernel":
        want.update(fused_power_carbon=S, fused_facility_totals=1)
    else:
        want["fused_facility_power"] = S
    assert {k: v for k, v in counts.items() if v} == want
    got, ref_res = results["cuda"], results["cpu"]
    assert got["n_done"].shape == (2, 3) and (ref_res["n_done"] > 0).all()
    for k, v in ref_res.items():
        if k.startswith("n_") or k.startswith("class_n_"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("derate", [False, True])
def test_facility_series_route_matches_plain(cuda_device, store, derate):
    """Kernel 3's series route on [4, 2880] rows of different batteries:
    against the plain chain on the CPU (the step's reciprocal products, as
    the kernel's),
    reading the traces the kernel reads: `soc` and `want_charge` bit-equal,
    every flow within rtol 1e-4 / atol 1e-3, the derate echo equal; its
    totals bit-equal to the totals route's; one launch counted under its
    own name."""
    from repro_torch.kernels import fused_step as fs
    d, cpu, s = cuda_device, torch.device("cpu"), 2880
    ci, dyn = _traces(13, s)
    rcfg = C.ResilienceConfig(enabled=derate, chiller_mtbf_h=40.0,
                              chiller_repair_h=12.0)
    cfg = _cfg(resilience=rcfg).replace(n_steps=s)
    x = P.build_step_inputs(ci, cfg, dyn, device=d)
    it_kw = torch.tensor(np.random.default_rng(s).uniform(20.0, 80.0, (4, s)),
                         dtype=torch.float32, device=d)
    args = [it_kw, x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
            x.pv_cf, x.batt_threshold, x.ci_rising]
    kw = {k: torch.tensor(v, device=d) for k, v in ROWS.items()}
    if derate:
        kw["chiller_derate"] = x.chiller_derate
        assert bool((x.chiller_derate < 1.0).any())
    ops.reset_launch_counts()
    flows, totals = ops.fused_facility_chain(*args, cfg, trace_store=store,
                                             **kw)
    counts = ops.launch_counts()
    assert {k: v for k, v in counts.items() if v} == {
        "fused_facility_series": 1}
    route = fs.fused_facility_totals(*args, cfg, trace_store=store, **kw)
    for k, v in route.items():
        assert torch.equal(totals[k], v), k
    stored = [ref.stored_trace(a, store) if i in (1, 2, 3, 6) else a
              for i, a in enumerate(args)]
    want = ref.fused_facility_chain(
        *(a.to(cpu) for a in stored), DT, cfg,
        **{k: v.to(cpu) for k, v in kw.items()})
    for k in ("soc", "want_charge", "chiller_derate"):
        assert torch.equal(flows[k].cpu(), want[k].expand(4, s)), k
    for k in fs.SERIES_FIELDS:
        torch.testing.assert_close(flows[k].cpu(), want[k].expand(4, s),
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_probed_run_on_card_matches_cpu(cuda_device, backend):
    """A run with the probe bus (stride 3) through the kernels == the same
    run through the plain versions on the CPU: counts exact, the rest and
    the probes within rtol 1e-4; the megakernel's facility half takes the
    series route, and its totals equal the unprobed run's bit for bit."""
    from repro_torch.workloads import make_workload
    ci, dyn = _traces(11)
    cfg = _cfg(backend=backend,
               probes=C.ProbeConfig(enabled=True, stride=3))
    results, counts = {}, {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=1,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        ops.reset_launch_counts()
        final, _ = P.simulate(tasks, hosts, ci, cfg,
                              dyn={**dyn, "n_active_hosts": 20}, device=dev)
        results[dev.type] = P.result_to_numpy(P.summarize(final, cfg))
        counts[dev.type] = ops.launch_counts()
    want = {"first_fit_place": S, "per_host_sum": 2 * S}
    if backend == "megakernel":
        want.update(fused_power_carbon=S, fused_facility_series=1)
    else:
        want["fused_facility_power"] = S
    assert {k: v for k, v in counts["cuda"].items() if v} == want
    got, ref_res = results["cuda"], results["cpu"]
    for k, v in ref_res.items():
        if k == "probes":
            np.testing.assert_array_equal(got[k]["step"], v["step"])
            for f, pv in v.items():
                np.testing.assert_allclose(got[k][f], pv, rtol=1e-4,
                                           atol=1e-4, err_msg=f)
        elif k.startswith("n_") or k.startswith("class_n_"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_step_loop_never_waits_for_the_card(cuda_device, backend):
    """With inputs already on the card, `simulate` enqueues work and never
    reads a value back, with the probe bus off and on: PyTorch's sync
    debug mode raises on any operation that would make the host wait for
    the device."""
    from repro_torch.workloads import make_workload
    ci, dyn = _traces(5)
    to = lambda x: torch.tensor(x, device=cuda_device)  # noqa: E731
    dyn = {k: to(v) for k, v in dyn.items()}
    tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=2,
                                       horizon_days=S * DT / 24,
                                       device=cuda_device)
    ci = to(ci)
    cfg = _cfg(backend=backend)
    from repro_torch.kernels import build
    build.build_all()  # the first use builds and loads: not a device wait
    torch.cuda.synchronize()
    finals = []
    for c in (cfg, cfg.replace(probes=C.ProbeConfig(enabled=True,
                                                    stride=3))):
        torch.cuda.set_sync_debug_mode("error")
        try:
            final, _ = P.simulate(tasks, hosts, ci, c,
                                  dyn={**dyn, "n_active_hosts": 20},
                                  device=cuda_device)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        finals.append(P.summarize(final, c))
    assert float(finals[0].n_done) > 0
    assert finals[0].probes is None
    assert finals[1].probes.step.shape == (S // 3,)
    # the per-host sums' atomic adds move per-step IT by an ulp now and
    # then from run to run: counts exact, the rest within rtol 1e-5
    for f in finals[0]._fields[:-1]:
        a, b = getattr(finals[0], f), getattr(finals[1], f)
        if f.startswith("n_") or f.startswith("class_n_"):
            assert torch.equal(a, b), f
        else:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0.0)


def _fleet(n_regions: int = 3):
    """A fleet of `n_regions` synthetic carbon regions over the card tests'
    horizon, greedy placement under a core-hour cap."""
    from repro_torch.carbontraces import make_region_traces
    return P.FleetSpec(ci_traces=make_region_traces(S, DT, n_regions,
                                                    seed=3),
                       capacity_frac=1.5)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_fleet_on_card_matches_cpu(cuda_device, backend):
    """A 3-region fleet and a fleet grid (2 host plans x 3 regions) through
    the kernels == the same on the CPU (counts exact, the rest rtol 1e-4);
    each launches every kernel as often as one run does."""
    from repro_torch.workloads import make_workload
    _, dyn = _traces(11)
    cfg = _cfg(backend=backend)
    fleet = _fleet()
    want = {"first_fit_place": S, "per_host_sum": 2 * S}
    if backend == "megakernel":
        want.update(fused_power_carbon=S, fused_facility_totals=1)
    else:
        want["fused_facility_power"] = S
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=1,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        for name, run in (
                ("fleet", lambda: P.simulate_fleet(
                    tasks, hosts, cfg, fleet,
                    dyn={**dyn, "n_active_hosts": 20}, device=dev)),
                ("grid", lambda: P.sweep_grid(
                    tasks, hosts, cfg,
                    [P.fleet_axis(n_active_hosts=np.int32([[20, 10, 15],
                                                           [29, 29, 29]])),
                     P.region_axis(fleet)], dyn=dyn, device=dev))):
            ops.reset_launch_counts()
            res = run()
            counts = ops.launch_counts()
            if dev.type == "cuda":
                assert {k: v for k, v in counts.items() if v} == want, name
            for part in ("total", "per_region"):
                results[(dev.type, name, part)] = P.result_to_numpy(
                    getattr(res, part))
    for name in ("fleet", "grid"):
        for part in ("total", "per_region"):
            got, ref_res = (results[(d, name, part)] for d in ("cuda", "cpu"))
            assert (ref_res["n_done"] > 0).any()
            for k, v in ref_res.items():
                if k.startswith("n_") or k.startswith("class_n_"):
                    np.testing.assert_array_equal(got[k], v, err_msg=k)
                else:
                    np.testing.assert_allclose(got[k], v, rtol=1e-4,
                                               atol=1e-4, err_msg=k)


@pytest.mark.cuda
def test_spill_fleet_step_loop_never_waits_for_the_card(cuda_device):
    """The coupled fleet's step loop (the stage pipeline's step for every
    region, then the cross-region spill) enqueues work and never reads a
    value back: PyTorch's sync debug mode raises on any operation that
    would make the host wait for the device.  Tasks spill, and the loop
    gives the CPU's spills and counts."""
    from repro_torch.core import fleet as fleet_mod
    from repro_torch.workloads import make_workload
    from repro_torch.kernels import build
    _, dyn = _traces(5)
    cfg = _res_cfg()
    cfg = cfg.replace(
        failures=C.FailureConfig(enabled=True, mtbf_h=6.0, repair_h=1e6),
        resilience=dataclasses.replace(cfg.resilience,
                                       spill_interrupted=True))
    fleet = _fleet()
    out = {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=2,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        region = fleet_mod.fleet_place(tasks, hosts, fleet, DT, n_steps=S)
        stacked = P.split_by_region(tasks, region, 3, width=tasks.n,
                                    device=dev)
        state0, inputs, ctx = fleet_mod.prepare_spill(
            stacked, hosts, cfg, torch.from_numpy(fleet.ci_traces),
            scalar_dyn={k: torch.tensor(v, device=dev)
                        for k, v in dyn.items()},
            per_region_dyn={"seed": np.int32([1, 2, 3]),
                            "n_active_hosts": np.int32([20, 15, 25])},
            device=dev)
        if dev.type == "cuda":
            build.build_all()  # the first use builds and loads
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            final = fleet_mod.spill_loop(state0, inputs, cfg, ctx)
        finally:
            if dev.type == "cuda":
                torch.cuda.set_sync_debug_mode("default")
        out[dev.type] = P.result_to_numpy(P.summarize(final, cfg))
    assert out["cpu"]["n_spills"].sum() > 0
    for k in ("n_spills", "n_interrupts", "n_done", "n_started",
              "n_decided", "n_tasks"):
        np.testing.assert_array_equal(out["cuda"][k], out["cpu"][k],
                                      err_msg=k)


# ---------------------------------------------------------------------------
# host failures and the resilience loop
# ---------------------------------------------------------------------------

def _res_cfg(**kw):
    return _cfg(**kw).replace(
        seed=42, failures=C.FailureConfig(enabled=True, mtbf_h=30.0),
        resilience=C.ResilienceConfig(
            enabled=True, chiller_mtbf_h=15.0, chiller_repair_h=3.0,
            pdu_mtbf_h=25.0, pdu_repair_h=2.0, pdu_cap_kw=3.0,
            throttle_inlet_c=24.0, heat_hazard_mult=2.0))


@pytest.mark.cuda
def test_threefry_on_card_matches_cpu(cuda_device):
    """Threefry's known answers on the card, and its uniforms, the failure
    probabilities and a run's failure draws equal the CPU's bit for bit."""
    from repro_torch.core import failures, threefry
    d, cpu = cuda_device, torch.device("cpu")
    got = threefry.threefry2x32(*(torch.tensor(v, device=d) for v in (
        0x13198a2e, 0x03707344, 0x243f6a88, 0x85a308d3)))
    assert tuple(int(x) for x in got) == (0xc4923a9c, 0x483df7a0)
    keys = [threefry.prng_key([0, 3, 12345, -1], dv) for dv in (d, cpu)]
    u = [threefry.uniform(k, 192817) for k in keys]
    assert torch.equal(u[0].cpu(), u[1])
    hazard = torch.tensor([1.0, 2.0, 0.0, 1.5]).repeat(24)
    p = [failures.failure_probability(hazard.to(dv), DT, 30.0)
         for dv in (d, cpu)]
    assert torch.equal(p[0].cpu(), p[1])
    draws = [failures.draw_host_failures([7, -1], pi.expand(2, -1), 972, dv)
             for pi, dv in ((p[0], d), (p[1], cpu))]
    for a, b in zip(*draws):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["f32", "bf16", "int8"])
def test_facility_kernel_derate_route_matches_plain(cuda_device, store):
    """Kernel 3 with a chiller-derate series (one row, and four rows of
    their own seeds) against the plain chain on the same series."""
    from repro_torch.kernels import fused_step as fs
    ci, dyn = _traces(7)
    cfg = _res_cfg()
    x = P.build_step_inputs(ci, cfg, dyn, device=cuda_device)
    assert bool((x.chiller_derate < 1.0).any())
    rows, _ = P.facility_failure_series(np.array([1, 2, 3, 42]), S, DT,
                                        cfg.resilience, device=cuda_device)
    gen = np.random.default_rng(3)
    for derate, b in ((x.chiller_derate, 1), (rows, 4)):
        it_kw = torch.tensor(gen.uniform(20.0, 80.0, (b, S)),
                             dtype=torch.float32, device=cuda_device)
        args = (x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
                x.pv_cf, x.batt_threshold, x.ci_rising)
        got = fs.fused_facility_totals(it_kw, *args, cfg, trace_store=store,
                                       chiller_derate=derate)
        for r in range(b):
            want = ref.fused_facility_totals(
                it_kw[r], *args, cfg, trace_store=store,
                chiller_derate=derate.reshape(-1, S)[r])
            for k in want:
                torch.testing.assert_close(got[k][r].double(),
                                           want[k].double(), rtol=1e-4,
                                           atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_resilience_on_card_matches_cpu(cuda_device, backend):
    """A run with host failures, checkpointing and the closed loop through
    the kernels == the same run on the CPU (counts and interrupts exact,
    the rest rtol 1e-4); kernel 1 and first-fit every step, kernel 2
    never, kernel 3's derate route once a megakernel run."""
    from repro_torch.workloads import make_workload
    ci, dyn = _traces(11)
    cfg = _res_cfg(backend=backend)
    results = {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=1,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        ops.reset_launch_counts()
        final, _ = P.simulate(tasks, hosts, ci, cfg,
                              dyn={**dyn, "n_active_hosts": 20}, device=dev)
        results[dev.type] = P.result_to_numpy(P.summarize(final, cfg))
        counts = ops.launch_counts()
    want = {"first_fit_place": S, "fused_power_carbon": S,
            "per_host_sum": 2 * S}
    if backend == "megakernel":
        want["fused_facility_totals"] = 1
    assert {k: v for k, v in counts.items() if v} == want
    got, ref_res = results["cuda"], results["cpu"]
    assert ref_res["n_interrupts"] > 0 and ref_res["derate_h"] > 0
    for k, v in ref_res.items():
        if k.startswith("n_") or k.startswith("class_n_"):
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                       err_msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", P.BACKENDS)
def test_aggregate_and_tasktrace_on_card_match_cpu(cuda_device, backend):
    """Scheduler mode 'aggregate' on the card == the CPU (counts exact, the
    rest rtol 1e-4) and never launches first-fit; a task-trace grid of
    three arrival sets launches each kernel as one run does."""
    from repro_torch.tasktraces import make_arrival_sets
    from repro_torch.workloads import make_workload
    ci, dyn = _traces(5)
    agg = C.SimConfig(n_steps=S, dt_h=DT, backend=backend,
                      scheduler=C.SchedulerConfig(mode="aggregate"),
                      shifting=C.ShiftingConfig(enabled=True))
    plain = agg.replace(scheduler=C.SchedulerConfig())
    results, counts = {}, {}
    for dev in (torch.device("cpu"), cuda_device):
        tasks, hosts, _, _ = make_workload("marconi", scale=0.03, seed=1,
                                           horizon_days=S * DT / 24,
                                           device=dev)
        arr = make_arrival_sets(tasks.n, S, DT, 3, seed=2)
        for name, run in (
                ("aggregate", lambda: P.summarize(P.simulate(
                    tasks, hosts, ci, agg, dyn={"n_active_hosts": 20},
                    device=dev)[0], agg)),
                ("tasktrace", lambda: P.sweep_grid(
                    tasks, hosts, plain, [P.tasktrace_axis(arr)],
                    ci_trace=ci, dyn={"n_active_hosts": 20}, device=dev))):
            ops.reset_launch_counts()
            results[(dev.type, name)] = P.result_to_numpy(run())
            counts[name] = {k: v for k, v in ops.launch_counts().items()
                            if v}
    want = {"fused_power_carbon": S, "per_host_sum": 2 * S}
    if backend == "megakernel":
        want["fused_facility_totals"] = 1
    assert counts["aggregate"] == want
    assert counts["tasktrace"] == {**want, "first_fit_place": S}
    for name in ("aggregate", "tasktrace"):
        got, ref_res = results[("cuda", name)], results[("cpu", name)]
        assert float(np.min(ref_res["n_done"])) > 0, name
        for k, v in ref_res.items():
            if k.startswith("n_") or k.startswith("class_n_"):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=1e-4,
                                           err_msg=k)


@pytest.mark.cuda
def test_analytical_savings_on_card_match_cpu(cuda_device):
    """The §III model on the card == the CPU, per task bit for bit (the
    same elementwise f32 ops and the same blocked cumsum)."""
    from repro_torch.core.analytical import analytical_shifting_savings
    from repro_torch.workloads import make_workload
    tasks, _, _, _ = make_workload("marconi", scale=0.2, seed=0,
                                   device="cpu")
    ci, _ = _traces(3, 2880)  # the workload's 30 days
    n = tasks.n
    for kw in ({}, {"oracle": False}):
        m_c, cpu = analytical_shifting_savings(
            tasks.arrival, tasks.duration, ci, DT, device="cpu", **kw)
        m_g, card = analytical_shifting_savings(
            tasks.arrival, tasks.duration, ci, DT, device=cuda_device, **kw)
        assert card.shape == (n,) and card.is_cuda
        assert torch.equal(card.cpu(), cpu)
        torch.testing.assert_close(m_g.cpu(), m_c, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# the model substrate: SSD intra-chunk and flash attention kernels, serving
# ---------------------------------------------------------------------------

def _ssd_inputs(shape, seed, dev):
    bt, nc, q, h, p, g, n = shape
    rng = np.random.default_rng(seed)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32),  # noqa: E731
                                 device=dev)
    return (mk(bt, nc, q, h, p) * 0.3, -mk(bt, nc, h, q).abs() * 0.2,
            mk(bt, nc, q, g, n) * 0.3, mk(bt, nc, q, g, n) * 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 2, 16, 4, 8, 1, 8), (2, 4, 32, 8, 16, 2, 16),    # reference tests
    (1, 1, 64, 16, 32, 4, 32), (1, 2, 256, 8, 64, 2, 64),  # zamba2-like
    (1, 1, 256, 4, 64, 1, 128),                           # mamba2-like
    (2, 1, 48, 6, 80, 3, 40)])                 # ragged q, p and n tiles
def test_ssd_kernel_matches_plain(cuda_device, shape):
    from repro_torch.kernels import ssd_chunk
    args = _ssd_inputs(shape, sum(shape), cuda_device)
    got = ssd_chunk.ssd_intra_chunk(*args)
    want = ref.ssd_intra_chunk(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    # no later position reaches an earlier one: masked terms are exact zeros
    xdt = args[0].clone()
    xdt[:, :, shape[2] // 2:] = 1e30
    late = ssd_chunk.ssd_intra_chunk(xdt, *args[1:])
    assert torch.equal(late[:, :, :shape[2] // 2], got[:, :, :shape[2] // 2])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (1, 66, 16, 14, 16, 2, 16),    # R 6 of 7 heads a group: slabs 6, 1
    (2, 1, 320, 6, 32, 2, 16),     # Q > 256: two score segments
    (1, 2, 40, 4, 6, 2, 10),       # P, N off 16-byte rows (padded)
    (2, 66, 16, 16, 16, 2, 16)])   # R 8: one slab a group
def test_ssd_kernel_slabs_match_plain(cuda_device, shape):
    """Slabs of R heads (the wrapper's `slab_heads`) share a group's score
    tiles: a last slab with fewer heads, chunks longer than the shared
    tiles, padded rows; masked terms stay exact zeros."""
    from repro_torch.kernels import ssd_chunk
    args = _ssd_inputs(shape, sum(shape), cuda_device)
    got = ssd_chunk.ssd_intra_chunk(*args)
    want = ref.ssd_intra_chunk(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    xdt = args[0].clone()
    xdt[:, :, shape[2] // 2:] = 1e30
    late = ssd_chunk.ssd_intra_chunk(xdt, *args[1:])
    assert torch.equal(late[:, :, :shape[2] // 2], got[:, :, :shape[2] // 2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (2, 64, 64, 4, 2, 16, True), (1, 128, 128, 8, 8, 32, True),
    (2, 32, 96, 4, 1, 16, False), (1, 48, 48, 2, 2, 8, True),
    (1, 48, 80, 4, 2, 16, True), (1, 100, 36, 4, 4, 16, True),
    (1, 130, 130, 2, 2, 112, True), (1, 70, 70, 2, 1, 256, False)])
def test_flash_kernel_matches_plain(cuda_device, dtype, tol, b, sq, sk, h,
                                    kv, d, causal):
    from repro_torch.kernels import flash_attn
    g = torch.Generator(device=cuda_device).manual_seed(sq * sk + d)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(dtype)
               for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
    got = flash_attn.flash_attention(q, k, v, scale=0.35, causal=causal)
    want = ref.flash_attention(q, k, v, scale=0.35, causal=causal)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,sk,h,kv,d,causal", [
    (1, 48, 72, 4, 2, 8, True), (2, 200, 130, 8, 2, 64, True),
    (1, 130, 300, 4, 1, 128, False), (1, 90, 150, 4, 2, 256, True),
    (2, 150, 90, 4, 2, 64, True), (1, 70, 70, 2, 1, 36, True)])
def test_flash_tensor_core_kernel_matches_plain(cuda_device, b, sq, sk, h,
                                                kv, d, causal):
    """bf16 runs on the wgmma kernel: head dims 8 to 256 (36 padded by the
    wrapper), GQA with Sq != Sk both ways, ragged tiles; one launch."""
    from repro_torch.kernels import flash_attn
    g = torch.Generator(device=cuda_device).manual_seed(sq * sk + d)
    q, k, v = (torch.randn(s, generator=g, device=cuda_device).to(
        torch.bfloat16) for s in ((b, sq, h, d), (b, sk, kv, d),
                                  (b, sk, kv, d)))
    ops.reset_launch_counts()
    got = flash_attn.flash_attention(q, k, v, scale=0.35, causal=causal)
    assert ops.launch_counts()["flash_attention"] == 1
    want = ref.flash_attention(q, k, v, scale=0.35, causal=causal)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _reduced_model(arch_id, dev):
    from repro_torch.configs import reduced
    from repro_torch.models import get_model
    model = get_model(reduced(arch_id))
    params = model.init(torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    tokens = torch.tensor(np.random.default_rng(1).integers(
        0, model.cfg.vocab, (2, 64)), device=dev)
    return model, params, tokens


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id,want", [
    ("zamba2-7b", {"ssd_intra_chunk": 7, "flash_attention": 2}),
    ("mamba2-2.7b", {"ssd_intra_chunk": 2})])
def test_prefill_launch_counts_are_exact(cuda_device, arch_id, want):
    """One SSD launch per mamba layer and one flash launch per shared
    attention site; decode launches none (plain recurrences)."""
    model, params, tokens = _reduced_model(arch_id, cuda_device)
    ops.reset_launch_counts()
    logits = model.prefill(params, {"tokens": tokens})
    assert {k: v for k, v in ops.launch_counts().items() if v} == want
    assert bool(torch.isfinite(logits).all())
    cache = model.init_cache(2, 64, device=cuda_device)
    ops.reset_launch_counts()
    model.decode_step(params, cache, tokens[:, :1], 0)
    assert not any(ops.launch_counts().values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["zamba2-7b", "mamba2-2.7b"])
def test_serving_never_waits_for_the_card(cuda_device, arch_id):
    """Prefill and greedy decode enqueue work and never read a value back:
    PyTorch's sync debug mode raises on any operation that would make the
    host wait for the device.  Greedy tokens stay on the card."""
    from repro_torch.kernels import build
    model, params, tokens = _reduced_model(arch_id, cuda_device)
    cache = model.init_cache(2, 64, device=cuda_device)
    build.build_all()  # the first use builds and loads: not a device wait
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        logits = model.prefill(params, {"tokens": tokens})
        tok = tokens[:, :1]
        for t in range(8):
            step, cache = model.decode_step(params, cache, tok, t)
            tok = step[:, -1].argmax(-1, keepdim=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert bool(torch.isfinite(logits).all()) and tok.shape == (2, 1)


def _new_family_batch(cfg, dev):
    rng = np.random.default_rng(1)
    batch = {"tokens": torch.tensor(rng.integers(0, cfg.vocab, (2, 64)),
                                    device=dev)}
    if cfg.family == "encdec":
        batch["frames"] = torch.tensor(rng.standard_normal(
            (2, cfg.enc_seq, cfg.d_model)).astype(np.float32), device=dev)
    return batch


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id,want", [
    ("qwen3-moe-235b-a22b", 2), ("deepseek-v2-236b", 3), ("whisper-base", 6)])
def test_moe_and_encdec_prefill_launch_flash(cuda_device, arch_id, want):
    """One flash launch a layer of the MoE decoders (MLA's v padded to the
    q / k width, deepseek's dense first layer included) and three a
    whisper layer pair (encoder, decoder self- and cross-attention), the
    logits within 1e-4 of the CPU's on the same weights."""
    from repro_torch.configs import reduced
    from repro_torch.models import get_model
    from repro_torch.models.layers import tree_map
    model = get_model(reduced(arch_id))
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    batch = _new_family_batch(model.cfg, "cpu")
    want_logits = model.prefill(p_cpu, batch)
    params = tree_map(lambda t: t.to(cuda_device), p_cpu)
    ops.reset_launch_counts()
    logits = model.prefill(params, {k: v.to(cuda_device)
                                    for k, v in batch.items()})
    assert {k: v for k, v in ops.launch_counts().items() if v} == \
        {"flash_attention": want}
    torch.testing.assert_close(logits.cpu(), want_logits, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_sort_dispatch_repeats_bit_for_bit(cuda_device, cdt):
    """The sort dispatch's combine gathers each token's slots and adds them
    in expert order (no atomics): two runs on the card give the same
    bits."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.layers import init_params
    cfg = get_config("qwen3-moe-235b-a22b")
    cfg = cfg.replace(d_model=512, compute_dtype=cdt, moe=dataclasses.replace(
        cfg.moe, dispatch="sort", n_experts=32, d_ff_expert=256))
    p = init_params(moe.moe_defs(cfg),
                    torch.Generator(device=cuda_device).manual_seed(0),
                    "float32", cuda_device)
    x = torch.randn((2, 512, cfg.d_model), device=cuda_device)
    a, aux_a = moe.moe_ffn_sort(cfg, p, x)
    b, aux_b = moe.moe_ffn_sort(cfg, p, x)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,h,running", [
    (0, 192_817, 972, 0.03), (64, 50_000, 972, 0.03), (3, 20_000, 4096, 0.5),
    (2, 9_000, 3, 1.0), (1, 0, 17, 1.0)])
def test_per_host_sum_repeats_and_equals_cpu(cuda_device, b, t, h, running):
    """The per-host sum kernel ([T] or [B, T] rows): the same bits on two
    launches, and the plain version's on the CPU (`scatter_add_` in task
    order) bit for bit; one launch a call."""
    from repro_torch.core import scheduler
    rng = np.random.default_rng(t + h)
    shape = (b, t) if b else (t,)
    run = torch.tensor(rng.uniform(size=shape) < running)
    host = torch.tensor(rng.integers(0, h, shape))
    seg = torch.where(run, host, torch.arange(h, h + t))
    vals = tuple(torch.where(run, torch.tensor(
        rng.choice(np.float32([4, 8, 16, 32, 48]), shape)
        * rng.uniform(size=shape).astype(np.float32)), 0.0) for _ in range(2))
    want = ref.per_host_sum(*vals, seg, h)
    d = cuda_device
    on_card = (*(v.to(d) for v in vals), seg.to(d))
    ops.reset_launch_counts()
    first = scheduler._per_host_sum(*on_card, h)
    again = scheduler._per_host_sum(*on_card, h)
    torch.cuda.synchronize()
    assert ops.launch_counts()["per_host_sum"] == 2
    for x, y, w in zip(first, again, want):
        assert torch.equal(x, y)
        assert torch.equal(x.cpu(), w)


@pytest.mark.cuda
def test_kernel_entries_refuse_autograd_on_the_card(cuda_device):
    """A CUDA tensor that requires grad never reaches a kernel: the kernel
    has no backward, so its output would drop that input's gradient."""
    d = cuda_device
    q = torch.randn((1, 64, 4, 32), device=d, requires_grad=True)
    k, v = torch.randn((1, 64, 2, 32), device=d), torch.randn(
        (1, 64, 2, 32), device=d)
    ops.reset_launch_counts()
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        ops.flash_attention(q, k, v, scale=0.25)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_intra_chunk(torch.randn((1, 2, 8, 2, 4), device=d,
                                        requires_grad=True),
                            -torch.rand((1, 2, 2, 8), device=d),
                            torch.randn((1, 2, 8, 1, 4), device=d),
                            torch.randn((1, 2, 8, 1, 4), device=d))
    assert not any(ops.launch_counts().values())
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, scale=0.25)
    assert ops.launch_counts()["flash_attention"] == 1
    assert not out.requires_grad


@pytest.mark.cuda
@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "zamba2-7b"])
def test_train_step_on_the_card_matches_cpu(cuda_device, arch_id):
    """One train step of a reduced config on the card launches no kernel
    and gives the CPU's loss and gradient norm (the same weights); the
    next loss falls."""
    from repro_torch.configs import reduced
    from repro_torch.models import get_model
    from repro_torch.models.layers import tree_map
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (TrainConfig, make_train_step,
                                        new_train_state)
    cfg = reduced(arch_id)
    model = get_model(cfg)
    p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab, (2, 65),
                           generator=torch.Generator().manual_seed(1))
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=10))
    out = {}
    for d in (cuda_device, torch.device("cpu")):
        state = new_train_state(tree_map(lambda t: t.to(d).clone(), p_cpu),
                                tcfg)
        batch = {"tokens": tokens[:, :-1].to(d), "labels": tokens[:, 1:].to(d)}
        step = make_train_step(model, tcfg)
        ops.reset_launch_counts()
        state, m1 = step(state, batch)
        state, m2 = step(state, batch)
        assert not any(ops.launch_counts().values()), d
        out[d.type] = [float(m1["loss"]), float(m1["grad_norm"]),
                       float(m2["loss"])]
    np.testing.assert_allclose(out["cuda"][:2], out["cpu"][:2], rtol=1e-4)
    assert out["cuda"][2] < out["cuda"][0]
