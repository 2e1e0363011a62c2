"""The plain versions of the port's four kernels against the reference ops.

Each plain PyTorch version (repro_torch/kernels/ref.py, what the port runs
on the CPU and what the card's kernels are held to) meets the reference
package's Pallas op in interpret mode on the same numpy inputs, at the
shapes of tests/test_kernels.py and tests/test_megakernel.py:

  * per-host power rtol 1e-5, atol 1e-6; IT sum, carbon, cooling and water
    rtol 1e-4 (sums reassociate);
  * first-fit: assignments equal, free vectors atol 1e-5;
  * facility totals: rtol 1e-4, atol 1e-3 with f32 traces; with bf16 and
    int8 stores the decision-free energy totals stay within 5e-3 and 1e-2
    relative of the f32 chain (battery off: quantized carbon intensity can
    flip dispatch decisions).

tests/test_torch_card.py holds each hand-written kernel to its plain
version on the card at the same tolerances.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.config as jconfig
from repro.kernels import ops as jops
from repro.kernels.fused_step import fused_facility_totals as j_fused_totals
import repro_torch.core.config as pconfig
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import first_fit as ff
from repro_torch.kernels import fused_step as fs
from repro_torch.kernels import power_carbon as pc

torch.set_num_threads(1)

S = 96
DT = 0.25
T = torch.tensor


def _host_inputs(h, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, h).astype(np.float32),
            rng.uniform(0, 1, h).astype(np.float32),
            rng.integers(0, 4, h).astype(np.float32),
            (rng.uniform(size=h) < 0.8).astype(np.float32))


@pytest.mark.parametrize("h", [7, 128, 1000, 2048])
@pytest.mark.parametrize("curves", [("sqrt", "linear"), ("square", "cubic")])
def test_power_carbon_plain_matches_reference(h, curves):
    cpu_u, gpu_u, ngpu, on = _host_inputs(h, h)
    want = jops.fused_power_carbon(
        cpu_u, gpu_u, ngpu, on, 350.0, 0.25,
        jconfig.PowerModelConfig(80.0, 250.0, curves[0]),
        jconfig.PowerModelConfig(40.0, 300.0, curves[1]))
    got = ops.fused_power_carbon(
        T(cpu_u), T(gpu_u), T(ngpu), T(on), T(350.0), 0.25,
        pconfig.PowerModelConfig(80.0, 250.0, curves[0]),
        pconfig.PowerModelConfig(40.0, 300.0, curves[1]))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4)
    p, it = ops.host_power(T(cpu_u), T(gpu_u), T(ngpu), T(on),
                           pconfig.PowerModelConfig(80.0, 250.0, curves[0]),
                           pconfig.PowerModelConfig(40.0, 300.0, curves[1]))
    np.testing.assert_array_equal(p.numpy(), got[0].numpy())
    np.testing.assert_array_equal(it.numpy(), got[1].numpy())


@pytest.mark.parametrize("h", [7, 128, 1000, 2048])
@pytest.mark.parametrize("wb,sp", [(30.0, 24.0), (10.0, 24.0), (21.0, 24.0),
                                   (25.0, 18.0)])
def test_facility_power_plain_matches_reference(h, wb, sp):
    cpu_u, gpu_u, ngpu, on = _host_inputs(h, h + int(wb))
    args = [jconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
            jconfig.PowerModelConfig(40.0, 300.0, "linear"),
            jconfig.CoolingConfig(enabled=True)]
    want = jops.facility_power(cpu_u, gpu_u, ngpu, on, wb, sp, *args)
    got = ops.facility_power(
        T(cpu_u), T(gpu_u), T(ngpu), T(on), T(wb), T(sp),
        pconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
        pconfig.PowerModelConfig(40.0, 300.0, "linear"),
        pconfig.CoolingConfig(enabled=True))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("r,h", [(1, 7), (4, 128), (3, 1000)])
def test_facility_power_rows_match_reference_batched(r, h):
    """[B, H] scenario rows == the reference's vmapped batched op."""
    rng = np.random.default_rng(r * h)
    cpu_u, gpu_u = (rng.uniform(0, 1, (r, h)).astype(np.float32)
                    for _ in range(2))
    ngpu = rng.integers(0, 4, (r, h)).astype(np.float32)
    on = (rng.uniform(size=(r, h)) < 0.8).astype(np.float32)
    wb = rng.uniform(5.0, 35.0, r).astype(np.float32)
    sp = rng.uniform(18.0, 28.0, r).astype(np.float32)
    want = jops.facility_power_batched(
        cpu_u, gpu_u, ngpu, on, wb, sp,
        jconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
        jconfig.PowerModelConfig(40.0, 300.0, "linear"),
        jconfig.CoolingConfig(enabled=True))
    got = ops.facility_power(
        T(cpu_u), T(gpu_u), T(ngpu), T(on), T(wb), T(sp),
        pconfig.PowerModelConfig(80.0, 250.0, "sqrt"),
        pconfig.PowerModelConfig(40.0, 300.0, "linear"),
        pconfig.CoolingConfig(enabled=True))
    assert got[0].shape == (r, h) and got[1].shape == (r,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-5, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


def _ff_inputs(k, h, seed, live=None):
    rng = np.random.default_rng(seed)
    cc = rng.integers(1, 8, k).astype(np.float32)
    cg = rng.integers(0, 2, k).astype(np.float32)
    fc = rng.integers(0, 16, h).astype(np.float32)
    fg = rng.integers(0, 4, h).astype(np.float32)
    if live is not None:  # the scheduler's inert tail and unusable hosts
        cc[live:] = cg[live:] = np.inf
        down = rng.uniform(size=h) < 0.2
        fc[down] = fg[down] = -np.inf
    return cc, cg, fc, fg


@pytest.mark.parametrize("live", [None, "half"])
@pytest.mark.parametrize("k,h", [(4, 3), (16, 64), (64, 300), (64, 972)])
def test_first_fit_plain_matches_reference(k, h, live):
    args = _ff_inputs(k, h, k * h, None if live is None else k // 2)
    want = jops.first_fit_place(*args)
    got = ops.first_fit_place(*(T(x) for x in args))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert got[0].dtype == torch.int32
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_first_fit_rows_are_independent():
    rows = [_ff_inputs(16, 64, s, 10) for s in range(3)]
    stacked = [T(np.stack(x)) for x in zip(*rows)]
    got = ops.first_fit_place(*stacked)
    for i, row in enumerate(rows):
        one = ops.first_fit_place(*(T(x) for x in row))
        for g, w in zip(got, one):
            np.testing.assert_array_equal(g[i].numpy(), w.numpy())


# ---------------------------------------------------------------------------
# first-fit's warp layout (csrc/first_fit.cu, first_fit_warp_kernel)
# ---------------------------------------------------------------------------

def test_first_fit_variant_follows_host_count():
    """The wrapper picks the kernel from H alone: one warp a row while the
    row fits 32 lanes of HOSTS_PER_LANE hosts, one block a row beyond."""
    assert ff.WARP_MAX_HOSTS == 32 * ff.HOSTS_PER_LANE == 1024
    assert [ff.variant(h) for h in (1, 31, 32, 972, 1024)] == ["warp"] * 5
    assert [ff.variant(h) for h in (1025, 2048, ff.MAX_HOSTS)] == \
        ["block"] * 3
    assert ff.warp_grid(1) == (1, 128) and ff.warp_grid(5) == (2, 128)


def _lanes_first_fit(cc, cg, fc, fg):
    """The warp kernel's placement, written out in torch: the H hosts padded
    with -inf to 32 lanes x R, lane l holding hosts l*R .. l*R+R-1; per live
    candidate each lane's lowest fitting local index, the min over lanes of
    lane * R + index, and one subtraction in the owning lane's slot."""
    r = ff.HOSTS_PER_LANE
    h = fc.shape[0]
    pad = torch.full((32 * r - h,), -np.inf)
    lc = torch.cat([fc, pad]).reshape(32, r)
    lg = torch.cat([fg, pad]).reshape(32, r)
    slot = torch.arange(r)
    none = 2 ** 32 - 1                     # the kernel's "no fit" (u32 max)
    assign = torch.full(cc.shape, -1, dtype=torch.int32)
    for j in range(cc.shape[0]):
        need_c, need_g = cc[j], cg[j]
        if need_c == np.inf or need_g == np.inf:
            continue                       # inert slot
        fits = (lc >= need_c) & (lg >= need_g)
        first_in_lane = torch.where(fits, slot, r).amin(1)
        lane_first = torch.where(first_in_lane < r,
                                 torch.arange(32) * r + first_in_lane, none)
        first = int(lane_first.min())
        if first < h:
            lane, s = divmod(first, r)
            lc[lane, s] -= need_c
            lg[lane, s] -= need_g
            assign[j] = first
    return assign, lc.reshape(-1)[:h], lg.reshape(-1)[:h]


@pytest.mark.parametrize("case", ["live", "inert", "down"])
@pytest.mark.parametrize("k,h", [(4, 3), (64, 31), (40, 100), (100, 972),
                                 (64, 1024)])
def test_first_fit_lane_layout_matches_plain_and_reference(k, h, case):
    """The lane layout places exactly as the sequential plain version and
    the reference's Pallas op (interpret mode): assignments equal, free
    vectors bit for bit, on inputs with many ties, H not a multiple of 32,
    -inf (down) hosts and +inf (inert) slots."""
    cc, cg, fc, fg = _ff_inputs(k, h, k + h, None if case == "live"
                                else k // 2)
    if case == "down":
        fc[:] = fg[:] = -np.inf
    got = _lanes_first_fit(*(T(x) for x in (cc, cg, fc, fg)))
    for want in (ops.first_fit_place(*(T(x) for x in (cc, cg, fc, fg))),
                 [T(np.asarray(x)) for x in
                  jops.first_fit_place(cc, cg, fc, fg)]):
        np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(g.numpy().view(np.int32),
                                          w.numpy().view(np.int32))
    if case == "down":
        assert bool((got[0] == -1).all())


@pytest.mark.parametrize("h", [1, 31, 972, 1024, 1025, 2048, 4096, 5000])
def test_facility_block_covers_the_row(h):
    """Facility power's block: one host a thread, a multiple of 32 threads,
    at most 1024; one pass covers the row up to 1024 hosts (the kernel
    loops past that)."""
    threads = pc.facility_block(h)
    assert threads % 32 == 0 and 32 <= threads <= pc.MAX_THREADS
    assert min(h, pc.MAX_THREADS) <= threads < min(h, pc.MAX_THREADS) + 32


class _Launch:
    """Stands in for a C entry point on the CPU: records its arguments."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorded_launch(monkeypatch):
    """The wrappers' launch path with the C entry points recorded instead
    of called (no card here): returns the recorder."""
    fn = _Launch()
    monkeypatch.setattr(build, "require_cuda", lambda *a: None)
    monkeypatch.setattr(build, "function", lambda *a: fn)
    monkeypatch.setattr(build, "stream_of", lambda t: None)
    yield fn
    ops.reset_launch_counts()


@pytest.mark.parametrize("h", [7, 972, 1024, 1025, 5000])
def test_power_carbon_launches_the_row_pass_block(recorded_launch, h):
    """Kernel 1 takes the row pass's block, one host a thread, as facility
    power does; the megakernel's call passes no carbon intensity."""
    cpu_u, gpu_u, ngpu, on = (T(x) for x in _host_inputs(h, h))
    cfg = pconfig.PowerModelConfig(80.0, 250.0, "sqrt")
    pc.fused_power_carbon(cpu_u, gpu_u, ngpu, on, None, 0.25, cfg, cfg)
    pc.fused_power_carbon(cpu_u, gpu_u, ngpu, on, T(350.0), 0.25, cfg, cfg)
    without, with_ci = recorded_launch.calls
    assert without[4] is None and with_ci[4] is not None
    for args in recorded_launch.calls:
        assert args[6:9] == (1, h, pc.facility_block(h))


@pytest.mark.parametrize("s", [0, 1, 31, 32, 33, 255, 1023, 1024, 1025, 2880,
                               35040, 35041, 105120, 10 ** 6])
def test_facility_launch_plan_covers_the_horizon(s):
    """Kernel 3's tiles: a multiple of 32 steps, at most TILE_MAX, no longer
    than the horizon needs; ceil(S / tile) of them cover S with the last one
    partial; their ring fits a block's shared memory."""
    tile, n_tiles, smem = fs.launch_plan(s)
    assert tile % 32 == 0 and 32 <= tile <= fs.TILE_MAX
    assert tile == min(fs.TILE_MAX, max(32, -(-s // 32) * 32))
    assert n_tiles * tile >= s and (n_tiles == 0 or (n_tiles - 1) * tile < s)
    # a block may take 227 KB of an H100 SM's 228 KB; two of the largest
    # plan fit on one SM
    assert smem == fs.smem_bytes(tile) <= 227 * 1024
    assert 2 * fs.smem_bytes(fs.TILE_MAX) <= 228 * 1024


@pytest.mark.parametrize("s", [1, 255, 2880])
def test_facility_launch_passes_the_plan(recorded_launch, s):
    """The launch carries its plan's tile in the config block (the C entry
    point sizes shared memory from it) and returns a row of N_ACC lanes."""
    rng = np.random.default_rng(s)
    x = [T(rng.uniform(lo, hi, s).astype(np.float32)) for lo, hi in (
        (20, 80), (50, 600), (5, 25), (0.05, 0.2), (0.04, 0.1), (0.1, 0.3),
        (0, 1), (50, 600))] + [T(rng.uniform(size=s) < 0.5)]
    cfg = _cfg(pconfig, True, True, True, "blended")
    acc = fs.launch(*fs.prepare(*x, cfg))
    (args,) = recorded_launch.calls
    assert len(args) == 16
    fcfg, store, b = args[11]._obj, args[12], args[13]
    assert (fcfg.n_steps, fcfg.tile, store, b) == (s, fs.launch_plan(s)[0],
                                                   0, 1)
    assert acc.shape == (1, fs.N_ACC) == (1, fs.A_SLOW + 1)


@pytest.mark.parametrize("pricing", [False, True])
@pytest.mark.parametrize("renewables", [False, True])
def test_facility_rows_map_to_the_totals(pricing, renewables):
    """Each total reads its own accumulator lane (times the step where it is
    an energy); the count of slow tiles reaches no total."""
    cfg = _cfg(pconfig, True, pricing, renewables, "carbon")
    acc = torch.arange(1, 2 * fs.N_ACC + 1, dtype=torch.float32).reshape(
        2, fs.N_ACC)
    got = fs.totals_from_rows(acc, cfg)
    want = ref.fused_facility_totals(
        *[torch.ones(8)] * 8, torch.ones(8, dtype=torch.bool), cfg)
    assert set(got) == set(want)
    dt = np.float32(cfg.dt_h)
    lanes = {"soc_final": fs.A_SOC, "peak_power": fs.A_GRID_MAX,
             "grid_energy": fs.A_GRID, "it_energy": fs.A_IT,
             "batt_discharged": fs.A_DK, "curtailed_energy": fs.A_CUR}
    if pricing:
        lanes.update(demand_cost=fs.A_DEMAND, window_peak_kw=fs.A_WPEAK)
    for key, lane in lanes.items():
        scale = 1.0 if key in ("soc_final", "peak_power", "demand_cost",
                               "window_peak_kw") else dt
        torch.testing.assert_close(got[key], acc[:, lane] * scale)
    assert not any(bool((v == acc[:, fs.A_SLOW]).any()) for k, v in
                   got.items() if k != "was_charging")


def test_power_params_are_built_once_per_configuration():
    cpu = pconfig.PowerModelConfig(80.0, 250.0, "sqrt")
    gpu = pconfig.PowerModelConfig(40.0, 300.0, "linear")
    cool = pconfig.CoolingConfig(enabled=True)
    same = pconfig.PowerModelConfig(80.0, 250.0, "sqrt")
    assert pc._power_params(cpu, gpu) is pc._power_params(same, gpu)
    assert pc._cooling_params(cool) is pc._cooling_params(
        pconfig.CoolingConfig(enabled=True))
    with pytest.raises(ValueError, match="unknown power model"):
        pc._power_params(pconfig.PowerModelConfig(1.0, 2.0, "quartic"), gpu)


def test_build_reads_registers_and_spills_from_ptxas():
    lines = [
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_121"
        "first_fit_warp_kernelEPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_121"
        "first_fit_warp_kernelEPKf",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 96 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_116"
        "first_fit_kernelEPKf' for 'sm_90a'",
        "8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 26 registers, used 1 barriers"]
    warp = build.resources(lines, "first_fit_warp_kernel")
    assert warp == [{"function": "_ZN12_GLOBAL__N_121first_fit_warp_kernel"
                                 "EPKf", "stack": 0, "spill_stores": 0,
                     "spill_loads": 0, "registers": 96}]
    block = build.resources(lines, "first_fit_kernel")
    assert [(b["spill_stores"], b["spill_loads"], b["registers"])
            for b in block] == [(4, 8, 26)]


# ---------------------------------------------------------------------------
# the fused facility kernel's plain version (tests/test_megakernel.py shapes)
# ---------------------------------------------------------------------------

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
IT_KW = np.random.default_rng(3).uniform(20.0, 80.0, S).astype(np.float32)
COMBOS = [(cool, price, renew)
          for cool in (False, True)
          for price in (False, True)
          for renew in (False, True)]


def _cfg(C, cool, price, renew, policy="carbon", batt=True):
    return C.SimConfig(
        n_steps=S,
        cooling=C.CoolingConfig(enabled=cool, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=price, billing_window_h=12.0),
        renewables=C.RenewableConfig(enabled=renew, pv_capacity_kw=25.0),
        battery=C.BatteryConfig(enabled=batt, capacity_kwh=6.0,
                                policy=policy, price_window_h=24.0))


def _dyn(cfg):
    d = {}
    if cfg.pricing.enabled:
        d["price_trace"] = PRICE
    if cfg.cooling.enabled:
        d["wet_bulb_trace"] = WB
    if cfg.renewables.enabled:
        d["pv_cf_trace"] = CF
    return d


def _port_totals(cfg, store="f32"):
    from repro_torch.core.engine import build_step_inputs
    x = build_step_inputs(CI, cfg, _dyn(cfg), device="cpu")
    return ops.fused_facility_totals(
        T(IT_KW), x.ci, x.wet_bulb_c, x.price, x.price_lo, x.price_hi,
        x.pv_cf, x.batt_threshold, x.ci_rising, cfg, trace_store=store)


@pytest.mark.parametrize("cool,price,renew", COMBOS)
def test_facility_totals_plain_matches_reference_f32(cool, price, renew):
    policy = "blended" if price else "carbon"
    jcfg = _cfg(jconfig, cool, price, renew, policy)
    x = J.build_step_inputs(CI, jcfg, {k: jnp.asarray(v) for k, v in
                                       _dyn(jcfg).items()})
    want = j_fused_totals(
        jnp.asarray(IT_KW), x.ci, x.wet_bulb_c, x.price, x.price_lo,
        x.price_hi, x.pv_cf, x.batt_threshold, x.ci_rising, jcfg,
        trace_store="f32", interpret=True)
    got = _port_totals(_cfg(pconfig, cool, price, renew, policy))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.float64(got[k]), np.float64(want[k]),
                                   rtol=1e-4, atol=1e-3,
                                   err_msg=f"facility total {k}")


@pytest.mark.parametrize("store,rel", [("bf16", 5e-3), ("int8", 1e-2)])
def test_facility_totals_quantized_stores(store, rel):
    cfg = _cfg(pconfig, True, True, True, batt=False)
    base = _port_totals(cfg)
    got = _port_totals(cfg, store)
    for k in ("grid_energy", "it_energy", "dc_energy", "op_carbon",
              "cooling_energy", "pv_energy", "energy_cost"):
        ref_v = float(base[k])
        err = abs(float(got[k]) - ref_v) / max(abs(ref_v), 1e-6)
        assert err <= rel, f"{store} {k}: rel err {err:.2e} > {rel}"
    assert any(float(got[k]) != float(base[k]) for k in base)


def test_ops_plain_path_is_taken_only_for_cpu_tensors():
    """The CPU path counts no launch; no switch reroutes the card."""
    ops.reset_launch_counts()
    ops.first_fit_place(*(T(x) for x in _ff_inputs(4, 3, 0)))
    assert ops.launch_counts() == dict.fromkeys(ops.KERNELS, 0)
