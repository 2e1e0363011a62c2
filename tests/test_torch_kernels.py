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
from repro_torch.kernels import ops, ref

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
