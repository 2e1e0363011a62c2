"""Launch wrapper of the fused facility kernel (csrc/fused_step.cu).

Replaces the Pallas kernel `fused_facility_totals`
(src/repro/kernels/fused_step.py): the megakernel's facility half --
cooling, PV netting, battery dispatch, the SoC and billing-window
recurrences -- over the whole horizon in one launch, reduced to the run
totals of `engine.facility_totals_from_flows`.  The four exogenous traces
(carbon intensity, wet-bulb, price, PV capacity factor) are stored as f32,
bf16 or int8 affine (core/quant.py) and dequantized on read in the kernel.
With `chiller_derate` (the resilience loop's series, core/resilience.py)
the cooling model is derated step by step; the series takes two values,
1.0 and `cfg.resilience.chiller_derate`, so it travels as one bit of each
step's flag byte beside the carbon signal's rising bit, whatever the store.

Series are f32 [S] or [B, S] (one scenario per thread block).  CUDA tensors
only (kernels/ops.py routes CPU tensors to kernels/ref.py).  The kernel walks
the horizon in tiles of steps held in shared memory; `launch_plan` sizes
them.

Two routes, one kernel template: `fused_facility_totals` writes the totals
row only; `fused_facility_series` (the `collect_series` and probe-bus
route) writes the same row and every step's flows as well, the dict of
`ref.fused_facility_chain`.  Each counts its launches under its own name.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core import battery as battery_mod
from ..core import pricing as pricing_mod
from ..core.quant import STORES, quantize_trace
from ..core.config import inv_f32
from . import build

F32 = torch.float32
POLICY_CODES = {"carbon": 0, "price": 1, "blended": 2}

# lanes of the kernel's [B, 18] output row: the reference's 18 accumulator
# lanes
(A_SOC, A_WPEAK, A_WASC, A_DEMAND, A_GRID, A_GRID_CI, A_GRID_PR, A_GRID_MAX,
 A_IT, A_COOL, A_WATER, A_HEAT, A_PV, A_CK, A_DK, A_EXP, A_EXP_PR,
 A_CUR) = range(18)
N_ACC = 18

# the series route's [B, N_SERIES, S] rows (csrc/fused_step.cu, F_*), in the
# order of `ref.fused_facility_chain`'s keys
SERIES_FIELDS = ("it_kw", "cooling_kw", "pv_kw", "batt_charge_kw",
                 "batt_discharge_kw", "grid_import_kw", "grid_export_kw",
                 "curtailed_kw", "water_l_per_h", "heat_reuse_kw", "soc")
N_SERIES = len(SERIES_FIELDS)

# the kernel's tiles (csrc/fused_step.cu): a ring of RING input tiles (five
# f32 series and two bit-mask words per 32 steps) and two tiles of ck / dk
# (and of the SoC on the series route), plus one window peak a step, in
# dynamic shared memory
TILE_MAX = 1024
RING = 3


class _FacilityConfig(ctypes.Structure):
    _fields_ = ([(f, ctypes.c_int) for f in (
        "n_steps", "wsteps", "tile", "cooling", "renewables",
        "export_allowed", "battery", "pricing", "policy", "wait_for_trough",
        "derate")]
        + [(f, ctypes.c_float) for f in (
            "dt", "eff", "demand_charge", "heat_reuse", "one_minus_reuse",
            "econ_range", "tower_approach", "condenser_lift", "carnot_eff",
            "max_cop", "fan_overhead", "evap_l_per_kwh", "chiller_derate")])

# bits of the kernel's per-step flag byte
RISING, DERATED = 1, 2


def smem_bytes(tile: int, series: bool = False) -> int:
    """Dynamic shared bytes of a launch with tiles of `tile` steps: the
    kernel's `smem_floats`, which sizes the launch; this copy lets the
    launch plan be checked against a block's shared memory.  The series
    route holds a third chain tile (the SoC) beside ck and dk."""
    chain = 3 if series else 2
    return 4 * (RING * (5 * tile + 2 * (tile // 32)) + 2 * chain * tile
                + tile)


def launch_plan(s: int, series: bool = False) -> tuple[int, int, int]:
    """(tile, n_tiles, dynamic shared bytes) for a horizon of `s` steps:
    tiles of a multiple of 32 steps, at most TILE_MAX (82.7 KB on the
    totals route, 90.9 KB on the series route: two blocks fit on an SM),
    no longer than the horizon rounded up to 32."""
    tile = min(TILE_MAX, max(32, -(-s // 32) * 32))
    return tile, -(-s // tile), smem_bytes(tile, series)


def _facility_config(cfg, s: int, derate: bool) -> _FacilityConfig:
    b, c, p = cfg.battery, cfg.cooling, cfg.pricing
    if b.policy not in POLICY_CODES:
        raise ValueError(f"unknown battery dispatch policy '{b.policy}'")
    reuse = c.heat_reuse_fraction if c.enabled else 0.0
    return _FacilityConfig(
        n_steps=s, tile=launch_plan(s)[0],
        wsteps=(pricing_mod.billing_window_steps(p, cfg.dt_h)
                if p.enabled else 1),
        cooling=int(c.enabled), renewables=int(cfg.renewables.enabled),
        export_allowed=int(cfg.renewables.export_allowed),
        battery=int(b.enabled), pricing=int(p.enabled),
        policy=POLICY_CODES[b.policy], wait_for_trough=int(b.wait_for_trough),
        derate=int(derate), chiller_derate=cfg.resilience.chiller_derate,
        dt=cfg.dt_h, eff=b.round_trip_efficiency,
        demand_charge=p.demand_charge_per_kw, heat_reuse=reuse,
        one_minus_reuse=1.0 - reuse, econ_range=c.economizer_range_c,
        tower_approach=c.tower_approach_c, condenser_lift=c.condenser_lift_c,
        carnot_eff=c.carnot_efficiency, max_cop=c.max_cop,
        fan_overhead=c.fan_pump_overhead, evap_l_per_kwh=c.evap_l_per_kwh_heat)


def _rows(x, b: int, s: int, dtype, dev):
    """A series as a contiguous [B, S] tensor of `dtype` on `dev`."""
    return x.to(device=dev, dtype=dtype).reshape(-1, s).expand(
        b, s).contiguous()


def _scalar_rows(vals, b: int, dev) -> torch.Tensor:
    """[B, 8] f32 parameter block from host scalars or 0-d/[B] tensors
    (host values are filled in on the device: no copy, no wait)."""
    cols = [v.to(device=dev, dtype=F32).reshape(-1).expand(b)
            if isinstance(v, torch.Tensor)
            else torch.full((b,), float(v), dtype=F32, device=dev)
            for v in vals]
    cols += [torch.zeros(b, dtype=F32, device=dev)] * (8 - len(cols))
    return torch.stack(cols, dim=1).contiguous()


def prepare(it_kw, ci, wet_bulb_c, price, price_lo, price_hi, pv_cf,
            batt_threshold, ci_rising, cfg, *, trace_store: str = "f32",
            soc0=0.0, setpoint_c=None, batt_capacity_kwh=None,
            batt_rate_kw=None, dispatch_lambda=None, pv_capacity_kw=None,
            chiller_derate=None):
    """Check the inputs and lay them out for `launch`: returns the tuple of
    tensors and the config block the kernel reads, ready to launch again
    (timing runs reuse it).  `chiller_derate` is None or an [S] / [B, S]
    series of 1.0 and `cfg.resilience.chiller_derate` (as
    `resilience.facility_failure_series` makes it)."""
    if trace_store not in STORES:
        raise ValueError(f"unknown trace store '{trace_store}'; pick one "
                         f"of {STORES}")
    s = it_kw.shape[-1]
    b = it_kw.reshape(-1, s).shape[0]
    dev = it_kw.device
    build.require_cuda("fused_facility_totals", it_kw, ci, wet_bulb_c, price,
                       price_lo, price_hi, pv_cf, batt_threshold, ci_rising)
    it = _rows(it_kw, b, s, F32, dev)
    qs, meta = [], []
    for x in (ci, wet_bulb_c, price, pv_cf):
        x = _rows(x, b, s, F32, dev)
        if trace_store == "f32":
            qs.append(x)
            meta += [torch.ones(b, dtype=F32, device=dev),
                     torch.zeros(b, dtype=F32, device=dev)]
        else:
            qt = quantize_trace(x, trace_store)
            qs.append(qt.q.contiguous())
            meta += [qt.scale.reshape(b), qt.zero.reshape(b)]
    meta = torch.stack(meta, dim=1).contiguous()
    bcfg = cfg.battery
    cap, rate = battery_mod.battery_params(bcfg, batt_capacity_kwh,
                                           batt_rate_kw)
    params = _scalar_rows([
        cap, rate,
        cfg.renewables.pv_capacity_kw if pv_capacity_kw is None
        else pv_capacity_kw,
        cfg.cooling.setpoint_c if setpoint_c is None else setpoint_c,
        soc0, bcfg.dispatch_lambda if dispatch_lambda is None
        else dispatch_lambda], b, dev)
    flags = _rows(ci_rising, b, s, torch.uint8, dev)
    if chiller_derate is not None:
        build.require_cuda("fused_facility_totals", chiller_derate)
        derated = _rows(chiller_derate, b, s, F32, dev) != 1.0
        flags = flags | (derated.to(torch.uint8) * DERATED)
    tensors = (it, *qs, meta, _rows(batt_threshold, b, s, F32, dev), flags,
               _rows(price_lo, b, s, F32, dev),
               _rows(price_hi, b, s, F32, dev), params)
    store = STORES.index(trace_store)
    return (tensors, _facility_config(cfg, s, chiller_derate is not None),
            store, b)


def launch(tensors, fcfg: _FacilityConfig, store: int, b: int):
    """One launch; returns the [B, 18] rows (`A_*` lanes)."""
    out = torch.empty((b, N_ACC), dtype=F32, device=tensors[0].device)
    fn = build.function("fused_step", "steam_facility_totals", [
        *[ctypes.c_void_p] * 11, ctypes.POINTER(_FacilityConfig),
        *[ctypes.c_int] * 2, ctypes.c_void_p, ctypes.c_void_p])
    code = fn(*(build.ptr(t) for t in tensors), ctypes.byref(fcfg), store, b,
              build.ptr(out), build.stream_of(out))
    build.check("fused_step", "fused_facility_totals launch", code)
    build.count_launch("fused_facility_totals")
    return out


def launch_series(tensors, fcfg: _FacilityConfig, store: int, b: int):
    """One launch of the series route; returns the [B, 18] rows (`A_*`
    lanes), the [B, N_SERIES, S] f32 flows (`SERIES_FIELDS`) and the [B, S]
    u8 charge decisions."""
    dev = tensors[0].device
    s = fcfg.n_steps
    out = torch.empty((b, N_ACC), dtype=F32, device=dev)
    series = torch.empty((b, N_SERIES, s), dtype=F32, device=dev)
    want = torch.empty((b, s), dtype=torch.uint8, device=dev)
    fn = build.function("fused_step", "steam_facility_series", [
        *[ctypes.c_void_p] * 11, ctypes.POINTER(_FacilityConfig),
        *[ctypes.c_int] * 2, *[ctypes.c_void_p] * 4])
    code = fn(*(build.ptr(t) for t in tensors), ctypes.byref(fcfg), store, b,
              build.ptr(out), build.ptr(series), build.ptr(want),
              build.stream_of(out))
    build.check("fused_step", "fused_facility_series launch", code)
    build.count_launch("fused_facility_series")
    return out, series, want


def flows_from_series(series: torch.Tensor, want: torch.Tensor,
                      chiller_derate=None) -> dict:
    """The series route's [..., N_SERIES, S] flows and [..., S] decisions
    as the dict of `ref.fused_facility_chain` (views, no copy), with the
    chiller-derate series that was applied (ones when healthy)."""
    flows = dict(zip(SERIES_FIELDS, series.unbind(-2)))
    flows["want_charge"] = want.view(torch.bool)
    shape = flows["it_kw"].shape
    flows["chiller_derate"] = (
        torch.ones(shape, dtype=F32, device=series.device)
        if chiller_derate is None
        else torch.broadcast_to(chiller_derate.to(F32), shape))
    return flows


def totals_from_rows(acc: torch.Tensor, cfg) -> dict:
    """The kernel's accumulator lanes as the keys of
    `engine.facility_totals_from_flows` (pricing and export entries gated
    the same way)."""
    dt = np.float32(cfg.dt_h)
    a = lambda k: acc[..., k]  # noqa: E731
    totals = {
        "op_carbon": a(A_GRID_CI) * dt * inv_f32(1000.0),
        "grid_energy": a(A_GRID) * dt,
        "dc_energy": (a(A_IT) + a(A_COOL)) * dt,
        "it_energy": a(A_IT) * dt,
        "peak_power": a(A_GRID_MAX),
        "batt_discharged": a(A_DK) * dt,
        "cooling_energy": a(A_COOL) * dt,
        "water_l": a(A_WATER) * dt,
        "heat_reuse": a(A_HEAT) * dt,
        "pv_energy": a(A_PV) * dt,
        "export_energy": a(A_EXP) * dt,
        "curtailed_energy": a(A_CUR) * dt,
        "soc_final": a(A_SOC),
        "was_charging": a(A_WASC) > 0.5,
    }
    if cfg.pricing.enabled:
        totals["energy_cost"] = a(A_GRID_PR) * dt
        totals["demand_cost"] = a(A_DEMAND)
        totals["window_peak_kw"] = a(A_WPEAK)
        if cfg.renewables.enabled:
            totals["export_revenue"] = (
                a(A_EXP_PR) * dt
                * np.float32(cfg.pricing.export_price_fraction))
    return totals


def fused_facility_totals(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                          pv_cf, batt_threshold, ci_rising, cfg, **kwargs):
    """The facility half in one launch; returns the totals dict (0-d
    tensors for [S] inputs, [B] for [B, S])."""
    acc = launch(*prepare(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                          pv_cf, batt_threshold, ci_rising, cfg, **kwargs))
    return totals_from_rows(acc[0] if it_kw.dim() == 1 else acc, cfg)


def fused_facility_series(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                          pv_cf, batt_threshold, ci_rising, cfg, **kwargs):
    """The facility half in one launch of the series route: (flows, totals),
    the per-step dict of `ref.fused_facility_chain` and the totals dict of
    `fused_facility_totals` (the same bits as the totals route's)."""
    acc, series, want = launch_series(*prepare(
        it_kw, ci, wet_bulb_c, price, price_lo, price_hi, pv_cf,
        batt_threshold, ci_rising, cfg, **kwargs))
    if it_kw.dim() == 1:
        acc, series, want = acc[0], series[0], want[0]
    return (flows_from_series(series, want, kwargs.get("chiller_derate")),
            totals_from_rows(acc, cfg))
