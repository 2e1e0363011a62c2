"""Battery model + dispatch policies (paper §V-B1, extended with cost).

Three policies decide when to charge and discharge; the storage physics
(C-rate caps, round-trip efficiency, SoC clipping) is shared:

  * 'carbon'  — charge below the trailing-week mean carbon intensity
    (optionally only once the intensity stops falling), discharge above it;
  * 'price'   — charge strictly below the forward charge-quantile price
    band, discharge strictly above the discharge band;
  * 'blended' — normalized carbon and price margins mixed by
    `dispatch_lambda`, whose endpoints select the single-objective
    decisions exactly (lambda=1 is 'carbon', lambda=0 is 'price').

With on-site PV, every policy is surplus-aware (`surplus_aware_dispatch`).
The threshold/trough/band signals depend only on the exogenous traces and
are precomputed before the step loop.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import HOURS_PER_YEAR, BatteryConfig, inv_f32
from .state import BatteryState, f32

POLICIES = ("carbon", "price", "blended")

_SCAN_BLOCK = 16


def _row_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sums along the last axis, strictly left to right."""
    out = x.clone()  # in place below: a fresh buffer the caller never sees
    for j in range(1, x.shape[-1]):
        out[..., j] = out[..., j - 1] + x[..., j]
    return out


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """f32 inclusive cumsum along the last axis with the association of the
    reference's CPU lowering: 16-wide blocks summed left to right, the block
    totals scanned the same way recursively, each block offset by the
    exclusive total of the blocks before it.  `torch.cumsum` associates
    differently, and the trailing-mean threshold below feeds strict
    comparisons, so the order is kept and the threshold stays bit-equal to
    the reference's.  Each row of an [..., n] input is scanned on its own,
    exactly as a lone [n] series."""
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _row_prefix(x)
    m = -(-n // _SCAN_BLOCK)
    lead = x.shape[:-1]
    rows = torch.cat([x, x.new_zeros(*lead, m * _SCAN_BLOCK - n)],
                     -1).reshape(*lead, m, _SCAN_BLOCK)
    within = _row_prefix(rows)
    totals = blocked_cumsum(within[..., -1].contiguous())
    before = torch.cat([totals.new_zeros(*lead, 1), totals[..., :-1]], -1)
    return (within + before[..., None]).reshape(*lead, -1)[..., :n]


def precompute_battery_signals(ci_trace, dt_h: float, cfg: BatteryConfig):
    """(threshold[..., S], ci_rising[..., S]): trailing-window mean carbon
    intensity (expanding before a full window exists), and whether the
    trace stopped decreasing at t; one row per [..., S] series."""
    ci = ci_trace.to(torch.float32)
    s = ci.shape[-1]
    w = max(int(round(cfg.threshold_window_h / dt_h)), 1)
    csum = torch.cat([ci.new_zeros(*ci.shape[:-1], 1), blocked_cumsum(ci)],
                     -1)
    idx = torch.arange(s, device=ci.device)
    lo = torch.clamp(idx + 1 - w, min=0)
    window = (idx + 1 - lo).to(torch.float32)
    threshold = (csum[..., idx + 1] - csum[..., lo]) / window
    prev = torch.cat([ci[..., :1], ci[..., :-1]], -1)
    return threshold, ci >= prev


def _select(cond, a, b):
    """where(cond, a, b) for a host bool or a bool tensor condition."""
    if isinstance(cond, torch.Tensor):
        return torch.where(cond, a, b)
    return a if cond else b


def dispatch_decision(cfg: BatteryConfig, charge, ci, threshold, ci_rising,
                      price=None, price_lo=None, price_hi=None,
                      dispatch_lambda=None):
    """(want_charge, want_discharge) bools under the configured policy.

    `dispatch_lambda` is an f32 host scalar or 0-d tensor (None: the
    config's); the blended endpoints are selected exactly."""
    want_charge = ci < threshold
    if cfg.wait_for_trough:
        want_charge = want_charge & ci_rising
    want_discharge = (ci > threshold) & (charge > 0.0)
    if cfg.policy == "carbon":
        return want_charge, want_discharge
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown battery dispatch policy '{cfg.policy}'; "
                         f"pick one of {POLICIES}")
    if price is None or price_lo is None or price_hi is None:
        raise ValueError(f"battery policy '{cfg.policy}' needs price "
                         "signals: enable cfg.pricing (core/pricing.py)")
    p_charge = price < price_lo
    p_discharge = (price > price_hi) & (charge > 0.0)
    if cfg.policy == "price":
        return p_charge, p_discharge
    lam = f32(cfg.dispatch_lambda if dispatch_lambda is None
              else dispatch_lambda)
    one_minus = np.float32(1.0) - lam
    # normalized margins: carbon in units of its rolling-mean threshold,
    # price in units of the arbitrage band's midpoint
    c_ref = torch.clamp(threshold, min=1e-6)
    p_ref = torch.clamp(0.5 * (price_lo + price_hi), min=1e-6)
    charge_score = (lam * (threshold - ci) / c_ref
                    + one_minus * (price_lo - price) / p_ref)
    discharge_score = (lam * (ci - threshold) / c_ref
                       + one_minus * (price - price_hi) / p_ref)
    b_charge = charge_score > 0.0
    if cfg.wait_for_trough:
        b_charge = b_charge & ci_rising
    b_discharge = (discharge_score > 0.0) & (charge > 0.0)
    pure_c = lam >= 1.0
    pure_p = lam <= 0.0
    return (_select(pure_c, want_charge, _select(pure_p, p_charge, b_charge)),
            _select(pure_c, want_discharge,
                    _select(pure_p, p_discharge, b_discharge)))


def surplus_aware_dispatch(want_charge, want_discharge, surplus_kw):
    """Extend a policy decision with PV-surplus awareness: surplus always
    charges (a surplus-only charge is capped at the surplus, so it never
    draws grid), and the battery never discharges into its own surplus.
    Returns (want_charge, want_discharge, charge_cap_kw)."""
    has_surplus = surplus_kw > 0.0
    charge_cap_kw = torch.where(want_charge, float("inf"), surplus_kw)
    return (want_charge | has_surplus, want_discharge & ~has_surplus,
            charge_cap_kw)


def battery_params(cfg: BatteryConfig, capacity_kwh=None, rate_kw=None):
    """(capacity, rate) as the reference forms them: f32 capacity, and the
    C-rate product taken in f32 unless a rate is given."""
    cap = f32(cfg.capacity_kwh if capacity_kwh is None else capacity_kwh)
    if rate_kw is None:
        return cap, cap * np.float32(cfg.charge_rate_kw_per_kwh)
    return cap, f32(rate_kw)


def battery_flow_step(batt: BatteryState, load_kw, ci, threshold, ci_rising,
                      dt_h: float, cfg: BatteryConfig, capacity_kwh=None,
                      rate_kw=None, price=None, price_lo=None, price_hi=None,
                      dispatch_lambda=None, pv_surplus_kw=None):
    """One battery decision in ledger terms.  Returns
    (new_state, batt_charge_kw, batt_discharge_kw)."""
    if not cfg.enabled:
        zero = torch.zeros_like(load_kw)
        return batt, zero, zero
    cap, rate = battery_params(cfg, capacity_kwh, rate_kw)
    eff = np.float32(cfg.round_trip_efficiency)

    want_charge, want_discharge = dispatch_decision(
        cfg, batt.charge, ci, threshold, ci_rising, price=price,
        price_lo=price_lo, price_hi=price_hi,
        dispatch_lambda=dispatch_lambda)
    charge_cap_kw = None
    if pv_surplus_kw is not None:
        want_charge, want_discharge, charge_cap_kw = surplus_aware_dispatch(
            want_charge, want_discharge, pv_surplus_kw)

    # clamp(max=bound) is jnp.minimum with a host-scalar or 0-d bound; the
    # reference's jitted division by the constant step is a product with
    # its f32 reciprocal
    inv_dt = inv_f32(dt_h)
    headroom_kw = (cap - batt.charge) * inv_dt
    charge_kw = torch.clamp(torch.clamp(headroom_kw, min=0.0), max=rate)
    if charge_cap_kw is not None:
        charge_kw = torch.minimum(charge_kw, charge_cap_kw)
    charge_kw = torch.where(want_charge, charge_kw, 0.0)

    avail_kw = batt.charge * inv_dt
    discharge_kw = torch.minimum(torch.clamp(avail_kw, max=rate), load_kw)
    discharge_kw = torch.where(want_discharge & ~want_charge, discharge_kw,
                               0.0)

    new_charge = torch.clamp(torch.clamp(
        batt.charge + (charge_kw * eff - discharge_kw) * dt_h, min=0.0),
        max=cap)
    return (BatteryState(charge=new_charge, was_charging=want_charge),
            charge_kw, discharge_kw)


def battery_step(batt: BatteryState, dc_power_kw, ci, threshold, ci_rising,
                 dt_h: float, cfg: BatteryConfig, capacity_kwh=None,
                 rate_kw=None, price=None, price_lo=None, price_hi=None,
                 dispatch_lambda=None):
    """One battery decision.  Returns (new_state, grid_power_kw,
    discharged_kwh): charging adds to the grid draw (the power spike of
    paper Fig 9A), discharging serves datacenter load from storage.  A thin
    wrapper over `battery_flow_step`."""
    if not cfg.enabled:
        return batt, dc_power_kw, torch.zeros((), dtype=torch.float32,
                                              device=dc_power_kw.device)
    new_state, charge_kw, discharge_kw = battery_flow_step(
        batt, dc_power_kw, ci, threshold, ci_rising, dt_h, cfg,
        capacity_kwh=capacity_kwh, rate_kw=rate_kw, price=price,
        price_lo=price_lo, price_hi=price_hi,
        dispatch_lambda=dispatch_lambda)
    grid_kw = dc_power_kw + charge_kw - discharge_kw
    return new_state, grid_kw, discharge_kw * dt_h


def battery_embodied_rate_kg_per_h(cfg: BatteryConfig) -> float:
    """Embodied carbon attributed per hour of battery ownership."""
    if not cfg.enabled:
        return 0.0
    total = cfg.capacity_kwh * cfg.embodied_kg_per_kwh
    return total / (cfg.lifetime_years * HOURS_PER_YEAR)
