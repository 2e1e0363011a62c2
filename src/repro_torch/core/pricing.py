"""Electricity-price subsystem: energy + demand charges (paper §XI, cost).

  * Energy charge: per-step `grid_kw * price(t) * dt`.
  * Demand charge: the peak metered grid draw of each billing window, billed
    at `demand_charge_per_kw` when the window closes; `summarize` settles
    the final open window.
  * Dispatch signals: the forward price-quantile bands the battery's
    'price' and 'blended' policies arbitrage against, precomputed with the
    shifting threshold's windowed quantiles.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import BatteryConfig, PricingConfig
from .shifting import forward_window_quantiles


def billing_window_steps(cfg: PricingConfig, dt_h: float) -> int:
    """Steps per demand-charge billing window."""
    return max(int(round(cfg.billing_window_h / dt_h)), 1)


def precompute_price_signals(price_trace, dt_h: float, cfg: BatteryConfig):
    """(price_lo[..., S], price_hi[..., S]) forward-quantile arbitrage
    bands, one row per [..., S] price series: charge while strictly below
    `price_lo`, discharge while strictly above `price_hi` (a constant trace
    makes both vacuous)."""
    bands = forward_window_quantiles(
        price_trace, dt_h, cfg.price_window_h,
        np.asarray([cfg.price_charge_quantile,
                    cfg.price_discharge_quantile], np.float32))
    return bands[0], bands[1]


def pricing_step(energy_cost, demand_cost, window_peak_kw, grid_kw, price,
                 step, dt_h: float, window_steps: int,
                 demand_charge_per_kw: float):
    """One billing update.  Returns (energy_cost, demand_cost, window_peak).

    When `step` crosses a window boundary the previous window's peak is
    billed and the running peak resets before absorbing this step's draw."""
    energy_cost = energy_cost + grid_kw * price * dt_h
    close = (step % window_steps == 0) & (step > 0)
    demand_cost = demand_cost + torch.where(
        close, window_peak_kw * np.float32(demand_charge_per_kw), 0.0)
    window_peak_kw = torch.maximum(torch.where(close, 0.0, window_peak_kw),
                                   grid_kw)
    return energy_cost, demand_cost, window_peak_kw


def export_revenue_step(export_revenue, grid_export_kw, price, dt_h: float,
                        cfg: PricingConfig):
    """Exported surplus earns `export_price_fraction` of the spot price."""
    return export_revenue + (grid_export_kw * price * dt_h
                             * np.float32(cfg.export_price_fraction))


def settle_demand_charge(demand_cost, window_peak_kw, cfg: PricingConfig):
    """Total demand cost incl. the final open billing window's peak."""
    return demand_cost + window_peak_kw * np.float32(cfg.demand_charge_per_kw)


def flat_energy_cost(grid_energy_kwh, price_per_kwh: float):
    """The flat-tariff estimate (`metrics.sustainability_extras`'s
    fallback)."""
    return grid_energy_kwh * price_per_kwh
