"""On-site renewable generation: PV supply for the energy-flow ledger.

A PV plant of `pv_capacity_kw` nameplate produces `pv_capacity_kw * cf(t)`
from a capacity-factor trace.  Generation serves the facility load first,
then charges the battery, and the rest is exported (when
`cfg.renewables.export_allowed`) or curtailed.
"""
from __future__ import annotations

import torch

from .config import RenewableConfig


def pv_power_kw(capacity_kw, capacity_factor):
    """Instantaneous PV output."""
    return torch.clamp(capacity_kw * capacity_factor, min=0.0)


def net_load_split(load_kw, pv_kw):
    """(net_load_kw, surplus_kw): generation netted against facility load."""
    return (torch.clamp(load_kw - pv_kw, min=0.0),
            torch.clamp(pv_kw - load_kw, min=0.0))


def split_surplus(surplus_kw, charge_kw, cfg: RenewableConfig):
    """Route a PV surplus.  Returns (pv_to_batt_kw, grid_export_kw,
    curtailed_kw): the battery's charge absorbs surplus first, the rest is
    exported when the site may back-feed, else curtailed."""
    pv_to_batt = torch.minimum(charge_kw, surplus_kw)
    remainder = surplus_kw - pv_to_batt
    zero = torch.zeros_like(remainder)
    if cfg.export_allowed:
        return pv_to_batt, remainder, zero
    return pv_to_batt, zero, remainder
