"""Carbon accounting (paper §II-B, §V-C).

Operational carbon: grid energy x time-varying carbon intensity (gCO2/kWh).
Embodied carbon: provisioned hosts and battery capacity emit their
manufacturing carbon pro-rata over their lifetime for the run's duration.
"""
from __future__ import annotations

from .config import HOURS_PER_YEAR, EmbodiedConfig


def operational_carbon_kg(grid_energy_kwh, ci_g_per_kwh):
    return grid_energy_kwh * ci_g_per_kwh / 1000.0


def host_embodied_rate_kg_per_h(cfg: EmbodiedConfig) -> float:
    return cfg.host_kg / (cfg.host_lifetime_years * HOURS_PER_YEAR)


def embodied_step_kg(n_active_hosts, dt_h, emb_cfg: EmbodiedConfig,
                     battery_rate_kg_per_h):
    host_rate = host_embodied_rate_kg_per_h(emb_cfg)
    return (n_active_hosts * host_rate + battery_rate_kg_per_h) * dt_h


def carbon_delta(grid_kw, ci, dt_h, n_active_hosts, emb_cfg: EmbodiedConfig,
                 battery_rate_kg_per_h):
    """(operational_kg, embodied_kg) emitted during one step."""
    op = operational_carbon_kg(grid_kw * dt_h, ci)
    emb = embodied_step_kg(n_active_hosts, dt_h, emb_cfg,
                           battery_rate_kg_per_h)
    return op, emb
