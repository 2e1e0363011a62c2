"""Weather-driven cooling: chiller + free-cooling economizer + cooling tower.

Converts IT power into facility power and tower water per step, from the
wet-bulb temperature and the cooling setpoint, with the reference's model:
a fan/pump overhead proportional to IT load; a water-side economizer that
carries the whole load below `setpoint - economizer_range_c` and ramps the
chiller duty linearly to 1 at the setpoint; a Carnot-fraction chiller whose
COP depends on the tower's condenser temperature, clipped to [1, max_cop];
and evaporation of the chiller-path heat.

`setpoint_c` is a 0-d f32 tensor (a dyn value) or None for the config's
setpoint.  `chiller_derate` (the facility-failure series of
core/resilience.py, 1.0 healthy) degrades both paths while the chiller is
derated: the economizer's availability and the COP ceiling shrink.  None
keeps the healthy expressions bit for bit (`1 - (1 - frac) * 1.0` is not
`frac` in f32).
"""
from __future__ import annotations

import numpy as np
import torch

from .config import CoolingConfig, inv_f32
from .state import f32

_T_ZERO_K = 273.15
_MIN_LIFT_C = 1.0  # floor on the compressor lift: no free chilling


def _setpoint(cfg: CoolingConfig, setpoint_c):
    return f32(cfg.setpoint_c if setpoint_c is None else setpoint_c)


def economizer_fraction(wet_bulb_c, cfg: CoolingConfig, setpoint_c=None,
                        availability=None):
    """Fraction of the heat load the chiller must carry (0 = all free);
    with `availability`, ``1 - (1 - frac) * availability``."""
    sp = _setpoint(cfg, setpoint_c)
    rng = np.maximum(np.float32(cfg.economizer_range_c), np.float32(1e-6))
    # f32 scalar arithmetic on both sides, as in the reference; its jitted
    # division by the constant range is a product with the reciprocal
    lo = sp - rng
    frac = torch.clamp((wet_bulb_c - lo) * inv_f32(rng), 0.0, 1.0)
    if availability is None:
        return frac
    return 1.0 - (1.0 - frac) * availability


def chiller_cop(wet_bulb_c, cfg: CoolingConfig, setpoint_c=None,
                max_cop_scale=None):
    """Weather-dependent chiller COP, monotone non-increasing in wet-bulb;
    `max_cop_scale` lowers the ceiling to ``max(max_cop * scale, 1)``."""
    sp = _setpoint(cfg, setpoint_c)
    t_cond = wet_bulb_c + cfg.tower_approach_c + cfg.condenser_lift_c
    lift = torch.clamp(t_cond - sp, min=_MIN_LIFT_C)
    # f32 on both operands at every scalar step (np.float32 or 0-d tensor)
    hot = (sp + np.float32(_T_ZERO_K)) * np.float32(cfg.carnot_efficiency)
    if not isinstance(hot, torch.Tensor):
        # `scalar / tensor` multiplies by the reciprocal; keep the division
        hot = torch.full_like(lift, float(hot))
    if max_cop_scale is None:
        return torch.clamp(hot / lift, 1.0, cfg.max_cop)
    ceil = torch.clamp(cfg.max_cop * max_cop_scale, min=1.0)
    return torch.minimum(torch.clamp(hot / lift, min=1.0), ceil)


def cooling_step(it_power_kw, wet_bulb_c, cfg: CoolingConfig,
                 setpoint_c=None, chiller_derate=None):
    """One cooling decision.  Returns (cooling_kw, water_l_per_h)."""
    frac = economizer_fraction(wet_bulb_c, cfg, setpoint_c,
                               availability=chiller_derate)
    cop = chiller_cop(wet_bulb_c, cfg, setpoint_c,
                      max_cop_scale=chiller_derate)
    fan_kw = cfg.fan_pump_overhead * it_power_kw
    chiller_kw = frac * it_power_kw / cop
    water_l_per_h = (frac * it_power_kw + chiller_kw) * cfg.evap_l_per_kwh_heat
    return fan_kw + chiller_kw, water_l_per_h


def reclaimable_heat_kw(it_power_kw, cooling_kw, wet_bulb_c,
                        cfg: CoolingConfig, setpoint_c=None,
                        chiller_derate=None):
    """Chiller-path heat flow (load + compressor work) available for reuse:
    cooling power minus the fan/pump overhead, plus the chiller-path load
    (pass the `chiller_derate` that `cooling_step` was given)."""
    frac = economizer_fraction(wet_bulb_c, cfg, setpoint_c,
                               availability=chiller_derate)
    chiller_kw = cooling_kw - cfg.fan_pump_overhead * it_power_kw
    return frac * it_power_kw + chiller_kw


def dynamic_pue(it_power_kw, wet_bulb_c, cfg: CoolingConfig,
                setpoint_c=None):
    """Instantaneous PUE = facility / IT power (>= 1; load-independent,
    since both cooling terms scale linearly with IT power)."""
    it_kw = torch.as_tensor(it_power_kw, dtype=torch.float32)
    wb = torch.as_tensor(wet_bulb_c, dtype=torch.float32, device=it_kw.device)
    cooling_kw, _ = cooling_step(it_kw, wb, cfg, setpoint_c)
    it = torch.clamp(it_kw, min=1e-9)
    return (it + cooling_kw) / it
