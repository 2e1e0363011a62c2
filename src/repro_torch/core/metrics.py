"""Final metric extraction (the paper's reported quantities).

SLA definition (§VI-A): a task meets the SLA if it completes within its
grace (per-task `sla_grace`, else `cfg.sla_grace_h`) of arrival + duration;
tasks still unfinished once their deadline has passed count as violations.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import pricing as pricing_mod
from .config import SimConfig
from .state import DONE, INVALID, N_JOB_CLASSES, SimState

F32 = torch.float32


class SimResult(NamedTuple):
    total_carbon_kg: torch.Tensor
    op_carbon_kg: torch.Tensor
    emb_carbon_kg: torch.Tensor
    grid_energy_kwh: torch.Tensor
    dc_energy_kwh: torch.Tensor       # facility energy (IT + cooling)
    it_energy_kwh: torch.Tensor       # IT-equipment energy
    cooling_energy_kwh: torch.Tensor  # 0 unless cfg.cooling.enabled
    water_l: torch.Tensor             # cooling-tower evaporation (on-site)
    pue: torch.Tensor                 # dc_energy / it_energy
    wue_l_per_kwh: torch.Tensor       # water_l / it_energy
    energy_cost: torch.Tensor         # 0 unless cfg.pricing.enabled
    demand_cost: torch.Tensor         # billing-window peak charges
    export_revenue: torch.Tensor      # export-tariff earnings (renewables)
    total_cost: torch.Tensor          # energy + demand - export revenue
    pv_energy_kwh: torch.Tensor
    grid_export_kwh: torch.Tensor
    curtailed_kwh: torch.Tensor
    heat_reuse_kwh: torch.Tensor
    peak_power_kw: torch.Tensor
    sla_violation_frac: torch.Tensor
    mean_delay_h: torch.Tensor        # mean(finish - arrival - duration)
    mean_start_delay_h: torch.Tensor  # mean(first_start - arrival)
    done_frac: torch.Tensor
    n_tasks: torch.Tensor
    n_interrupts: torch.Tensor
    n_stops: torch.Tensor
    batt_discharged_kwh: torch.Tensor
    lost_work_h: torch.Tensor
    throttled_h: torch.Tensor
    derate_h: torch.Tensor
    n_spills: torch.Tensor
    n_done: torch.Tensor
    n_started: torch.Tensor
    n_decided: torch.Tensor
    class_sla_violation_frac: torch.Tensor  # f32[C], JOB_* order
    class_mean_start_delay_h: torch.Tensor  # f32[C]
    class_n_violations: torch.Tensor        # f32[C]
    class_n_decided: torch.Tensor           # f32[C]
    class_n_started: torch.Tensor           # f32[C]
    probes: Any = None


def summarize(state: SimState, cfg: SimConfig) -> SimResult:
    """The run's SimResult.  Task reductions run along the last axis, so a
    state of B scenario rows ([B, T] written columns, [B, 1] accumulators)
    gives [B] fields (per-class fields [B, C]), and a one-scenario state
    0-d ones ([C])."""
    tasks, m = state.tasks, state.metrics
    t_end = state.t
    arrived = (tasks.status != INVALID) & (tasks.arrival <= t_end)
    done = tasks.status == DONE
    lead = arrived.shape[:-1]
    m = type(m)(*(x.reshape(lead) for x in m))

    expected = tasks.arrival + tasks.duration
    grace = torch.where(tasks.sla_grace >= 0.0, tasks.sla_grace,
                        float(cfg.sla_grace_h))
    deadline = expected + grace
    violated_done = done & (tasks.finish > deadline)
    violated_undone = arrived & ~done & (deadline <= t_end)
    decided = done | violated_undone
    cnt = lambda mask: mask.to(F32).sum(-1)  # noqa: E731
    n_decided = torch.clamp(cnt(decided), min=1.0)
    n_viol = cnt(violated_done) + cnt(violated_undone)
    n_arrived = cnt(arrived)
    n_valid = torch.clamp(n_arrived, min=1.0)

    n_done = torch.clamp(cnt(done), min=1.0)
    delay = torch.where(done, torch.clamp(tasks.finish - expected, min=0.0),
                        0.0)
    started = arrived & torch.isfinite(tasks.first_start)
    n_started = torch.clamp(cnt(started), min=1.0)
    sdelay = torch.where(started, tasks.first_start - tasks.arrival, 0.0)

    # per-class splits: one masked reduction a class ([.., C] fields);
    # violated_done and violated_undone are disjoint, so class counts sum
    # to the totals
    stacked = torch.stack([(violated_done | violated_undone).to(F32),
                           decided.to(F32), started.to(F32), sdelay])
    class_n_viol, class_n_decided, class_n_started, class_sdelay = (
        torch.stack([torch.where(tasks.job_class == c, stacked, 0.0).sum(-1)
                     for c in range(N_JOB_CLASSES)], -1))

    it_safe = torch.clamp(m.it_energy, min=1e-9)
    demand_cost = pricing_mod.settle_demand_charge(
        m.demand_cost, m.window_peak_kw, cfg.pricing)
    return SimResult(
        total_carbon_kg=m.op_carbon + m.emb_carbon,
        op_carbon_kg=m.op_carbon,
        emb_carbon_kg=m.emb_carbon,
        grid_energy_kwh=m.grid_energy,
        dc_energy_kwh=m.dc_energy,
        it_energy_kwh=m.it_energy,
        cooling_energy_kwh=m.cooling_energy,
        water_l=m.water_l,
        pue=m.dc_energy / it_safe,
        wue_l_per_kwh=m.water_l / it_safe,
        energy_cost=m.energy_cost,
        demand_cost=demand_cost,
        export_revenue=m.export_revenue,
        total_cost=m.energy_cost + demand_cost - m.export_revenue,
        pv_energy_kwh=m.pv_energy,
        grid_export_kwh=m.export_energy,
        curtailed_kwh=m.curtailed_energy,
        heat_reuse_kwh=m.heat_reuse,
        peak_power_kw=m.peak_power,
        sla_violation_frac=n_viol / n_decided,
        mean_delay_h=delay.sum(-1) / n_done,
        mean_start_delay_h=sdelay.sum(-1) / n_started,
        done_frac=cnt(done) / n_valid,
        n_tasks=n_arrived,
        n_interrupts=m.n_interrupts,
        n_stops=m.n_stops,
        batt_discharged_kwh=m.batt_discharged,
        lost_work_h=torch.where(arrived, tasks.lost_work, 0.0).sum(-1),
        throttled_h=m.throttled_h,
        derate_h=m.derate_h,
        n_spills=m.n_spills,
        n_done=cnt(done),
        n_started=cnt(started),
        n_decided=cnt(decided),
        class_sla_violation_frac=class_n_viol
        / torch.clamp(class_n_decided, min=1.0),
        class_mean_start_delay_h=class_sdelay
        / torch.clamp(class_n_started, min=1.0),
        class_n_violations=class_n_viol,
        class_n_decided=class_n_decided,
        class_n_started=class_n_started,
        probes=None if state.probes is None else state.probes.probes(),
    )


def result_to_numpy(res: SimResult) -> dict:
    """{field: numpy value} of a SimResult (None fields dropped; the probes
    as {probe field: numpy value}), for comparisons against the reference
    package's results."""
    def np_(v):
        if isinstance(v, tuple):
            return {k: np_(x) for k, x in v._asdict().items()}
        return v.detach().cpu().numpy()
    return {k: np_(v) for k, v in res._asdict().items() if v is not None}


def fleet_totals(per_region: SimResult, axis: int = 0) -> SimResult:
    """Aggregate per-region SimResults into one fleet-level SimResult.

    Additive fields (carbon, energy, water, counts, lost work) sum over the
    region axis `axis`; ratio fields recombine exactly from the raw outcome
    counts (`n_done` / `n_started` / `n_decided` / `n_tasks`) rather than
    averaging the per-region ratios, so an empty region counts 0, not 1.
    PUE and WUE come from the summed energies.  `peak_power_kw` and the
    costs sum: each region is a facility with its own grid feed and meter.
    Class fields [.., R, C] reduce over R and keep the class axis.  Probes
    are per region and stay on `per_region`: the total carries none, as in
    the reference.
    """
    def s(x):
        return x.sum(axis)

    def wmean(value, weight):
        return (value * weight).sum(axis) / torch.clamp(s(weight), min=1.0)

    p = per_region
    it_safe = torch.clamp(s(p.it_energy_kwh), min=1e-9)
    additive = ("total_carbon_kg", "op_carbon_kg", "emb_carbon_kg",
                "grid_energy_kwh", "dc_energy_kwh", "it_energy_kwh",
                "cooling_energy_kwh", "water_l", "energy_cost", "demand_cost",
                "export_revenue", "total_cost", "pv_energy_kwh",
                "grid_export_kwh", "curtailed_kwh", "heat_reuse_kwh",
                "peak_power_kw", "n_tasks", "n_interrupts", "n_stops",
                "batt_discharged_kwh", "lost_work_h", "throttled_h",
                "derate_h", "n_spills", "n_done", "n_started", "n_decided",
                "class_n_violations", "class_n_decided", "class_n_started")
    return SimResult(
        **{f: s(getattr(p, f)) for f in additive},
        pue=s(p.dc_energy_kwh) / it_safe,
        wue_l_per_kwh=s(p.water_l) / it_safe,
        sla_violation_frac=wmean(p.sla_violation_frac, p.n_decided),
        mean_delay_h=wmean(p.mean_delay_h, p.n_done),
        mean_start_delay_h=wmean(p.mean_start_delay_h, p.n_started),
        done_frac=wmean(p.done_frac, p.n_tasks),
        class_sla_violation_frac=(s(p.class_n_violations) / torch.clamp(
            s(p.class_n_decided), min=1.0)),
        class_mean_start_delay_h=wmean(p.class_mean_start_delay_h,
                                       p.class_n_started),
        probes=None)


def carbon_reduction_pct(baseline: SimResult, treated: SimResult):
    """Positive = treated emits less total carbon than baseline."""
    return 100.0 * (1.0 - treated.total_carbon_kg
                    / torch.clamp(baseline.total_carbon_kg, min=1e-9))


# ---------------------------------------------------------------------------
# paper §XI: water consumption and monetary cost
# ---------------------------------------------------------------------------

class SustainabilityExtras(NamedTuple):
    """Water, cost and the heat-reuse credit of a SimResult (paper §XI):
    the simulated values where the thermal and pricing subsystems ran, the
    flat-intensity estimates where they did not."""
    water_l: torch.Tensor         # on-site + upstream water, litres
    energy_cost: torch.Tensor     # electricity bill, currency units
    heat_credit_kg: torch.Tensor  # CO2 displaced by reclaimed district heat


def sustainability_extras(res: SimResult, *, cfg: SimConfig | None = None,
                          wue_l_per_kwh: float = 1.8,
                          water_intensity_l_per_kwh: float = 1.6,
                          price_per_kwh: float = 0.12,
                          displaced_heat_kg_per_kwh: float = 0.2,
                          simulated_water: bool | None = None,
                          simulated_cost: bool | None = None,
                          ) -> SustainabilityExtras:
    """On-site water: the simulated cooling-tower evaporation when the
    thermal subsystem ran, else `dc_energy * wue_l_per_kwh`.  Cost: the
    simulated bill when the pricing subsystem ran, else the flat tariff
    `price_per_kwh * grid_energy`.  Upstream water (`grid_energy *
    water_intensity_l_per_kwh`) is always an estimate.

    Which subsystems ran comes from `cfg` (or `simulated_water` /
    `simulated_cost`); without either it is inferred per cell, as the
    reference does: water from `cooling_energy_kwh > 0`, cost from
    `total_cost != 0 or export_revenue > 0` (a simulated bill may be zero
    or negative once the export tariff runs; an all-zero price trace
    still reads as "not simulated").  `heat_credit_kg` credits every
    reclaimed kWh with `displaced_heat_kg_per_kwh`; it is reported beside
    the carbon totals, never subtracted from them."""
    if cfg is not None:
        if simulated_water is None:
            simulated_water = cfg.cooling.enabled
        if simulated_cost is None:
            simulated_cost = cfg.pricing.enabled
    if simulated_water is None:
        onsite = torch.where(res.cooling_energy_kwh > 0.0, res.water_l,
                             res.dc_energy_kwh * wue_l_per_kwh)
    elif simulated_water:
        onsite = res.water_l
    else:
        onsite = res.dc_energy_kwh * wue_l_per_kwh
    water = onsite + res.grid_energy_kwh * water_intensity_l_per_kwh
    flat_cost = pricing_mod.flat_energy_cost(res.grid_energy_kwh,
                                             price_per_kwh)
    if simulated_cost is None:
        simulated = (res.total_cost != 0.0) | (res.export_revenue > 0.0)
        cost = torch.where(simulated, res.total_cost, flat_cost)
    elif simulated_cost:
        cost = res.total_cost
    else:
        cost = flat_cost
    return SustainabilityExtras(
        water_l=water, energy_cost=cost,
        heat_credit_kg=res.heat_reuse_kwh * displaced_heat_kg_per_kwh)
