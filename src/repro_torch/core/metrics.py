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
        probes=state.probes,
    )


def result_to_numpy(res: SimResult) -> dict:
    """{field: numpy value} of a SimResult (None fields dropped), for
    comparisons against the reference package's results."""
    return {k: v.detach().cpu().numpy() for k, v in res._asdict().items()
            if v is not None}
