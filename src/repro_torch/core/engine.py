"""The STEAM engine: a composable stage pipeline driven by a Python loop.

A simulation step is a pipeline of plain stages `(state, ctx) -> (state,
ctx)`; each sustainability technique is one stage, and the pipeline is
composed in Python from the static config before the loop starts.  The
default pipeline follows the reference's event cascade:

  checkpoint -> failures -> task_stopper -> scheduler -> progress -> power
  -> cooling -> renewables -> battery -> pricing -> carbon -> resilience
  -> probes

Power flows between the facility stages travel on an explicit energy-flow
ledger (`ctx["flow"]`, an `EnergyFlow`) that obeys, per step,

    grid_import + pv + batt_discharge
        == it + cooling + batt_charge + grid_export + curtailed

(checked by the tests, not at run time).

Step executors (`cfg.backend`)
------------------------------
  * ``stage-pipeline`` -- every stage runs every step, S times.
  * ``megakernel`` -- the run split at its one sequential boundary: a demand
    loop (stopper -> scheduler -> progress -> IT power) that writes `it_kw`
    into an [S] tensor, then the whole facility half (cooling -> renewables
    -> battery -> pricing -> carbon) over the horizon at once.

Kernels.  Which code runs is picked by the device of the tables, never by
a flag: on the card the scheduler's placement is the first-fit kernel, the
power stage is the fused power kernel (with the cooling tail when cooling
is on), and the megakernel's facility half is the fused facility kernel;
on the CPU the same calls take the kernels' plain versions
(kernels/ops.py).  `cfg.use_pallas` is kept for config parity and read by
nothing.  Under `cfg.collect_series` or `cfg.probes` the megakernel's
facility half takes the facility kernel's series route, which writes every
step's flows beside the same totals (`ops.fused_facility_chain`).

No stage reads a value back from the device: the loop enqueues work and
never waits for it.

Scenario rows.  One run carries B scenarios at once (`run_cells`): the
cells of a scenario grid (core/grid.py), the regions of a fleet
(core/fleet.py: every task column a row's own [B, W] table), or the one
scenario of `simulate` (B = 1, the leading axis squeezed at the end).  The
state's layout is that of core/state.py: written task columns [B, T],
shared columns [1, T], a row's scalars [B, 1]; every stage works along the
last axis, so each step runs every stage once for all rows, and each kernel
of the path is one launch a step (the facility kernel one a run) whatever B
is.

Failures and resilience.  Host failures draw the reference's threefry bits
(core/threefry.py), and neither their keys nor their probabilities depend
on the simulation state: `build_step_inputs` walks the key chain on the
host and draws every step's [B, H] failure flags on the device before the
loop, beside the facility failure series (chiller derate, PDU cap) of
core/resilience.py; each step reads its slice.  With resilience on, the
power stage takes the power kernel without its cooling tail (the PDU clamp
sits between the IT sum and the cooling model), the throttle of the next
step is a [B, 1] state, and the megakernel's facility kernel takes the
derate series.

Telemetry (core/telemetry.py).  With `cfg.probes` enabled the stage
pipeline's last stage samples the settled ledger every `stride` steps into
a ring ([B, F, K], one write a sampled step; the host knows the step, so
other steps launch nothing); the megakernel records the demand half's
channels at the sampled steps and gathers the rest from the facility
series.  With a telemetry session active, each stage and the megakernel's
two halves run in a `stage_scope` (composed once, before the loop), and
`simulate` cuts a "simulate" run record; with none, the loop is unchanged.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from ..kernels import ops
from . import battery as battery_mod
from . import carbon as carbon_mod
from . import failures as failures_mod
from . import pricing as pricing_mod
from . import renewables as renewables_mod
from . import resilience as resilience_mod
from . import scaling as scaling_mod
from . import scheduler as scheduler_mod
from . import shifting as shifting_mod
from . import state as state_mod
from . import telemetry
from . import thermal as thermal_mod
from .config import HOURS_PER_YEAR, SimConfig, inv_f32
from .state import (DONE, PENDING, RUNNING, BatteryState, HostTable,
                    MetricsAcc, SimState, TaskTable, as_tensor, f32,
                    init_sim_state)

F32 = torch.float32
BACKENDS = ("stage-pipeline", "megakernel")

Stage = Callable[[SimState, dict], tuple[SimState, dict]]

# dyn keys of the resilience loop, refused (as in the reference) when it
# is off
_RESILIENCE_KEYS = ("throttle_inlet_c", "pdu_cap_kw", "failure_hazard_scale")


class EnergyFlow(NamedTuple):
    """Per-step facility power ledger (kW)."""
    it_kw: torch.Tensor
    cooling_kw: torch.Tensor
    pv_kw: torch.Tensor
    batt_charge_kw: torch.Tensor
    batt_discharge_kw: torch.Tensor
    grid_import_kw: torch.Tensor
    grid_export_kw: torch.Tensor
    curtailed_kw: torch.Tensor


def init_energy_flow(device="cuda", shape=()) -> EnergyFlow:
    """The ledger at the start of a step: zeros of `shape` ([B, 1] for B
    scenario rows)."""
    # one shared zero: ledger fields are only ever replaced, never mutated
    z = torch.zeros(shape, dtype=F32, device=device)
    return EnergyFlow(*([z] * len(EnergyFlow._fields)))


class StepInputs(NamedTuple):
    """Exogenous per-step inputs, all precomputed.  The series are
    f32/bool[..., S]: [S] for one scenario, [B, S] where the scenario rows
    differ.  With host failures on, `host_fail` holds every step's failure
    draws, bool [S, B, H], and `rng_keys` the rows' threefry keys, int64
    [S + 1, B, 2] (before each step and after the last); one step's inputs
    hold that step's [B, H] draws and the [B, 2] key after it."""
    ci: torch.Tensor
    batt_threshold: torch.Tensor
    ci_rising: torch.Tensor
    shift_threshold: torch.Tensor
    wet_bulb_c: torch.Tensor
    price: torch.Tensor
    price_lo: torch.Tensor
    price_hi: torch.Tensor
    pv_cf: torch.Tensor
    # facility failure injection (core/resilience.py): ones and +inf when
    # resilience is off
    chiller_derate: torch.Tensor  # f32 COP / economizer scale
    pdu_cap_kw: torch.Tensor      # f32 rack-power clamp
    host_fail: torch.Tensor | None = None
    rng_keys: torch.Tensor | None = None


# the [..., S] series of StepInputs
SERIES = StepInputs._fields[:11]


def _trace(x, n: int, what: str, device):
    x = as_tensor(x, F32, device)
    if x.shape[-1] < n:
        raise ValueError(f"{what} trace too short: {x.shape[-1]} < {n}")
    return x[..., :n]


def _host_values(v):
    """A dyn value as a host number or numpy array (a tensor is read
    once, before the loop)."""
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v


def _column(v, device) -> torch.Tensor:
    """A dyn value as an f32 tensor on `device`: 0-d for one value, [B, 1]
    for one a row (made once, before the loop)."""
    x = torch.tensor(np.asarray(_host_values(v), np.float32), device=device)
    return x.reshape(-1, 1) if x.dim() else x


def build_step_inputs(ci_trace, cfg: SimConfig, dyn: dict | None = None,
                      device="cuda", n_hosts: int | None = None
                      ) -> StepInputs:
    """The exogenous per-step inputs of a run.  Each trace (carbon, and
    the dyn `wet_bulb_trace`, `price_trace`, `pv_cf_trace`) is [S] or one
    row a scenario, [B, S]; a swept `shift_quantile_value` ([B] levels)
    gives [B, S] thresholds.  Every signal is computed row by row, and a
    field is [B, S] only where its own inputs are.

    With resilience on, the facility failure series come from the dyn
    `seed` (else `cfg.seed`), `failure_hazard_scale` and `pdu_cap_kw` (one
    value, or one a row).  With host failures on and `n_hosts` given, the
    step's host failure draws and keys too (`StepInputs.host_fail`,
    `rng_keys`)."""
    dyn = dyn or {}
    s = cfg.n_steps
    ci = _trace(ci_trace, s, "carbon", device)
    bt, rising = battery_mod.precompute_battery_signals(ci, cfg.dt_h,
                                                        cfg.battery)
    st = (shifting_mod.precompute_shift_threshold(
              ci, cfg.dt_h, cfg.shifting,
              quantile=dyn.get("shift_quantile_value"))
          if cfg.shifting.enabled else torch.zeros_like(ci))
    wb = dyn.get("wet_bulb_trace")
    wb = (torch.full_like(ci, cfg.cooling.setpoint_c) if wb is None
          else _trace(wb, s, "weather", device))
    price_policy = cfg.battery.enabled and cfg.battery.policy != "carbon"
    if price_policy and not cfg.pricing.enabled:
        raise ValueError(
            f"battery dispatch policy '{cfg.battery.policy}' arbitrages the "
            "price trace but cfg.pricing.enabled is False: enable the "
            "pricing subsystem (core/pricing.py)")
    zeros = torch.zeros_like(ci)
    if cfg.pricing.enabled:
        pr = dyn.get("price_trace")
        pr = (torch.full_like(ci, cfg.pricing.flat_price_per_kwh)
              if pr is None else _trace(pr, s, "price", device))
        plo, phi = (pricing_mod.precompute_price_signals(pr, cfg.dt_h,
                                                         cfg.battery)
                    if price_policy else (zeros, zeros))
    else:
        pr = plo = phi = zeros
    cf = dyn.get("pv_cf_trace")
    if cfg.renewables.enabled:
        cf = zeros if cf is None else _trace(cf, s, "pv", device)
    else:
        if cf is not None:
            raise ValueError(
                "a pv_cf_trace was provided but cfg.renewables.enabled is "
                "False: the PV trace would be silently ignored — enable the "
                "renewables subsystem (core/renewables.py)")
        cf = zeros
    seed = _host_values(dyn.get("seed", cfg.seed))
    hz = dyn.get("failure_hazard_scale")
    if cfg.resilience.enabled:
        derate, pdu_down = resilience_mod.facility_failure_series(
            seed, s, cfg.dt_h, cfg.resilience,
            hazard_scale=None if hz is None else _host_values(hz),
            device=device)
        cap = _column(dyn.get("pdu_cap_kw", cfg.resilience.pdu_cap_kw),
                      device)
        pdu_cap = torch.where(pdu_down, cap, float("inf"))
    else:
        derate = torch.ones_like(ci)
        pdu_cap = torch.full_like(ci, float("inf"))
    fail = keys = None
    if cfg.failures.enabled and n_hosts is not None:
        hazard = None
        if cfg.resilience.enabled:  # one hazard a row and step
            hazard = (1.0 if hz is None else _column(hz, device)
                      ) * torch.ones_like(derate)
            heat = cfg.resilience.heat_hazard_mult
            if heat > 0.0:  # a derated chiller cooks the hosts
                hazard = hazard * (1.0 + heat * (1.0 - derate))
        p_fail = failures_mod.failure_probability(
            hazard, cfg.dt_h, cfg.failures.mtbf_h).to(device)
        if not p_fail.dim():
            p_fail = p_fail.expand(s)
        keys, fail = failures_mod.draw_host_failures(seed, p_fail, n_hosts,
                                                     device)
    return StepInputs(ci=ci, batt_threshold=bt, ci_rising=rising,
                      shift_threshold=st, wet_bulb_c=wb, price=pr,
                      price_lo=plo, price_hi=phi, pv_cf=cf,
                      chiller_derate=derate, pdu_cap_kw=pdu_cap,
                      host_fail=fail, rng_keys=keys)


# --------------------------------------------------------------------------
# stages
# --------------------------------------------------------------------------

def stage_failures(cfg: SimConfig) -> Stage:
    """Host failures and repairs from the step's precomputed draws
    (`ctx["host_fail"]`), the key advanced to the step's next key, and the
    tasks on failed hosts requeued."""
    def fn(state: SimState, ctx: dict):
        hosts, newly_down = failures_mod.host_failure_transition(
            state.hosts, state.t, ctx["host_fail"], cfg.failures)
        tasks, n_int = failures_mod.interrupt_tasks(state.tasks, newly_down,
                                                    cfg.failures)
        metrics = state.metrics._replace(
            n_interrupts=state.metrics.n_interrupts + n_int[..., None])
        return state._replace(rng=ctx["rng_next"], hosts=hosts, tasks=tasks,
                              metrics=metrics), ctx
    return fn


def stage_checkpoint(cfg: SimConfig) -> Stage:
    """Snapshot running tasks on the checkpoint boundaries; the step index
    comes from the loop (`ctx["step_index"]`), so other steps launch
    nothing."""
    isteps = failures_mod.checkpoint_interval_steps(cfg.failures, cfg.dt_h)

    def fn(state: SimState, ctx: dict):
        tasks = failures_mod.checkpoint_tick(
            state.tasks, ctx.get("step_index", state.step), isteps,
            cfg.failures)
        return state._replace(tasks=tasks), ctx
    return fn


def stage_task_stopper(cfg: SimConfig) -> Stage:
    def fn(state: SimState, ctx: dict):
        tasks = state.tasks
        stop = shifting_mod.should_stop(ctx["ci"], ctx["shift_threshold"],
                                        state.t, tasks.arrival, cfg.shifting,
                                        shiftable=tasks.shiftable)
        stop = stop & (tasks.status == RUNNING)
        n = stop.to(F32).sum(-1, keepdim=True)
        tasks = tasks._replace(
            status=torch.where(stop, PENDING, tasks.status).to(torch.int32),
            host=torch.where(stop, -1, tasks.host).to(torch.int32))
        # graceful pauses roll back no work: their own counter, not
        # n_interrupts
        metrics = state.metrics._replace(n_stops=state.metrics.n_stops + n)
        return state._replace(tasks=tasks, metrics=metrics), ctx
    return fn


def _presort_enabled(cfg: SimConfig) -> bool:
    """True when `simulate` permutes the task table into (priority desc,
    arrival) row order before the loop, and the scheduler stage runs its
    presorted FIFO-prefix path."""
    return (cfg.scheduler.priority_levels > 1
            and cfg.scheduler.mode == "first_fit")


def stage_scheduler(cfg: SimConfig) -> Stage:
    reactive = cfg.resilience.enabled and cfg.resilience.reactive_placement
    presorted = _presort_enabled(cfg)

    def fn(state: SimState, ctx: dict):
        tasks = state.tasks
        shift_ok = shifting_mod.start_allowed(
            ctx["ci"], ctx["shift_threshold"], state.t, tasks.arrival,
            cfg.shifting, shiftable=tasks.shiftable)
        n_delayed = ((tasks.status == PENDING) & (tasks.arrival <= state.t)
                     & ~shift_ok).to(F32).sum(-1, keepdim=True)
        order = (resilience_mod.host_rank(state.hosts, state.t)
                 if reactive else None)
        tasks = scheduler_mod.schedule_step(
            tasks, state.hosts, state.t, shift_ok, cfg.scheduler,
            slots=ctx.get("slots_per_step"), host_order=order,
            presorted=presorted)
        metrics = state.metrics._replace(
            n_shift_delays=state.metrics.n_shift_delays + n_delayed)
        return state._replace(tasks=tasks, metrics=metrics), ctx
    return fn


def stage_progress(cfg: SimConfig) -> Stage:
    resil = cfg.resilience.enabled

    def fn(state: SimState, ctx: dict):
        tasks = state.tasks
        running = tasks.status == RUNNING
        h = state.hosts.speed.shape[-1]
        speed = scheduler_mod.take(state.hosts.speed,
                                   torch.clamp(tasks.host, 0, h - 1).long())
        if resil:  # the throttle computed at the end of the previous step
            speed = speed * state.throttle
        advance = cfg.dt_h * torch.where(running, speed, 1.0)
        done_now = running & (tasks.remaining <= advance)
        finish = torch.where(
            done_now, state.t + tasks.remaining / torch.clamp(speed,
                                                              min=1e-6),
            tasks.finish)
        remaining = torch.where(
            running, torch.clamp(tasks.remaining - advance, min=0.0),
            tasks.remaining)
        tasks = tasks._replace(
            remaining=remaining, finish=finish,
            status=torch.where(done_now, DONE, tasks.status).to(torch.int32),
            host=torch.where(done_now, -1, tasks.host).to(torch.int32))
        return state._replace(tasks=tasks), ctx
    return fn


def _row_param(cache: dict, key: str, value, like: torch.Tensor):
    """A kernel's per-row parameter: a [B, 1] (or 0-d) tensor as [B] (or
    [1]); a host number as an f32 [B] tensor on `like`'s device, made once
    per run (a per-step host-to-device copy would wait for the device)."""
    if isinstance(value, torch.Tensor):
        return value.reshape(-1)
    if key not in cache:
        cache[key] = torch.full(like.shape[:-1], float(np.float32(value)),
                                dtype=F32, device=like.device)
    return cache[key]


def _host_inputs(hosts, cpu_u):
    """(n_gpus, on) of every scenario row, as the power kernels take them:
    [B, H] like the utilizations (shared rows broadcast)."""
    return (hosts.n_gpus.expand_as(cpu_u),
            (hosts.active & hosts.up).to(F32).expand_as(cpu_u))


def _throttled_it_kw(state: SimState, cfg: SimConfig, ctx: dict):
    """(per-host power, raw IT sum [B, 1], the IT draw after the PDU clamp,
    utilizations) of the resilience route: the utilizations capped by the
    step's throttle, kernel 1 for power and its sum, then the clamp."""
    hosts = state.hosts
    cpu_u, gpu_u = scheduler_mod.host_utilization(state.tasks, hosts)
    cpu_u, gpu_u = cpu_u * state.throttle, gpu_u * state.throttle
    p, it_kw = ops.host_power(cpu_u, gpu_u, *_host_inputs(hosts, cpu_u),
                              cfg.cpu_power, cfg.gpu_power)
    raw = it_kw[:, None]
    return p, raw, torch.minimum(raw, ctx["pdu_cap_kw"]), cpu_u, gpu_u


def stage_power(cfg: SimConfig) -> Stage:
    """Writes `flow.it_kw` (and provisionally `flow.grid_import_kw`).

    With cooling on, one fused call yields per-host power, the IT sum and
    the cooling tail, which `stage_cooling` then reads from ctx.  With
    resilience on, the step's throttle caps the utilizations, kernel 1
    sums the power and the PDU failure process clamps the sum (`flow.it_kw`
    is the clamped draw; the raw one goes to ctx for the next throttle)."""
    cache: dict = {}
    resil = cfg.resilience.enabled

    def fn(state: SimState, ctx: dict):
        hosts = state.hosts
        if cfg.collect_series:  # capacity-invariant probe for tests
            ctx["max_overcommit"] = _max_overcommit(state.tasks, hosts)
        if resil:
            p, raw, it_kw, cpu_u, gpu_u = _throttled_it_kw(state, cfg, ctx)
            flow = ctx["flow"]._replace(it_kw=it_kw, grid_import_kw=it_kw)
            return state, dict(ctx, flow=flow, raw_it_kw=raw,
                               host_power_kw=p, host_cpu_util=cpu_u,
                               host_gpu_util=gpu_u)
        cpu_u, gpu_u = scheduler_mod.host_utilization(state.tasks, hosts)
        n_gpus, on = _host_inputs(hosts, cpu_u)
        if cfg.cooling.enabled:
            sp = _row_param(cache, "setpoint", ctx.get(
                "cooling_setpoint", cfg.cooling.setpoint_c), cpu_u)
            p, it_kw, cool_kw, water = ops.facility_power(
                cpu_u, gpu_u, n_gpus, on, ctx["wet_bulb_c"].reshape(-1), sp,
                cfg.cpu_power, cfg.gpu_power, cfg.cooling)
            ctx = dict(ctx, fused_cooling_kw=cool_kw[:, None],
                       fused_water_l_per_h=water[:, None])
        else:
            p, it_kw = ops.host_power(cpu_u, gpu_u, n_gpus, on,
                                      cfg.cpu_power, cfg.gpu_power)
        it_kw = it_kw[:, None]
        flow = ctx["flow"]._replace(it_kw=it_kw, grid_import_kw=it_kw)
        return state, dict(ctx, flow=flow, host_power_kw=p,
                           host_cpu_util=cpu_u, host_gpu_util=gpu_u)
    return fn


def stage_cooling(cfg: SimConfig) -> Stage:
    """IT power -> facility power: writes `flow.cooling_kw` and lifts
    `flow.grid_import_kw` to the facility draw.  With heat reuse, that
    share of the chiller-path heat is reclaimed and stops evaporating."""
    reuse = cfg.cooling.heat_reuse_fraction
    resil = cfg.resilience.enabled

    def fn(state: SimState, ctx: dict):
        flow = ctx["flow"]
        it_kw = flow.it_kw
        # None (not ones) when resilience is off: the derated expressions
        # round differently from the healthy ones
        derate = ctx["chiller_derate"] if resil else None
        if "fused_cooling_kw" in ctx:   # computed by stage_power
            cooling_kw = ctx["fused_cooling_kw"]
            water_l_per_h = ctx["fused_water_l_per_h"]
        else:
            cooling_kw, water_l_per_h = thermal_mod.cooling_step(
                it_kw, ctx["wet_bulb_c"], cfg.cooling,
                setpoint_c=ctx.get("cooling_setpoint"),
                chiller_derate=derate)
        m = state.metrics
        if reuse > 0.0:
            heat_kw = thermal_mod.reclaimable_heat_kw(
                it_kw, cooling_kw, ctx["wet_bulb_c"], cfg.cooling,
                setpoint_c=ctx.get("cooling_setpoint"),
                chiller_derate=derate)
            water_l_per_h = water_l_per_h * (1.0 - reuse)
            m = m._replace(heat_reuse=m.heat_reuse
                           + reuse * heat_kw * cfg.dt_h)
        metrics = m._replace(
            cooling_energy=m.cooling_energy + cooling_kw * cfg.dt_h,
            water_l=m.water_l + water_l_per_h * cfg.dt_h)
        flow = flow._replace(cooling_kw=cooling_kw,
                             grid_import_kw=it_kw + cooling_kw)
        return state._replace(metrics=metrics), dict(ctx, flow=flow)
    return fn


def stage_renewables(cfg: SimConfig) -> Stage:
    """On-site PV supply: writes `flow.pv_kw`."""
    def fn(state: SimState, ctx: dict):
        cap = ctx.get("pv_capacity_kw")
        cap = np.float32(cfg.renewables.pv_capacity_kw) if cap is None \
            else f32(cap)
        pv_kw = renewables_mod.pv_power_kw(cap, ctx["pv_cf"])
        return state, dict(ctx, flow=ctx["flow"]._replace(pv_kw=pv_kw))
    return fn


def stage_net_meter(cfg: SimConfig) -> Stage:
    """Settle the ledger when renewables run without a battery."""
    def fn(state: SimState, ctx: dict):
        flow = ctx["flow"]
        load = flow.it_kw + flow.cooling_kw
        net_load, surplus = renewables_mod.net_load_split(load, flow.pv_kw)
        _, export_kw, curtailed_kw = renewables_mod.split_surplus(
            surplus, torch.zeros_like(surplus), cfg.renewables)
        flow = flow._replace(grid_import_kw=net_load,
                             grid_export_kw=export_kw,
                             curtailed_kw=curtailed_kw)
        return state, dict(ctx, flow=flow)
    return fn


def stage_battery(cfg: SimConfig) -> Stage:
    """Storage dispatch in ledger terms: charge/discharge and the settled
    grid import (surplus PV charges the battery before export)."""
    renew = cfg.renewables.enabled

    def fn(state: SimState, ctx: dict):
        flow = ctx["flow"]
        load = flow.it_kw + flow.cooling_kw
        if renew:
            net_load, surplus = renewables_mod.net_load_split(load, flow.pv_kw)
        else:
            net_load, surplus = load, None
        batt, charge_kw, discharge_kw = battery_mod.battery_flow_step(
            state.battery, net_load, ctx["ci"], ctx["batt_threshold"],
            ctx["ci_rising"], cfg.dt_h, cfg.battery,
            capacity_kwh=ctx.get("batt_capacity_kwh"),
            rate_kw=ctx.get("batt_rate_kw"),
            price=ctx.get("price"), price_lo=ctx.get("price_lo"),
            price_hi=ctx.get("price_hi"),
            dispatch_lambda=ctx.get("dispatch_lambda"),
            pv_surplus_kw=surplus)
        if renew:
            pv_to_batt, export_kw, curtailed_kw = renewables_mod.split_surplus(
                surplus, charge_kw, cfg.renewables)
            flow = flow._replace(
                batt_charge_kw=charge_kw, batt_discharge_kw=discharge_kw,
                grid_import_kw=net_load + (charge_kw - pv_to_batt)
                - discharge_kw,
                grid_export_kw=export_kw, curtailed_kw=curtailed_kw)
        else:
            flow = flow._replace(
                batt_charge_kw=charge_kw, batt_discharge_kw=discharge_kw,
                grid_import_kw=load + charge_kw - discharge_kw)
        metrics = state.metrics._replace(
            batt_discharged=state.metrics.batt_discharged
            + discharge_kw * cfg.dt_h)
        return (state._replace(battery=batt, metrics=metrics),
                dict(ctx, flow=flow))
    return fn


def stage_pricing(cfg: SimConfig) -> Stage:
    """Grid flows -> money: energy charge + billing-window demand charge on
    `flow.grid_import_kw`, minus the export-tariff revenue."""
    wsteps = pricing_mod.billing_window_steps(cfg.pricing, cfg.dt_h)
    renew = cfg.renewables.enabled

    def fn(state: SimState, ctx: dict):
        flow = ctx["flow"]
        m = state.metrics
        ec, dc, wp = pricing_mod.pricing_step(
            m.energy_cost, m.demand_cost, m.window_peak_kw,
            flow.grid_import_kw, ctx["price"], state.step, cfg.dt_h, wsteps,
            cfg.pricing.demand_charge_per_kw)
        metrics = m._replace(energy_cost=ec, demand_cost=dc,
                             window_peak_kw=wp)
        if renew:
            metrics = metrics._replace(
                export_revenue=pricing_mod.export_revenue_step(
                    m.export_revenue, flow.grid_export_kw, ctx["price"],
                    cfg.dt_h, cfg.pricing))
        return state._replace(metrics=metrics), ctx
    return fn


def _battery_embodied_rate(cfg: SimConfig, dyn_capacity):
    """Battery embodied kg/h: from the dyn capacity when one is swept."""
    if dyn_capacity is not None and cfg.battery.enabled:
        return (f32(dyn_capacity) * cfg.battery.embodied_kg_per_kwh
                / (cfg.battery.lifetime_years * HOURS_PER_YEAR))
    return battery_mod.battery_embodied_rate_kg_per_h(cfg.battery)


def stage_carbon(cfg: SimConfig) -> Stage:
    """Carbon + energy accounting off the settled ledger; operational
    carbon, grid energy and the peak all meter `flow.grid_import_kw`."""
    renew = cfg.renewables.enabled

    def fn(state: SimState, ctx: dict):
        flow = ctx["flow"]
        grid_kw = flow.grid_import_kw
        n_active = state.hosts.active.to(F32).sum(-1, keepdim=True)
        batt_rate = _battery_embodied_rate(cfg, ctx.get("batt_capacity_kwh"))
        op, emb = carbon_mod.carbon_delta(grid_kw, ctx["ci"], cfg.dt_h,
                                          n_active, cfg.embodied, batt_rate)
        m = state.metrics
        metrics = m._replace(
            op_carbon=m.op_carbon + op,
            emb_carbon=m.emb_carbon + emb,
            grid_energy=m.grid_energy + grid_kw * cfg.dt_h,
            dc_energy=m.dc_energy + (flow.it_kw + flow.cooling_kw) * cfg.dt_h,
            it_energy=m.it_energy + flow.it_kw * cfg.dt_h,
            peak_power=torch.maximum(m.peak_power, grid_kw))
        if renew:
            metrics = metrics._replace(
                pv_energy=metrics.pv_energy + flow.pv_kw * cfg.dt_h,
                export_energy=(metrics.export_energy
                               + flow.grid_export_kw * cfg.dt_h),
                curtailed_energy=(metrics.curtailed_energy
                                  + flow.curtailed_kw * cfg.dt_h))
        return state._replace(metrics=metrics), ctx
    return fn


def _resilience_update(state: SimState, cfg: SimConfig, it_kw, raw_it_kw,
                       ctx: dict) -> SimState:
    """The resilience metrics of the step (hours throttled, hours with
    facility equipment derated) and the throttle of the next step, from
    this step's clamped and raw IT draw."""
    dt = np.float32(cfg.dt_h)
    derate, cap = ctx["chiller_derate"], ctx["pdu_cap_kw"]
    m = state.metrics
    m = m._replace(
        throttled_h=m.throttled_h + dt * (state.throttle < 1.0).to(F32),
        derate_h=m.derate_h
        + dt * ((derate < 1.0) | torch.isfinite(cap)).to(F32))
    throttle = resilience_mod.next_throttle(
        it_kw, raw_it_kw, ctx["wet_bulb_c"], derate, cap, cfg.resilience,
        threshold_c=ctx.get("throttle_inlet_c"))
    return state._replace(metrics=m, throttle=throttle)


def stage_resilience(cfg: SimConfig) -> Stage:
    """Close the thermal loop from the step's settled ledger: account the
    resilience metrics and compute the throttle the NEXT step runs under
    (a one-step delay).  Runs last, so it sees the clamped `flow.it_kw`."""
    def fn(state: SimState, ctx: dict):
        # the throttle this step RAN under, for the probe bus
        ctx = dict(ctx, throttle_factor=state.throttle)
        state = _resilience_update(state, cfg, ctx["flow"].it_kw,
                                   ctx["raw_it_kw"], ctx)
        return state, ctx
    return fn


def _failure_stages(cfg: SimConfig) -> list[Stage]:
    """Checkpoint BEFORE failures: a boundary snapshot at time t holds all
    work done by t, so a failure in the same step rolls back no further."""
    stages: list[Stage] = []
    if cfg.failures.enabled:
        if cfg.failures.checkpointing:
            stages.append(stage_checkpoint(cfg))
        stages.append(stage_failures(cfg))
    return stages


def default_pipeline(cfg: SimConfig) -> list[Stage]:
    """Technique composition: each enabled technique contributes its stage."""
    stages: list[Stage] = _failure_stages(cfg)
    if cfg.shifting.enabled and cfg.shifting.stop_running:
        stages.append(stage_task_stopper(cfg))
    stages += [stage_scheduler(cfg), stage_progress(cfg), stage_power(cfg)]
    if cfg.cooling.enabled:
        stages.append(stage_cooling(cfg))
    if cfg.renewables.enabled:
        stages.append(stage_renewables(cfg))
    if cfg.battery.enabled:
        stages.append(stage_battery(cfg))
    elif cfg.renewables.enabled:
        stages.append(stage_net_meter(cfg))
    if cfg.pricing.enabled:
        stages.append(stage_pricing(cfg))
    stages.append(stage_carbon(cfg))
    if cfg.resilience.enabled:
        stages.append(stage_resilience(cfg))
    return stages


def _queue_depth(state: SimState):
    """Arrived-but-pending tasks at the state's time, f32 [B, 1]."""
    return ((state.tasks.status == PENDING)
            & (state.tasks.arrival <= state.t)).to(F32).sum(-1, keepdim=True)


def stage_probes(cfg: SimConfig) -> Stage:
    """The probe-bus sampler (cfg.probes): runs after every other stage, so
    it sees the settled ledger, the post-dispatch SoC and the post-pricing
    window peak, at the step's pre-increment time.  The step index comes
    from the loop (`ctx["step_index"]`), so steps the stride skips launch
    nothing; a sampled one writes one stacked sample into the ring."""
    stride = max(int(cfg.probes.stride), 1)
    ones: dict = {}

    def fn(state: SimState, ctx: dict):
        i = ctx["step_index"]
        if i % stride:
            return state, ctx
        throttle = ctx.get("throttle_factor")
        if throttle is None:  # the loop is open: no throttle
            dev = state.t.device
            if dev not in ones:
                ones[dev] = torch.ones((), dtype=F32, device=dev)
            throttle = ones[dev]
        sample = {**ctx["flow"]._asdict(),
                  "soc_kwh": state.battery.charge,
                  "window_peak_kw": state.metrics.window_peak_kw,
                  "queue_depth": _queue_depth(state),
                  "throttle_factor": throttle,
                  "chiller_derate": ctx["chiller_derate"],
                  "pdu_cap_kw": ctx["pdu_cap_kw"]}
        return state._replace(probes=telemetry.probe_write(
            state.probes, i, stride, sample)), ctx
    return fn


def _stage_label(stage: Stage) -> str:
    """'stage_power.<locals>.fn' -> 'stage_power' for scope names."""
    q = getattr(stage, "__qualname__", "")
    return q.split(".<locals>")[0] or getattr(stage, "__name__", "stage")


def _scoped(stages: list[Stage]) -> list[Stage]:
    """The stages, each in a `telemetry.stage_scope` of its name while a
    session is active (decided once, when the loop's step is built); as
    they are otherwise."""
    if not telemetry.enabled():
        return stages

    def scoped(stage: Stage) -> Stage:
        label = _stage_label(stage)

        def fn(state: SimState, ctx: dict):
            with telemetry.stage_scope(label, state.t.device):
                return stage(state, ctx)
        return fn
    return [scoped(stage) for stage in stages]


# --------------------------------------------------------------------------
# executors
# --------------------------------------------------------------------------

def _advance_clock(state: SimState, cfg: SimConfig) -> SimState:
    """End-of-step clock tick: t = (step + 1) * f32(dt_h), one f32 product,
    never an accumulated sum (which drifts over long horizons)."""
    step1 = state.step + 1
    return state._replace(t=step1.to(F32) * np.float32(cfg.dt_h), step=step1)


def _n_running(state: SimState):
    return (state.tasks.status == RUNNING).to(torch.int32).sum(
        -1, keepdim=True)


def _max_overcommit(tasks: TaskTable, hosts: HostTable):
    free_c, free_g = scheduler_mod.free_capacity(tasks, hosts)
    return torch.maximum((-free_c).amax(-1, keepdim=True),
                         (-free_g).amax(-1, keepdim=True))


def _rows(inputs: StepInputs, b: int) -> StepInputs:
    """Every series as [B, S] (a view where it is shared by the rows)."""
    s = inputs.ci.shape[-1]
    return inputs._replace(**{f: getattr(inputs, f).reshape(-1, s).expand(
        b, s) for f in SERIES})


def _per_step(inputs: StepInputs, b: int):
    """Per-step inputs: [B, 1] columns of the series, each contiguous (one
    copy per run, not an index per stage and step), and the step's failure
    draws [B, H] and next key [B, 2] (views)."""
    rows = _rows(inputs, b)
    cols = [getattr(rows, f).t().contiguous()[..., None].unbind(0)
            for f in SERIES]
    s = inputs.ci.shape[-1]
    fail = keys = [None] * s
    if inputs.host_fail is not None:
        fail = inputs.host_fail.expand(s, b, -1).unbind(0)
        keys = inputs.rng_keys[1:].expand(s, b, 2).unbind(0)
    return [StepInputs(*step, host_fail=f, rng_keys=k)
            for *step, f, k in zip(*cols, fail, keys)]


def _stack_series(ys: list[dict]) -> dict:
    """The steps' [B, 1] series values as [B, S]."""
    out = {}
    for k, v in ys[0].items():
        if isinstance(v, EnergyFlow):
            out[k] = EnergyFlow(*(torch.cat([y[k][i] for y in ys], -1)
                                  for i in range(len(EnergyFlow._fields))))
        else:
            out[k] = torch.cat([y[k] for y in ys], -1)
    return out


def build_step_fn(cfg: SimConfig, stages: Sequence[Stage] | None = None,
                  dyn: dict | None = None):
    stages = default_pipeline(cfg) if stages is None else list(stages)
    if cfg.probes.enabled:
        stages.append(stage_probes(cfg))
    stages = _scoped(stages)
    dyn = dyn or {}

    def step(state: SimState, inputs: StepInputs, flow0: EnergyFlow,
             index: int | None = None):
        ctx = {"ci": inputs.ci, "batt_threshold": inputs.batt_threshold,
               "ci_rising": inputs.ci_rising,
               "shift_threshold": inputs.shift_threshold,
               "wet_bulb_c": inputs.wet_bulb_c, "price": inputs.price,
               "price_lo": inputs.price_lo, "price_hi": inputs.price_hi,
               "pv_cf": inputs.pv_cf,
               "chiller_derate": inputs.chiller_derate,
               "pdu_cap_kw": inputs.pdu_cap_kw,
               "host_fail": inputs.host_fail, "rng_next": inputs.rng_keys,
               "flow": flow0, **dyn}
        if index is not None:
            ctx["step_index"] = index
        for stage in stages:
            state, ctx = stage(state, ctx)
        state = _advance_clock(state, cfg)
        if not cfg.collect_series:
            return state, None
        flow: EnergyFlow = ctx["flow"]
        ys = {"grid_power_kw": flow.grid_import_kw,
              "dc_power_kw": flow.it_kw + flow.cooling_kw,
              "ci": ctx["ci"], "n_running": _n_running(state),
              "battery_charge": state.battery.charge,
              "max_overcommit": ctx.get("max_overcommit",
                                        torch.zeros_like(flow.it_kw)),
              "flow": flow}
        if cfg.cooling.enabled:
            ys["cooling_power_kw"] = flow.cooling_kw
            ys["wet_bulb_c"] = ctx["wet_bulb_c"]
        if cfg.pricing.enabled:
            ys["price_per_kwh"] = ctx["price"]
        return state, ys

    return step


def _simulate_stage_pipeline(state0: SimState, inputs: StepInputs,
                             cfg: SimConfig, stages, dyn: dict):
    step = build_step_fn(cfg, stages, dyn)
    b = state0.tasks.status.shape[0]
    flow0 = init_energy_flow(inputs.ci.device, (b, 1))
    state, ys = state0, []
    for i, x in enumerate(_per_step(inputs, b)):
        state, y = step(state, x, flow0, i)
        ys.append(y)
    return state, (_stack_series(ys) if cfg.collect_series else None)


def _build_demand_step(cfg: SimConfig, dyn: dict):
    """Loop step of the megakernel's demand phase: the recurrent stages
    (checkpoint -> failures -> stopper -> scheduler -> progress) plus the
    IT power of the step; with resilience on, the stage pipeline's throttle
    recurrence too (the throttled power, the PDU clamp, the metrics and the
    next throttle, in the same order), so the emitted IT series is the
    clamped draw."""
    stages: list[Stage] = _failure_stages(cfg)
    if cfg.shifting.enabled and cfg.shifting.stop_running:
        stages.append(stage_task_stopper(cfg))
    stages = _scoped(stages + [stage_scheduler(cfg), stage_progress(cfg)])
    resil = cfg.resilience.enabled

    def step(state: SimState, xs: dict, sample: bool = False):
        """One demand step; a `sample`d step (one the probe bus keeps) also
        yields the queue depth and the throttle the step ran under."""
        ctx = {**xs, **dyn}
        for stage in stages:
            state, ctx = stage(state, ctx)
        hosts = state.hosts
        ys = {}
        if sample:
            ys["queue_depth"] = _queue_depth(state)
            if resil:
                ys["throttle_factor"] = state.throttle
        if resil:
            _, raw, it_kw, _, _ = _throttled_it_kw(state, cfg, ctx)
            state = _resilience_update(state, cfg, it_kw, raw, ctx)
            it_kw = it_kw[:, 0]
        else:
            cpu_u, gpu_u = scheduler_mod.host_utilization(state.tasks, hosts)
            _, it_kw = ops.host_power(cpu_u, gpu_u,
                                      *_host_inputs(hosts, cpu_u),
                                      cfg.cpu_power, cfg.gpu_power)
        state = _advance_clock(state, cfg)
        ys["it_kw"] = it_kw
        if cfg.collect_series:
            ys["max_overcommit"] = _max_overcommit(state.tasks, hosts)
            ys["n_running"] = _n_running(state)
        return state, ys

    return step


def facility_totals_from_flows(flows: dict, ci, price,
                               cfg: SimConfig) -> dict:
    """Reduce the [..., S] flow series of `ref.fused_facility_chain` to the
    run totals the metrics need, one per row ([S] series give 0-d totals,
    [B, S] give [B]); the fused facility kernel produces this same dict
    from its accumulator rows.  Each series is made contiguous along its
    steps first: a sum along a strided dimension takes another order for
    some row counts on the CPU, and a row's totals must not depend on how
    many rows run beside it (a grid's chunks and blocks, as the
    reference pins its chunked grid to the unchunked one bit for bit)."""
    dt = np.float32(cfg.dt_h)
    flows = {k: v.contiguous() for k, v in flows.items()}
    grid = flows["grid_import_kw"]
    load = flows["it_kw"] + flows["cooling_kw"]

    def total(x):
        return x.sum(-1) * dt

    totals = {
        "op_carbon": (grid * ci).sum(-1) * dt * inv_f32(1000.0),
        "grid_energy": total(grid),
        "dc_energy": total(load),
        "it_energy": total(flows["it_kw"]),
        "peak_power": grid.amax(-1),
        "batt_discharged": total(flows["batt_discharge_kw"]),
        "cooling_energy": total(flows["cooling_kw"]),
        "water_l": total(flows["water_l_per_h"]),
        "heat_reuse": total(flows["heat_reuse_kw"]),
        "pv_energy": total(flows["pv_kw"]),
        "export_energy": total(flows["grid_export_kw"]),
        "curtailed_energy": total(flows["curtailed_kw"]),
        "soc_final": flows["soc"][..., -1],
        "was_charging": flows["want_charge"][..., -1],
    }
    if cfg.pricing.enabled:
        wsteps = pricing_mod.billing_window_steps(cfg.pricing, cfg.dt_h)
        lead, s = grid.shape[:-1], grid.shape[-1]
        n_win = -(-s // wsteps)
        padded = torch.cat([grid, grid.new_zeros(*lead, n_win * wsteps - s)],
                           -1)
        # windows [0,w), [w,2w), ...: closed windows bill here, the last
        # (open) one is settled by `summarize`
        peaks = padded.reshape(*lead, n_win, wsteps).amax(-1)
        totals["energy_cost"] = total(grid * price)
        totals["demand_cost"] = (peaks[..., :-1].sum(-1)
                                 * np.float32(cfg.pricing.demand_charge_per_kw))
        totals["window_peak_kw"] = peaks[..., -1]
        if cfg.renewables.enabled:
            totals["export_revenue"] = (
                total(flows["grid_export_kw"] * price)
                * np.float32(cfg.pricing.export_price_fraction))
    return totals


def _merge_facility_totals(state: SimState, totals: dict, cfg: SimConfig,
                           dyn: dict) -> SimState:
    """Fold the facility totals ([B], one a row) and the closed-form
    embodied integral into the demand phase's final state."""
    tot = {k: v[:, None] for k, v in totals.items()}
    m = state.metrics
    # embodied carbon is load-independent and `hosts.active` is fixed for
    # the run: the per-step accumulation is a closed-form product
    n_active = state.hosts.active.to(F32).sum(-1, keepdim=True)
    batt_rate = _battery_embodied_rate(cfg, dyn.get("batt_capacity_kwh"))
    host_rate = carbon_mod.host_embodied_rate_kg_per_h(cfg.embodied)
    emb = (n_active * host_rate + batt_rate) * cfg.dt_h * cfg.n_steps
    m = m._replace(
        op_carbon=m.op_carbon + tot["op_carbon"],
        emb_carbon=m.emb_carbon + emb,
        grid_energy=m.grid_energy + tot["grid_energy"],
        dc_energy=m.dc_energy + tot["dc_energy"],
        it_energy=m.it_energy + tot["it_energy"],
        peak_power=torch.maximum(m.peak_power, tot["peak_power"]),
        batt_discharged=m.batt_discharged + tot["batt_discharged"])
    if cfg.cooling.enabled:
        m = m._replace(
            cooling_energy=m.cooling_energy + tot["cooling_energy"],
            water_l=m.water_l + tot["water_l"],
            heat_reuse=m.heat_reuse + tot["heat_reuse"])
    if cfg.renewables.enabled:
        m = m._replace(
            pv_energy=m.pv_energy + tot["pv_energy"],
            export_energy=m.export_energy + tot["export_energy"],
            curtailed_energy=m.curtailed_energy + tot["curtailed_energy"])
    if cfg.pricing.enabled:
        m = m._replace(
            energy_cost=m.energy_cost + tot["energy_cost"],
            demand_cost=m.demand_cost + tot["demand_cost"],
            window_peak_kw=torch.maximum(m.window_peak_kw,
                                         tot["window_peak_kw"]))
        if cfg.renewables.enabled:
            m = m._replace(export_revenue=m.export_revenue
                           + tot["export_revenue"])
    battery = BatteryState(charge=tot["soc_final"],
                           was_charging=tot["was_charging"])
    return state._replace(metrics=m, battery=battery)


def _simulate_megakernel(state0: SimState, inputs: StepInputs,
                         cfg: SimConfig, dyn: dict):
    step = _build_demand_step(cfg, dyn)
    dev = inputs.ci.device
    b = state0.tasks.status.shape[0]
    inputs = _rows(inputs, b)
    failures, resil = cfg.failures.enabled, cfg.resilience.enabled
    if cfg.shifting.enabled or failures or resil:
        xs = [{"ci": x.ci, "shift_threshold": x.shift_threshold,
               "host_fail": x.host_fail, "rng_next": x.rng_keys,
               "wet_bulb_c": x.wet_bulb_c, "chiller_derate": x.chiller_derate,
               "pdu_cap_kw": x.pdu_cap_kw, "step_index": i}
              for i, x in enumerate(_per_step(inputs, b))]
    else:
        # the gate never reads the carbon intensity or threshold
        zero = torch.zeros((), dtype=F32, device=dev)
        xs = ({"ci": zero, "shift_threshold": zero}
              for _ in range(cfg.n_steps))
    # written one step (one row) at a time: fresh buffers nobody else holds
    it_steps = torch.empty(cfg.n_steps, b, dtype=F32, device=dev)
    probes = cfg.probes.enabled
    if probes:  # the demand half's probe channels, at the kept samples
        kept = set(telemetry.sample_steps(cfg.n_steps, cfg.probes))
        qd_steps = torch.zeros(cfg.n_steps, b, dtype=F32, device=dev)
        thr_steps = torch.ones(cfg.n_steps, b, dtype=F32, device=dev)
    state, demand_ys = state0, []
    with telemetry.stage_scope("megakernel.demand", dev):
        for i, x in enumerate(xs):
            sample = probes and i in kept
            state, y = step(state, x, sample)
            it_steps[i] = y.pop("it_kw")
            if sample:
                qd_steps[i] = y.pop("queue_depth")[:, 0]
                if resil:
                    thr_steps[i] = y.pop("throttle_factor")[:, 0]
            demand_ys.append(y)
    final = state
    it_series = it_steps.t()

    chain_kwargs = dict(
        soc0=0.0, setpoint_c=dyn.get("cooling_setpoint"),
        batt_capacity_kwh=dyn.get("batt_capacity_kwh"),
        batt_rate_kw=dyn.get("batt_rate_kw"),
        dispatch_lambda=dyn.get("dispatch_lambda"),
        pv_capacity_kw=dyn.get("pv_capacity_kw"))
    if resil:  # kernel 3's derate route (its plain chain on the CPU)
        chain_kwargs["chiller_derate"] = inputs.chiller_derate
    trace_args = (inputs.ci, inputs.wet_bulb_c, inputs.price, inputs.price_lo,
                  inputs.price_hi, inputs.pv_cf, inputs.batt_threshold,
                  inputs.ci_rising)
    with telemetry.stage_scope("megakernel.facility", dev):
        if not (cfg.collect_series or probes):
            totals = ops.fused_facility_totals(it_series, *trace_args, cfg,
                                               trace_store=cfg.trace_store,
                                               **chain_kwargs)
            return _merge_facility_totals(final, totals, cfg, dyn), None
        # kernel 3's series route: the per-step flows beside the totals
        flows, totals = ops.fused_facility_chain(
            it_series, *trace_args, cfg, trace_store=cfg.trace_store,
            **chain_kwargs)
    final = _merge_facility_totals(final, totals, cfg, dyn)
    if probes:
        final = final._replace(probes=_megakernel_probes(
            flows, qd_steps.t(), thr_steps.t(), inputs.pdu_cap_kw, cfg))
    if not cfg.collect_series:
        return final, None
    demand = _stack_series(demand_ys)
    flow = EnergyFlow(*(flows[f] for f in EnergyFlow._fields))
    ys = {"grid_power_kw": flow.grid_import_kw,
          "dc_power_kw": flow.it_kw + flow.cooling_kw,
          "ci": inputs.ci,
          "n_running": demand["n_running"],
          "battery_charge": flows["soc"],
          "max_overcommit": demand["max_overcommit"],
          "flow": flow}
    if cfg.cooling.enabled:
        ys["cooling_power_kw"] = flow.cooling_kw
        ys["wet_bulb_c"] = inputs.wet_bulb_c
    if cfg.pricing.enabled:
        ys["price_per_kwh"] = inputs.price
    return final, ys


def _megakernel_probes(flows: dict, queue_depth, throttle, pdu_cap_kw,
                       cfg: SimConfig) -> telemetry.ProbeRing:
    """The megakernel's probe ring: the facility series (with the running
    window peak, zeros when pricing is off, and the derate series the chain
    applied) and the demand half's [B, S] channels, gathered at the kept
    samples."""
    grid = flows["grid_import_kw"]
    if cfg.pricing.enabled:
        wp = telemetry.window_peak_series(
            grid, pricing_mod.billing_window_steps(cfg.pricing, cfg.dt_h))
    else:
        wp = torch.zeros_like(grid)
    series = {f: flows[f] for f in EnergyFlow._fields}
    series.update(soc_kwh=flows["soc"], window_peak_kw=wp,
                  queue_depth=queue_depth, throttle_factor=throttle,
                  chiller_derate=flows["chiller_derate"],
                  pdu_cap_kw=pdu_cap_kw)
    return telemetry.probes_from_series(cfg.n_steps, cfg.probes, series)


def _check_run(cfg: SimConfig, dyn: dict) -> None:
    """The reference's check that resilience keys do not go unread."""
    if not cfg.resilience.enabled:
        bad = [k for k in _RESILIENCE_KEYS if k in dyn]
        if bad:
            raise ValueError(
                f"dyn key(s) {bad} belong to the resilience loop but "
                "cfg.resilience.enabled is False: they would be silently "
                "ignored — enable the subsystem (core/resilience.py)")


def _to_device(table, device):
    return type(table)(*(col.to(device) for col in table))


def _cell_values(dyn: dict, b: int, device) -> dict:
    """dyn with each per-row value (an array or tensor of B values, one a
    scenario row) as a [B, 1] tensor on `device` (f32 where it is real);
    host numbers and 0-d tensors stay as they are."""
    out = {}
    for k, v in dyn.items():
        if not isinstance(v, torch.Tensor) and np.ndim(v):
            v = torch.as_tensor(np.asarray(v))
        if isinstance(v, torch.Tensor) and v.dim():
            if v.numel() != b:
                raise ValueError(f"dyn '{k}' has {v.numel()} values for "
                                 f"{b} scenario rows")
            v = v.to(device=device, dtype=F32 if v.is_floating_point()
                     else v.dtype).reshape(b, 1)
        out[k] = v
    return out


def prepare_cells(tasks: TaskTable, hosts: HostTable, ci_trace,
                  cfg: SimConfig, n_cells: int, dyn: dict | None = None,
                  device="cuda", presort: bool = True):
    """The set-up of a run of `n_cells` scenario rows on `device` (see
    `run_cells`): (state at t = 0, step inputs, the ctx dyn values, the
    inverse of the priority presort or None).  The tables are the rows'
    common [T] / [H] tables, or [B, T] task tables with a row's own tasks
    in every column (a fleet's regions, core/fleet.py).  `presort=False`
    leaves the rows in arrival order even under priority levels (the
    reference's coupled fleet executor does not permute them)."""
    dyn = dict(dyn) if dyn else {}
    _check_run(cfg, dyn)
    tasks, hosts = _to_device(tasks, device), _to_device(hosts, device)
    arrival = dyn.pop("arrival_trace", None)
    if arrival is not None:
        tasks = state_mod.retime_task_table(tasks, arrival)
    frac = dyn.pop("interactive_frac", None)
    if frac is not None:
        tasks = state_mod.with_interactive_frac(
            tasks, _column(frac, device), cfg.interactive_grace_h,
            seed=cfg.seed)
    # priority scheduling: permute rows into (priority desc, arrival) order
    # once, before the loop (one order for all scenario rows, or one a row
    # where their priorities differ); the final table is un-permuted after
    inv = None
    if presort and _presort_enabled(cfg):
        order = state_mod.priority_schedule_order(
            tasks, cfg.scheduler.priority_levels)
        tasks = state_mod.permute_task_table(tasks, order)
        inv = state_mod.inverse_permutation(order)
    inputs = build_step_inputs(ci_trace, cfg, dyn=dyn, device=device,
                               n_hosts=hosts.cores.shape[-1])
    seed = _host_values(dyn.get("seed", cfg.seed))
    # consumed by the inputs, not ctx keys
    for k in ("wet_bulb_trace", "price_trace", "pv_cf_trace", "seed",
              "failure_hazard_scale", "pdu_cap_kw"):
        dyn.pop(k, None)
    dyn = _cell_values(dyn, n_cells, device)
    if "n_active_hosts" in dyn:
        n = dyn["n_active_hosts"]
        hosts = scaling_mod.with_scale(
            hosts, n.reshape(-1) if isinstance(n, torch.Tensor) else n)
    tasks, hosts = state_mod.cell_tables(tasks, hosts, n_cells)
    state0 = init_sim_state(tasks, hosts, seed)
    if cfg.resilience.enabled:  # a healthy start: no throttle on step 0
        state0 = state0._replace(throttle=torch.ones(
            (n_cells, 1), dtype=F32, device=device))
    if cfg.probes.enabled and cfg.backend == "stage-pipeline":
        # the megakernel gathers its ring from its series after the loop
        state0 = state0._replace(probes=telemetry.init_probes(
            cfg.n_steps, cfg.probes, (n_cells,), device))
    return state0, inputs, dyn, inv


def run_cells(tasks: TaskTable, hosts: HostTable, ci_trace, cfg: SimConfig,
              n_cells: int, stages: Sequence[Stage] | None = None,
              dyn: dict | None = None, device="cuda"):
    """Run `n_cells` scenarios of one workload and configuration through
    one step loop on `device`.  Returns (final SimState, per-step series or
    None) in the layout of core/state.py: [B, T] written task columns,
    [B, 1] battery and accumulators, [B, S] series.

    The tables are the scenarios' common [T] / [H] tables (or [B, T] task
    tables, one row's tasks a row); what differs between rows comes in as
    [B, S] traces (`ci_trace` and the dyn traces) and as dyn values of B
    entries ([B] or [B, 1]; see `simulate` for the keys).  A value given
    once (a host number, a 0-d tensor, an [S] trace) holds for every row.
    Each step launches each kernel of the path once for all rows, and the
    megakernel's facility kernel runs once."""
    if cfg.backend not in BACKENDS:
        raise ValueError(
            f"unknown backend '{cfg.backend}'; pick one of {BACKENDS}")
    if stages is not None and cfg.backend != "stage-pipeline":
        raise ValueError(
            "custom stages compose only with backend='stage-pipeline'; the "
            "megakernel fuses the default facility chain and cannot honour "
            "a replacement pipeline")
    state0, inputs, dyn, inv = prepare_cells(tasks, hosts, ci_trace, cfg,
                                             n_cells, dyn, device)
    if cfg.backend == "megakernel":
        final, ys = _simulate_megakernel(state0, inputs, cfg, dyn)
    else:
        final, ys = _simulate_stage_pipeline(state0, inputs, cfg, stages, dyn)
    if inv is not None:
        final = final._replace(
            tasks=state_mod.permute_task_table(final.tasks, inv))
    return final, ys


def _one_cell(state: SimState) -> SimState:
    """The state of a one-row run in the layout of one scenario: [T] / [H]
    tables, a [2] key, 0-d battery, accumulators and throttle."""
    return state._replace(
        tasks=TaskTable(*(col[0] for col in state.tasks)),
        hosts=HostTable(*(col[0] for col in state.hosts)),
        battery=BatteryState(*(x.reshape(()) for x in state.battery)),
        metrics=MetricsAcc(*(x.reshape(()) for x in state.metrics)),
        rng=state.rng[0],
        throttle=(None if state.throttle is None
                  else state.throttle.reshape(())),
        probes=(None if state.probes is None
                else telemetry.ProbeRing(*(x[0] for x in state.probes))))


def simulate(tasks: TaskTable, hosts: HostTable, ci_trace, cfg: SimConfig,
             stages: Sequence[Stage] | None = None, dyn: dict | None = None,
             weather_trace=None, device="cuda"):
    """Run one simulation on `device`.  Returns (final SimState, per-step
    series or None).

    The tables move to `device` (a no-op where they already are) and the
    traces are made there; the device decides whether the kernels or their
    plain versions run.  `dyn` holds the scenario parameters of the
    reference's dyn dict: `batt_capacity_kwh`, `batt_rate_kw`,
    `shift_quantile_value`, `n_active_hosts`, `cooling_setpoint`,
    `wet_bulb_trace` (also `weather_trace`), `price_trace`,
    `dispatch_lambda`, `pv_cf_trace`, `pv_capacity_kw`, `slots_per_step`,
    `arrival_trace`, `seed` (the failure model's PRNG seed) and
    `interactive_frac` (a share of tasks re-typed as interactive, drawn
    from `cfg.seed`); with `cfg.resilience.enabled` also
    `failure_hazard_scale` (scales the host and facility hazards; 0.0 is a
    healthy datacenter), `throttle_inlet_c` (the thermal trip point) and
    `pdu_cap_kw` (the rack-power clamp while a PDU is derated).  Each
    scalar is a host number or a 0-d tensor on `device`; `seed`,
    `failure_hazard_scale` and `pdu_cap_kw` are read on the host once, before
    the loop.  This is `run_cells` at one scenario row, the row's axis
    squeezed from the state and the series.  With a telemetry session
    active it cuts a "simulate" run record.
    """
    dyn = dict(dyn) if dyn else {}
    if weather_trace is not None:
        dyn["wet_bulb_trace"] = weather_trace
    with telemetry.run_recorder("simulate", cfg, device=device):
        final, ys = run_cells(tasks, hosts, ci_trace, cfg, 1, stages, dyn,
                              device)
    if ys is not None:
        ys = {k: (EnergyFlow(*(f[0] for f in v))
                  if isinstance(v, EnergyFlow) else v[0])
              for k, v in ys.items()}
    return _one_cell(final), ys
