"""Multi-datacenter fleet engine: R regional datacenters in one step loop.

`core/spatial.py` places tasks across regional datacenters; this module
runs the placed fleet.  Each region has its own carbon trace, weather
trace, battery sizing, cooling setpoint and host count, and the whole fleet
is ONE run of the unchanged engine: a region is a scenario row of
`engine.run_cells`, its tasks that row's own [W] task table, so every
kernel of the path is one launch a step for all regions (the reference
`jax.vmap`s `simulate` over them).  Per-region heterogeneity rides on the
dyn mechanism: host counts through `n_active_hosts`, battery sizing
through `batt_capacity_kwh` / `batt_rate_kw`, climate through per-region
wet-bulb traces; `core/grid.py`'s `region_axis` and `fleet_axis` make them
grid dimensions.

The contract, as in the reference: a fleet of R = 1 reproduces `simulate`
on the same workload bit for bit, and a fleet grid equals the loop of
`simulate_fleet` calls, one a scenario.

Placement is on the host and exogenous (traces and task list only).  With
`cfg.resilience.spill_interrupted` the regions are coupled: after every
step, up to `max_spills_per_step` interrupted tasks move to the healthiest
region (`resilience.cross_region_spill`), in the stage pipeline only.

A fleet that is not coupled carries per-region probes (`per_region.probes`,
[R, K] fields; `total.probes` is None), as the reference does; the coupled
fleet refuses them.  A telemetry session sees the span `fleet.place`, the
coupled loop's `fleet.spill_scan` scope and one "fleet" run record.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import engine, telemetry
from .config import SimConfig
from .metrics import SimResult, fleet_totals, summarize
from .resilience import cross_region_spill
from .spatial import (host_array, spatial_assign, spatial_assign_online,
                      split_by_region)
from .state import HostTable, TaskTable

# dyn keys that may be per-region vectors (length R) in a fleet
PER_REGION_KEYS = ("n_active_hosts", "batt_capacity_kwh", "batt_rate_kw",
                   "cooling_setpoint", "dispatch_lambda", "pv_capacity_kw",
                   "seed")

POLICIES = ("greedy", "spill", "round_robin")


class FleetResult(NamedTuple):
    """`total` aggregates the fleet (metrics.fleet_totals); `per_region` is a
    SimResult whose fields carry a leading (in grids: trailing) R axis."""
    total: SimResult
    per_region: SimResult


class FleetSpec:
    """R regional datacenters: per-region traces, sizing, and a placement
    policy.  Everything per-region is an optional length-R array; scalars
    broadcast.  Arrays live on the host (numpy): a FleetSpec is scenario
    structure, and the same spec can be re-run under other `dyn` values or
    swept through `core/grid.py`.

    ci_traces:      f32[R, S]  per-region carbon intensity (required)
    wb_traces:      f32[R, S]  per-region wet-bulb weather (needs cooling)
    price_traces:   f32[R, S]  per-region electricity prices (needs pricing)
    pv_traces:      f32[R, S]  per-region solar capacity factors (needs
                               renewables)
    n_active_hosts: i32[R]     per-region host count (default: all hosts)
    batt_capacity_kwh, batt_rate_kw, cooling_setpoint, pv_capacity_kw,
    seeds:          f32/i32[R]
    capacity_frac:  float      aggregate core-hour cap per region, as a
                               multiple of its fair (core-capacity-weighted)
                               share of total work; None = uncapped
    policy:         'greedy' (capped aggregate, core/spatial.py),
                    'spill' (online time-resolved re-routing), or
                    'round_robin' (carbon-blind baseline)
    forecast_h:     placement forecast horizon (hours)
    """

    def __init__(self, ci_traces, wb_traces=None, price_traces=None,
                 pv_traces=None, n_active_hosts=None,
                 batt_capacity_kwh=None, batt_rate_kw=None,
                 cooling_setpoint=None, pv_capacity_kw=None, seeds=None,
                 capacity_frac: float | None = None, policy: str = "greedy",
                 forecast_h: float = 24.0):
        self.ci_traces = host_array(ci_traces).astype(np.float32)
        if self.ci_traces.ndim != 2:
            raise ValueError(
                f"ci_traces must be f32[R, S], got {self.ci_traces.shape}")
        r = self.ci_traces.shape[0]
        if policy not in POLICIES:
            raise ValueError(f"unknown fleet policy '{policy}'; "
                             f"pick one of {POLICIES}")

        def traces(x, name):
            if x is None:
                return None
            a = host_array(x).astype(np.float32)
            if a.shape[0] != r:
                raise ValueError(f"{name} regions {a.shape[0]} != {r}")
            return a

        self.wb_traces = traces(wb_traces, "wb_traces")
        self.price_traces = traces(price_traces, "price_traces")
        self.pv_traces = traces(pv_traces, "pv_traces")

        def per_region(x, dtype):
            if x is None:
                return None
            return np.broadcast_to(host_array(x).astype(dtype), (r,)).copy()

        self.n_active_hosts = per_region(n_active_hosts, np.int32)
        self.batt_capacity_kwh = per_region(batt_capacity_kwh, np.float32)
        self.batt_rate_kw = per_region(batt_rate_kw, np.float32)
        self.cooling_setpoint = per_region(cooling_setpoint, np.float32)
        self.pv_capacity_kw = per_region(pv_capacity_kw, np.float32)
        self.seeds = per_region(seeds, np.int32)
        self.capacity_frac = capacity_frac
        self.policy = policy
        self.forecast_h = float(forecast_h)

    @property
    def n_regions(self) -> int:
        return self.ci_traces.shape[0]

    def replace(self, **kw) -> "FleetSpec":
        args = dict(ci_traces=self.ci_traces, wb_traces=self.wb_traces,
                    price_traces=self.price_traces, pv_traces=self.pv_traces,
                    n_active_hosts=self.n_active_hosts,
                    batt_capacity_kwh=self.batt_capacity_kwh,
                    batt_rate_kw=self.batt_rate_kw,
                    cooling_setpoint=self.cooling_setpoint,
                    pv_capacity_kw=self.pv_capacity_kw, seeds=self.seeds,
                    capacity_frac=self.capacity_frac, policy=self.policy,
                    forecast_h=self.forecast_h)
        args.update(kw)
        return FleetSpec(**args)

    def per_region_dyn(self) -> dict:
        """The spec's per-region dyn values as length-R host arrays."""
        return {key: val for key, val in (
            ("n_active_hosts", self.n_active_hosts),
            ("batt_capacity_kwh", self.batt_capacity_kwh),
            ("batt_rate_kw", self.batt_rate_kw),
            ("cooling_setpoint", self.cooling_setpoint),
            ("pv_capacity_kw", self.pv_capacity_kw),
            ("seed", self.seeds)) if val is not None}

    def region_cores(self, hosts: HostTable) -> np.ndarray:
        """f64[R] concurrent-core capacity per region (first-n active)."""
        cores = host_array(hosts.cores).astype(np.float64)
        csum = np.concatenate([[0.0], np.cumsum(cores)])
        if self.n_active_hosts is None:
            return np.full(self.n_regions, csum[-1])
        n = np.clip(self.n_active_hosts, 0, cores.shape[0])
        return csum[n]

    def capacity_core_h(self, tasks: TaskTable, hosts: HostTable):
        """f64[R] aggregate core-hour caps from `capacity_frac`, split in
        proportion to each region's core capacity; None when uncapped."""
        if self.capacity_frac is None:
            return None
        arrival = host_array(tasks.arrival)
        valid = np.isfinite(arrival)
        work = (host_array(tasks.cores).astype(np.float64)
                * host_array(tasks.duration).astype(np.float64))
        total = float(np.sum(work[valid]))
        share = self.region_cores(hosts)
        share = share / max(share.sum(), 1e-9)
        return self.capacity_frac * total * share


def fleet_place(tasks: TaskTable, hosts: HostTable, fleet: FleetSpec,
                dt_h: float, n_steps: int | None = None) -> np.ndarray:
    """Run the fleet's placement policy.  Returns i32[T] region ids."""
    if fleet.policy == "round_robin":
        valid = np.isfinite(host_array(tasks.arrival))
        region = np.full(valid.shape[0], -1, np.int32)
        region[valid] = (np.arange(int(valid.sum()))
                         % fleet.n_regions).astype(np.int32)
        return region
    if fleet.policy == "spill":
        return spatial_assign_online(tasks, fleet.ci_traces, dt_h,
                                     fleet.region_cores(hosts),
                                     n_steps=n_steps,
                                     forecast_h=fleet.forecast_h)
    return spatial_assign(tasks, fleet.ci_traces, dt_h,
                          capacity_core_h=fleet.capacity_core_h(tasks, hosts),
                          forecast_h=fleet.forecast_h)


def _region_dyn(ci_traces, wb_traces, scalar_dyn, per_region_dyn,
                price_traces, pv_traces) -> dict:
    """One dyn dict for the R rows: the scalar values, the per-region ones
    (which win), and the per-region traces as [R, S] dyn traces."""
    dyn = {**(scalar_dyn or {}), **(per_region_dyn or {})}
    for key, tr in (("wet_bulb_trace", wb_traces),
                    ("price_trace", price_traces),
                    ("pv_cf_trace", pv_traces)):
        if tr is not None:
            dyn[key] = tr
    return dyn


def fleet_cell(tasks_r: TaskTable, hosts: HostTable, cfg: SimConfig,
               ci_traces, wb_traces=None, scalar_dyn: dict | None = None,
               per_region_dyn: dict | None = None,
               price_traces=None, pv_traces=None,
               device="cuda") -> FleetResult:
    """The fleet over pre-placed stacked tables: one `engine.run_cells`
    call with R scenario rows on `device`.

    tasks_r: TaskTable with a leading region axis [R, W] (split_by_region).
    scalar_dyn: values shared by every region; per_region_dyn: length-R
    values, one a region.  ci_traces is [R, S]; wb_traces / price_traces /
    pv_traces are optional [R, S] per-region families.
    """
    r = tasks_r.arrival.shape[0]
    dyn = _region_dyn(ci_traces, wb_traces, scalar_dyn, per_region_dyn,
                      price_traces, pv_traces)
    final, _ = engine.run_cells(tasks_r, hosts, ci_traces, cfg, r, dyn=dyn,
                                device=device)
    per = summarize(final, cfg)
    return FleetResult(total=fleet_totals(per), per_region=per)


def prepare_spill(tasks_r: TaskTable, hosts: HostTable, cfg: SimConfig,
                  ci_traces, wb_traces=None, scalar_dyn: dict | None = None,
                  per_region_dyn: dict | None = None, price_traces=None,
                  pv_traces=None, device="cuda"):
    """(state at t = 0, step inputs, ctx dyn values) of the coupled fleet:
    the set-up of `run_cells` for R rows, the rows left in arrival order
    (the reference's coupled executor does not presort them)."""
    dyn = _region_dyn(ci_traces, wb_traces, scalar_dyn, per_region_dyn,
                      price_traces, pv_traces)
    state0, inputs, dyn, _ = engine.prepare_cells(
        tasks_r, hosts, ci_traces, cfg, tasks_r.arrival.shape[0], dyn,
        device, presort=False)
    return state0, inputs, dyn


def spill_loop(state, inputs, cfg: SimConfig, dyn: dict):
    """The coupled fleet's step loop: the stage pipeline's step for all R
    rows, then `resilience.cross_region_spill` between steps.  Returns the
    final state.  It reads nothing back from the device."""
    step = engine.build_step_fn(cfg, dyn=dyn)
    r = state.tasks.status.shape[0]
    flow0 = engine.init_energy_flow(inputs.ci.device, (r, 1))
    max_spills = int(cfg.resilience.max_spills_per_step)
    with telemetry.stage_scope("fleet.spill_scan", inputs.ci.device):
        for i, x in enumerate(engine._per_step(inputs, r)):
            state, _ = step(state, x, flow0, i)
            tasks, metrics = cross_region_spill(state.tasks, state.hosts,
                                                state.metrics, max_spills)
            state = state._replace(tasks=tasks, metrics=metrics)
    return state


def _fleet_cell_spill(tasks_r: TaskTable, hosts: HostTable, cfg: SimConfig,
                      ci_traces, wb_traces=None,
                      scalar_dyn: dict | None = None,
                      per_region_dyn: dict | None = None,
                      price_traces=None, pv_traces=None,
                      device="cuda") -> FleetResult:
    """`fleet_cell` with the regions coupled step by step: after every
    step, up to `cfg.resilience.max_spills_per_step` interrupted tasks move
    from failing regions to the healthiest one.  With every region healthy
    the spill moves nothing, so with no failures this reproduces
    `fleet_cell` (at the same table width).  Stage pipeline only."""
    state0, inputs, dyn = prepare_spill(
        tasks_r, hosts, cfg, ci_traces, wb_traces, scalar_dyn,
        per_region_dyn, price_traces, pv_traces, device)
    per = summarize(spill_loop(state0, inputs, cfg, dyn), cfg)
    return FleetResult(total=fleet_totals(per), per_region=per)


def split_dyn(fleet: FleetSpec, dyn: dict | None) -> tuple[dict, dict]:
    """(scalar dyn, per-region dyn) of a fleet run: the spec's per-region
    values, then `dyn`'s, whose length-R values of PER_REGION_KEYS are
    per-region and whose other values hold for every region."""
    per_region_dyn = fleet.per_region_dyn()
    scalar_dyn = {}
    for key, val in (dyn or {}).items():
        if key in PER_REGION_KEYS and np.ndim(host_array(val)) >= 1:
            n = np.shape(host_array(val))[0]
            if n != fleet.n_regions:
                raise ValueError(f"per-region dyn '{key}' has length {n}, "
                                 f"fleet has {fleet.n_regions} regions")
            per_region_dyn[key] = host_array(val)
        else:
            scalar_dyn[key] = val
    return scalar_dyn, per_region_dyn


def check_fleet_cfg(fleet: FleetSpec, cfg: SimConfig) -> None:
    """The reference's refusal of per-region traces that would go unread."""
    for name, on, flag, what in (
            ("wb_traces", cfg.cooling.enabled, "cooling",
             "the per-region weather"),
            ("price_traces", cfg.pricing.enabled, "pricing",
             "the per-region prices"),
            ("pv_traces", cfg.renewables.enabled, "renewables",
             "the per-region PV resource")):
        if getattr(fleet, name) is not None and not on:
            raise ValueError(f"the fleet carries {name} but cfg.{flag}."
                             f"enabled is False: {what} would be ignored")


def simulate_fleet(tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
                   fleet: FleetSpec, dyn: dict | None = None,
                   region=None, width: int | None = None,
                   jit: bool = True, device="cuda") -> FleetResult:
    """Run R regional datacenters as one step loop on `device`.

    tasks: ONE task table (as from `make_task_table`); placement happens
    here, at submission time, by `fleet.policy` (pass `region` to override
    it with a precomputed i32[T] assignment).  hosts: the per-region host
    inventory (identical chassis across regions; heterogeneous counts via
    `fleet.n_active_hosts`).  `dyn` adds values on top of the spec: scalars
    apply to every region, length-R arrays of PER_REGION_KEYS one a region.
    `jit` is accepted for the reference's signature and has no effect.

    Returns a FleetResult: `total` (fleet-aggregated SimResult) and
    `per_region` (leading axis R).  With R = 1 this reproduces
    `simulate` + `summarize` bit for bit.  With a telemetry session active
    it cuts a "fleet" run record (placement is outside it, in its own
    `fleet.place` span).
    """
    check_fleet_cfg(fleet, cfg)
    spill = cfg.resilience.enabled and cfg.resilience.spill_interrupted
    if cfg.resilience.spill_interrupted and not cfg.resilience.enabled:
        raise ValueError("cfg.resilience.spill_interrupted requires "
                         "cfg.resilience.enabled (the spill hook reacts to "
                         "failure signals the resilience loops produce)")
    if spill:
        # the coupled executor runs the stage pipeline's step and nothing
        # that changes its signature
        if cfg.backend != "stage-pipeline":
            raise ValueError("spill_interrupted supports only the "
                             f"'stage-pipeline' backend, got {cfg.backend!r}")
        if cfg.probes.enabled or cfg.collect_series:
            raise ValueError("spill_interrupted does not compose with "
                             "probes or collect_series")
        for k in ("arrival_trace", "interactive_frac"):
            if k in (dyn or {}):
                raise ValueError(f"spill_interrupted does not support the "
                                 f"'{k}' dyn key")
        if width is None:
            # full-width tables, so every region has invalid slots to
            # receive spilled tasks whatever the initial placement
            width = tasks.n
    if region is None:
        with telemetry.span("fleet.place", policy=fleet.policy):
            region = fleet_place(tasks, hosts, fleet, cfg.dt_h,
                                 n_steps=cfg.n_steps)
    stacked = split_by_region(tasks, region, fleet.n_regions, width=width,
                              device=device)
    scalar_dyn, per_region_dyn = split_dyn(fleet, dyn)
    fn = _fleet_cell_spill if spill else fleet_cell
    with telemetry.run_recorder("fleet", cfg, device=device,
                                n_regions=int(fleet.n_regions),
                                policy=str(fleet.policy)):
        return fn(stacked, hosts, cfg, torch.from_numpy(fleet.ci_traces),
                  fleet.wb_traces, scalar_dyn, per_region_dyn,
                  fleet.price_traces, fleet.pv_traces, device=device)
