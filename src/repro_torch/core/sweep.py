"""The reference's three named sweep shapes, as thin wrappers over
core/grid.py: regions, battery sizes, and regions x battery sizes (paper
Figs 7, 8 and 12).  Each is one axis declaration run by `sweep_grid`: every
scenario of the sweep goes through one step loop.  The mesh-sharded
region sweep (`sharded_sweep`), its step function (`sweep_step_fn`) and its
lowering (`lower_sweep`) go through the grid's mesh executor and `lower`.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import SimConfig
from .grid import ScenarioGrid, dyn_axis, host_values, sweep_grid, \
    trace_axis
from .metrics import SimResult
from .state import HostTable, TaskTable


def sweep_regions(tasks: TaskTable, hosts: HostTable, ci_traces,
                  cfg: SimConfig, jit: bool = True,
                  device="cuda") -> SimResult:
    """Run the same (workload, topology, config) in R carbon regions.

    ci_traces: f32[R, S].  Returns a SimResult with leading axis R."""
    return sweep_grid(tasks, hosts, cfg, [trace_axis(ci_traces)], jit=jit,
                      device=device)


def sweep_battery_sizes(tasks: TaskTable, hosts: HostTable, ci_trace,
                        capacities_kwh, cfg: SimConfig, rates_kw=None,
                        jit: bool = True, device="cuda") -> SimResult:
    """Sweep battery capacity (and optionally absolute charge rate, zipped
    with it) in one region (paper Figs 7, 8)."""
    caps = host_values(capacities_kwh, np.float32)
    if rates_kw is None:
        axis = dyn_axis(batt_capacity_kwh=caps)
    else:
        axis = dyn_axis(batt_capacity_kwh=caps,
                        batt_rate_kw=host_values(rates_kw, np.float32))
    return sweep_grid(tasks, hosts, cfg, [axis], ci_trace=ci_trace, jit=jit,
                      device=device)


def sweep_regions_x_battery(tasks: TaskTable, hosts: HostTable, ci_traces,
                            capacities_kwh, cfg: SimConfig, jit: bool = True,
                            device="cuda") -> SimResult:
    """[R regions x C capacities] grid (paper Fig 12)."""
    caps = host_values(capacities_kwh, np.float32)
    return sweep_grid(tasks, hosts, cfg,
                      [trace_axis(ci_traces), dyn_axis(batt_capacity_kwh=caps)],
                      jit=jit, device=device)


def sweep_step_fn(tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
                  device="cuda"):
    """The region sweep as a function `fn(ci_traces [R, S]) -> SimResult`
    (leading axis R): every region a scenario row of one step loop."""
    def fn(ci_traces):
        return sweep_grid(tasks, hosts, cfg, [trace_axis(ci_traces)],
                          device=device)
    return fn


def sharded_sweep(mesh, tasks: TaskTable, hosts: HostTable, ci_traces,
                  cfg: SimConfig, device="cuda") -> SimResult:
    """Split the region sweep's scenario axis over the mesh's `pod` x
    `data` devices (`ScenarioGrid.run(mesh=)`); every rank returns the
    whole sweep."""
    return sweep_grid(tasks, hosts, cfg, [trace_axis(ci_traces)], mesh=mesh,
                      device=device)


def lower_sweep(mesh, tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
                n_regions: int, n_steps: int):
    """Trace (without running) the region sweep for the dry run's counts:
    `ScenarioGrid.lower` of a trace axis of `n_regions` zero traces of
    `n_steps`."""
    grid = ScenarioGrid([trace_axis(torch.zeros((n_regions, n_steps)))])
    return grid.lower(tasks, hosts, cfg, mesh=mesh)
