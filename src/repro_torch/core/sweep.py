"""The reference's three named sweep shapes, as thin wrappers over
core/grid.py: regions, battery sizes, and regions x battery sizes (paper
Figs 7, 8 and 12).  Each is one axis declaration run by `sweep_grid`: every
scenario of the sweep goes through one step loop.  The reference's
mesh-sharded sweeps (`sweep_step_fn`, `sharded_sweep`, `lower_sweep`) are
refused with NotImplementedError (ROADMAP Queue 1 item 6f).
"""
from __future__ import annotations

import numpy as np

from .config import SimConfig
from .grid import _ITEM_6F, _refuse, dyn_axis, host_values, sweep_grid, \
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


def sweep_step_fn(*args, **kwargs):
    """The reference's jit-able sweep function for lowering against a mesh:
    refused."""
    _refuse("sweep_step_fn", _ITEM_6F)


def sharded_sweep(*args, **kwargs):
    """The reference's mesh-sharded region sweep: refused."""
    _refuse("sharded_sweep", _ITEM_6F)


def lower_sweep(*args, **kwargs):
    """The reference's lowering of a region sweep: refused."""
    _refuse("lower_sweep", _ITEM_6F)
