"""Dense simulation state for the PyTorch port of the STEAM engine.

The same struct-of-arrays layout as the reference package: a padded task
table, a host table, and scalar battery/accumulator state, each a NamedTuple
of tensors with the reference's field names and order.  Every stage of the
engine is a plain function over these tuples; a Python loop drives the
timeline.  All times are hours (f32), energy kWh, power kW, carbon kgCO2-eq.

Tables live on the device the caller names.  Entry points default to
`device="cuda"`; the CPU runs only when it is asked for.

Scenario rows.  A run carries B scenarios (the cells of a grid; one for
`simulate`) on a leading axis, all on one clock (`t`, `step` stay 0-d).  The
task columns a run writes (`WRITTEN_TASK_COLUMNS`) are [B, T]; every other
column is the same in every row and stays one shared [1, T] row, and so do
the host columns but `active`, which is [B, H] when the host count differs
between rows.  A row's scalars (battery, accumulators) are [B, 1], so they
broadcast against [B, T] and [B, H] columns.  `cell_tables` lays a table
out so; `init_sim_state` follows the tables it is given.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from . import threefry
from .power import class_utilization

# Task status codes (i32).  PENDING covers never-started, shifted and stopped
# tasks alike: the scheduler only looks at eligibility.
PENDING = 0
RUNNING = 1
DONE = 2
INVALID = 3  # padding rows

# Job-class codes (i32), ordered by default scheduling priority (low to
# high).  Tables built without class columns are all-batch / all-shiftable /
# config-grace.  INTERACTIVE is top priority, non-shiftable, tight SLA grace.
JOB_BATCH = 0
JOB_TRAINING = 1
JOB_INTERACTIVE = 2
N_JOB_CLASSES = 3
JOB_CLASS_NAMES = ("batch", "training", "interactive")

F32 = torch.float32
I32 = torch.int32


def as_tensor(x, dtype, device) -> torch.Tensor:
    """`x` (tensor, numpy array or sequence) as a tensor of `dtype` on
    `device`; float64 inputs round to nearest f32 like `jnp.asarray`."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    # a copy: the source may be a read-only view (e.g. of a JAX array)
    return torch.tensor(np.asarray(x), device=device).to(dtype)


def f32(x):
    """An f32 scalar as the reference holds it: a 0-d tensor stays as it
    is, a host number becomes `np.float32`.  Arithmetic between two such
    host scalars then rounds to f32 at every step, as the reference's f32
    scalar arrays do (a Python float would round once, at the end)."""
    return x if isinstance(x, torch.Tensor) else np.float32(x)


def active_host_mask(n_hosts: int, n_active, device="cuda") -> torch.Tensor:
    """bool[n_hosts] marking the first `n_active` hosts as provisioned; for
    [B] counts (one a scenario row), bool[B, n_hosts]."""
    if isinstance(n_active, torch.Tensor) and n_active.dim():
        n_active = n_active.to(device)[:, None]
    return torch.arange(n_hosts, device=device) < n_active


class TaskTable(NamedTuple):
    """Padded struct-of-arrays task table, pre-sorted by arrival time, so
    FIFO priority is the row order (see core/scheduler.py)."""

    arrival: torch.Tensor        # f32[T] hours; +inf for padding rows
    duration: torch.Tensor       # f32[T] nominal runtime at full speed
    remaining: torch.Tensor      # f32[T] remaining runtime
    ckpt_remaining: torch.Tensor # f32[T] remaining at the last checkpoint
    cores: torch.Tensor          # f32[T] CPU cores required
    gpus: torch.Tensor           # f32[T] GPUs required
    cpu_util: torch.Tensor       # f32[T] utilization of allocated cores
    gpu_util: torch.Tensor       # f32[T] utilization of allocated GPUs
    status: torch.Tensor         # i32[T]
    host: torch.Tensor           # i32[T]; -1 when not placed
    first_start: torch.Tensor    # f32[T]; +inf until first scheduled
    finish: torch.Tensor         # f32[T]; +inf until done
    lost_work: torch.Tensor      # f32[T] hours of work redone after failures
    job_class: torch.Tensor      # i32[T] JOB_* code
    priority: torch.Tensor       # i32[T] scheduling priority, higher first
    shiftable: torch.Tensor      # bool[T] may temporal shifting delay it?
    sla_grace: torch.Tensor      # f32[T] per-task SLA grace; <0 = cfg default

    @property
    def n(self) -> int:
        return self.arrival.shape[-1]


class HostTable(NamedTuple):
    """Host inventory.  `active` is the horizontal-scaling mask (fixed during
    a run); `up` and `repair_at` track host failures (core/failures.py)."""

    cores: torch.Tensor      # f32[H] total CPU cores per host
    n_gpus: torch.Tensor     # f32[H] GPUs per host
    active: torch.Tensor     # bool[H] provisioned by horizontal scaling
    up: torch.Tensor         # bool[H] not currently failed
    repair_at: torch.Tensor  # f32[H] absolute hour when a failed host recovers
    speed: torch.Tensor      # f32[H] execution-speed factor


class BatteryState(NamedTuple):
    charge: torch.Tensor        # f32[] kWh currently stored
    was_charging: torch.Tensor  # bool[] hysteresis memory


class MetricsAcc(NamedTuple):
    op_carbon: torch.Tensor
    emb_carbon: torch.Tensor
    grid_energy: torch.Tensor
    dc_energy: torch.Tensor
    it_energy: torch.Tensor
    cooling_energy: torch.Tensor
    water_l: torch.Tensor
    peak_power: torch.Tensor
    batt_discharged: torch.Tensor
    n_interrupts: torch.Tensor
    n_shift_delays: torch.Tensor
    energy_cost: torch.Tensor
    demand_cost: torch.Tensor
    window_peak_kw: torch.Tensor
    pv_energy: torch.Tensor
    export_energy: torch.Tensor
    curtailed_energy: torch.Tensor
    export_revenue: torch.Tensor
    heat_reuse: torch.Tensor
    n_stops: torch.Tensor
    throttled_h: torch.Tensor
    derate_h: torch.Tensor
    n_spills: torch.Tensor


class SimState(NamedTuple):
    t: torch.Tensor       # f32[] current time in hours
    step: torch.Tensor    # i32[] current step index
    tasks: TaskTable
    hosts: HostTable
    battery: BatteryState
    metrics: MetricsAcc
    # the threefry key of each scenario row (core/threefry.py): int64
    # [B, 2] holding uint32 words, [2] for one-scenario tables; host
    # failures advance it once a step
    rng: torch.Tensor
    probes: Any = None
    # the host speed/utilization cap of the step (core/resilience.py), f32
    # [B, 1]; None when cfg.resilience.enabled is False
    throttle: Any = None


def make_task_table(arrival, duration, cores, gpus=None, cpu_util=None,
                    gpu_util=None, job_class=None, priority=None,
                    shiftable=None, sla_grace=None,
                    device="cuda") -> TaskTable:
    """Build a task table from per-task arrays; sorts by arrival (stable,
    so equal arrivals keep their given order).  Column defaults as in the
    reference: all-batch, priority = class code, shiftable unless
    interactive, `sla_grace` -1 (use cfg.sla_grace_h)."""
    arrival = as_tensor(arrival, F32, device)
    duration = as_tensor(duration, F32, device)
    cores = as_tensor(cores, F32, device)
    t = arrival.shape[0]
    gpus = (torch.zeros(t, dtype=F32, device=device) if gpus is None
            else as_tensor(gpus, F32, device))
    cpu_util = (torch.ones(t, dtype=F32, device=device) if cpu_util is None
                else as_tensor(cpu_util, F32, device))
    gpu_util = ((gpus > 0).to(F32) if gpu_util is None
                else as_tensor(gpu_util, F32, device))
    job_class = (torch.zeros(t, dtype=I32, device=device) if job_class is None
                 else as_tensor(job_class, I32, device))
    priority = job_class if priority is None else as_tensor(priority, I32,
                                                            device)
    shiftable = (job_class != JOB_INTERACTIVE if shiftable is None
                 else as_tensor(shiftable, torch.bool, device))
    sla_grace = (torch.full((t,), -1.0, dtype=F32, device=device)
                 if sla_grace is None else as_tensor(sla_grace, F32, device))
    order = torch.argsort(arrival, stable=True)
    arrival, duration, cores = arrival[order], duration[order], cores[order]
    gpus, cpu_util, gpu_util = gpus[order], cpu_util[order], gpu_util[order]
    job_class, priority = job_class[order], priority[order]
    shiftable, sla_grace = shiftable[order], sla_grace[order]
    inf = torch.full((t,), float("inf"), dtype=F32, device=device)
    status = torch.where(torch.isfinite(arrival), PENDING, INVALID).to(I32)
    return TaskTable(
        arrival=arrival, duration=duration, remaining=duration.clone(),
        ckpt_remaining=duration.clone(), cores=cores, gpus=gpus,
        cpu_util=cpu_util, gpu_util=gpu_util, status=status,
        host=torch.full((t,), -1, dtype=I32, device=device),
        first_start=inf, finish=inf.clone(),
        lost_work=torch.zeros(t, dtype=F32, device=device),
        job_class=job_class, priority=priority, shiftable=shiftable,
        sla_grace=sla_grace)


def with_interactive_frac(tasks: TaskTable, frac, grace_h,
                          seed: int = 0) -> TaskTable:
    """Re-type a `frac` share of tasks as interactive inference (dyn key
    `interactive_frac`): each task draws a fixed uniform from `seed`
    (`uniform(fold_in(prng_key(seed), 7), [T])`), and tasks with u < frac
    become JOB_INTERACTIVE: top priority, not shiftable, `grace_h` SLA
    grace and the interactive power profile.  `frac` is a host number or a
    [B, 1] tensor (one share a scenario row: the class columns become
    [B, T]); raising it only adds interactive tasks."""
    dev = tasks.arrival.device
    key = threefry.fold_in(threefry.prng_key(seed, dev), 7)
    u = threefry.uniform(key, tasks.n)
    frac = frac if isinstance(frac, torch.Tensor) else np.float32(frac)
    inter = (u < frac) & (tasks.status != INVALID)
    cls = torch.where(inter, JOB_INTERACTIVE, tasks.job_class).to(I32)
    cpu_c, gpu_c = class_utilization(cls)
    return tasks._replace(
        job_class=cls,
        priority=torch.where(inter, JOB_INTERACTIVE, tasks.priority).to(I32),
        shiftable=tasks.shiftable & ~inter,
        sla_grace=torch.where(inter, float(np.float32(grace_h)),
                              tasks.sla_grace),
        cpu_util=torch.where(inter, cpu_c, tasks.cpu_util),
        gpu_util=torch.where(inter, torch.where(tasks.gpus > 0, gpu_c, 0.0),
                             tasks.gpu_util))


def retime_task_table(tasks: TaskTable, arrival) -> TaskTable:
    """Replace the arrival column with a pre-sorted one (dyn key
    `arrival_trace`); non-finite arrivals mark the row INVALID."""
    arrival = as_tensor(arrival, F32, tasks.arrival.device)
    status = torch.where(torch.isfinite(arrival), PENDING, INVALID).to(I32)
    return tasks._replace(arrival=arrival, status=status)


def priority_schedule_order(tasks: TaskTable, levels: int) -> torch.Tensor:
    """Stable permutation sorting rows into (priority desc, arrival) order.

    Rows are already arrival-sorted, so the unique composite key
    `(levels-1-priority) * T + row` makes the merged admission order the
    row order; computed once per simulation, outside the step loop."""
    t = tasks.n
    dev = tasks.priority.device
    prio = torch.clamp(tasks.priority.to(torch.int64), 0, levels - 1)
    key = (levels - 1 - prio) * t + torch.arange(t, device=dev)
    return torch.argsort(key).to(I32)


def permute_task_table(tasks: TaskTable, order) -> TaskTable:
    """Reorder every column of the table by `order` along the last axis:
    an i32[T] permutation (each scenario row of [B, T] columns alike), or
    [B, T], one permutation a row (every column then comes out [B, T])."""
    idx = order.to(torch.int64)
    if idx.dim() == 1:
        return TaskTable(*(col[..., idx] for col in tasks))
    return TaskTable(*(torch.gather(col.expand(*idx.shape), -1, idx)
                       for col in tasks))


def inverse_permutation(order) -> torch.Tensor:
    """Inverse of a permutation vector: inv[order[i]] = i."""
    return torch.argsort(order.to(torch.int64)).to(I32)


def stack_task_tables(tables) -> TaskTable:
    """Stack equal-width task tables along a new leading region axis, field
    by field: [R, W] columns (the fleet and spatial splitting batch
    per-region sub-workloads so)."""
    tables = list(tables)
    return type(tables[0])(*(torch.stack([torch.as_tensor(x) for x in xs])
                             for xs in zip(*tables)))


def pad_task_table(tasks: TaskTable, n: int) -> TaskTable:
    """Pad a task table to n rows with INVALID entries."""
    t = tasks.n
    if t == n:
        return tasks
    if t > n:
        raise ValueError(f"cannot shrink task table {t} -> {n}")
    k = n - t

    def _pad(x, fill):
        return torch.cat([x, torch.full((k,), fill, dtype=x.dtype,
                                        device=x.device)])

    inf = float("inf")
    return TaskTable(
        arrival=_pad(tasks.arrival, inf), duration=_pad(tasks.duration, 0),
        remaining=_pad(tasks.remaining, 0),
        ckpt_remaining=_pad(tasks.ckpt_remaining, 0),
        cores=_pad(tasks.cores, 0), gpus=_pad(tasks.gpus, 0),
        cpu_util=_pad(tasks.cpu_util, 0), gpu_util=_pad(tasks.gpu_util, 0),
        status=_pad(tasks.status, INVALID), host=_pad(tasks.host, -1),
        first_start=_pad(tasks.first_start, inf),
        finish=_pad(tasks.finish, inf), lost_work=_pad(tasks.lost_work, 0),
        job_class=_pad(tasks.job_class, JOB_BATCH),
        priority=_pad(tasks.priority, 0),
        shiftable=_pad(tasks.shiftable, True),
        sla_grace=_pad(tasks.sla_grace, -1.0))


def make_host_table(n_hosts: int, cores_per_host: float,
                    gpus_per_host: float = 0.0, n_active: int | None = None,
                    straggler_frac: float = 0.0,
                    straggler_speed: float = 0.5, seed: int = 0,
                    device="cuda") -> HostTable:
    """Homogeneous host inventory; `n_active` < n_hosts powers the rest off.

    `straggler_frac` > 0 marks the hosts whose uniform from `seed` falls
    below it (the reference's threefry draw) as stragglers running at
    `straggler_speed`."""
    n_active = n_hosts if n_active is None else n_active
    speed = torch.ones(n_hosts, dtype=F32, device=device)
    if straggler_frac > 0.0:
        u = threefry.uniform(threefry.prng_key(seed, device), n_hosts)
        speed = torch.where(u < np.float32(straggler_frac),
                            float(np.float32(straggler_speed)), 1.0).to(F32)
    return HostTable(
        cores=torch.full((n_hosts,), float(cores_per_host), dtype=F32,
                         device=device),
        n_gpus=torch.full((n_hosts,), float(gpus_per_host), dtype=F32,
                          device=device),
        active=active_host_mask(n_hosts, n_active, device),
        up=torch.ones(n_hosts, dtype=torch.bool, device=device),
        repair_at=torch.zeros(n_hosts, dtype=F32, device=device),
        speed=speed)


_TABLE_DTYPES = {torch.float32: np.float32, torch.int32: np.int32,
                 torch.bool: np.bool_}


def _table_from(cls, src, dtypes: dict, device):
    d = src._asdict() if hasattr(src, "_asdict") else dict(src)
    return cls(**{f: as_tensor(np.asarray(d[f], _TABLE_DTYPES[dtypes[f]]),
                               dtypes[f], device) for f in cls._fields})


_TASK_DTYPES = dict.fromkeys(TaskTable._fields, F32)
_TASK_DTYPES.update(status=I32, host=I32, job_class=I32, priority=I32,
                    shiftable=torch.bool)
_HOST_DTYPES = dict.fromkeys(HostTable._fields, F32)
_HOST_DTYPES.update(active=torch.bool, up=torch.bool)


def tables_from_numpy(tasks, hosts, device="cuda"):
    """(TaskTable, HostTable) of this port from the reference package's
    tables: any object with `_asdict()` (the reference NamedTuples, after
    `np.asarray` on each leaf) or a dict keyed by its field names.  Values
    and dtypes carry over unchanged, so both packages see the same rows."""
    return (_table_from(TaskTable, tasks, _TASK_DTYPES, device),
            _table_from(HostTable, hosts, _HOST_DTYPES, device))


# the task columns a run writes, one row per scenario; the rest are shared
WRITTEN_TASK_COLUMNS = ("remaining", "status", "host", "first_start", "finish")


def cell_tables(tasks: TaskTable, hosts: HostTable, n_cells: int):
    """The tables of a run of `n_cells` scenario rows: the written task
    columns as [B, T] (views of the one row, until a step writes them), the
    rest as shared [1, T] / [1, H] rows; a column that is already [B, T]
    (per-row class columns) or [B, H] (a per-row host count) stays so."""
    def cell(f, col):
        if col.dim() == 2:
            return col
        return (col[None].expand(n_cells, -1) if f in WRITTEN_TASK_COLUMNS
                else col[None])
    return (TaskTable(*(cell(f, col)
                        for f, col in zip(TaskTable._fields, tasks))),
            HostTable(*(col if col.dim() == 2 else col[None]
                        for col in hosts)))


def init_battery(device="cuda", shape=()) -> BatteryState:
    return BatteryState(charge=torch.zeros(shape, dtype=F32, device=device),
                        was_charging=torch.zeros(shape, dtype=torch.bool,
                                                 device=device))


def init_metrics(device="cuda", shape=()) -> MetricsAcc:
    z = torch.zeros(shape, dtype=F32, device=device)
    # one shared zero: accumulators are only ever replaced, never mutated
    return MetricsAcc(*([z] * len(MetricsAcc._fields)))


def init_sim_state(tasks: TaskTable, hosts: HostTable,
                   seed=0) -> SimState:
    """The state at t = 0.  Battery and accumulators are 0-d for [T]
    tables, and [B, 1] for the [B, T] written columns of `cell_tables`;
    the key is `prng_key(seed)`, [2] or [B, 2] (`seed` one integer or one a
    row)."""
    dev = tasks.arrival.device
    lead = tasks.status.shape[:-1]
    shape = (*lead, 1) if lead else ()
    key = threefry.prng_key(seed, dev)
    if lead:
        key = key.reshape(-1, 2).expand(*lead, 2)
    return SimState(t=torch.zeros((), dtype=F32, device=dev),
                    step=torch.zeros((), dtype=I32, device=dev),
                    tasks=tasks, hosts=hosts,
                    battery=init_battery(dev, shape),
                    metrics=init_metrics(dev, shape), rng=key)
