"""N-dimensional scenario grids: declare axes once, run them all in one loop.

The paper's headline result comes from systematic exploration -- ~5,500
simulations per workload over regions x battery sizes x technique knobs.  A
grid is a list of `Axis` objects; the result has one leading dimension per
axis, in declaration order.  The reference composes nested `jax.vmap`s over
`simulate`; this port has no vmap that passes through its kernels, so the
engine carries the scenario axis itself: the grid's cells flatten in C order
of the axes to B scenario rows, `engine.run_cells` runs all B rows through
ONE step loop (each kernel of the path is one launch a step for all rows,
the facility kernel one a run), and the [B] result fields are reshaped to
the grid's shape.  There is no loop over cells.

Axis kinds:
  * `trace_axis(traces)` -- carbon-region traces f32[R, S]; at most one per
    grid (it becomes the `ci_trace` of the run).
  * `weather_axis(traces)` -- wet-bulb traces f32[W, S] (core/thermal.py);
    requires `cfg.cooling.enabled`.
  * `price_axis(traces)` -- electricity-price traces f32[P, S]
    (core/pricing.py); requires `cfg.pricing.enabled`.
  * `renewable_axis(traces)` -- PV capacity-factor traces f32[V, S]
    (core/renewables.py); requires `cfg.renewables.enabled`.
  * `dyn_axis(**named_values)` -- scenario scalars fed to the engine as dyn
    keys; several names in one call sweep zipped (one dimension), separate
    calls sweep as a product.  The keys are those of `engine.simulate`:
    `batt_capacity_kwh`, `batt_rate_kw`, `shift_quantile_value`,
    `n_active_hosts`, `cooling_setpoint`, `dispatch_lambda`,
    `pv_capacity_kw`, `slots_per_step`, `interactive_frac` (a share of
    tasks re-typed as interactive: the class columns become [B, T]), and
    with `cfg.resilience.enabled` `failure_hazard_scale`,
    `throttle_inlet_c` and `pdu_cap_kw` (core/resilience.py).  Values are
    held on the host (a `shift_quantile_value` level picks its order
    statistics there).
  * `seed_axis(seeds)` -- PRNG seeds of the failure model (host failures,
    the facility failure series): each row walks its own key chain.
  * `tasktrace_axis(arrivals)` -- per-task arrival sets f32[A, T]
    (tasktraces/synthetic.py `make_arrival_sets`): each point re-times the
    task table with one row of arrival hours (dyn key `arrival_trace`), so
    a row's `arrival` and `status` columns are its own [B, T] rows.

Not ported yet, and refused with NotImplementedError naming the ROADMAP
item: `region_axis` and `fleet_axis` (item 4; a fleet grid, and with it a
fleet crossed with a task-trace axis),
and the mesh-sharded and shard_map executors and lowering (`mesh=`,
`executor="shard_map"`, `run_shard_map`, `shard_map_callable`, `lower`;
item 6f).

Every trace axis takes `store='bf16'|'int8'` (core/quant.py): the series are
held quantized and dequantized when a chunk's rows are gathered.

`chunk_size` splits the leading axis: a chunk runs `chunk_size x prod(other
axes)` scenario rows through one step loop.  Omitted, it comes from a
memory budget (`memory_budget_bytes`, default `$STEAM_SWEEP_MEMORY_BUDGET_MB`
or 4 GiB) and an estimate of a scenario row's device bytes in this port's
layout (`ScenarioGrid._per_lead_bytes`).  `reduce=(op, axis)` folds one grid
axis with min, max, argmin or argmax.  `jit=` is accepted for the
reference's signature and has no effect: nothing here is compiled.

Swept knobs modulate a statically enabled technique: the enable flags of
`cfg` choose the pipeline, as in the reference.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import engine
from .config import SimConfig
from .metrics import SimResult, summarize
from .quant import STORES, QuantizedTrace, maybe_dequantize, quantize_trace
from .state import WRITTEN_TASK_COLUMNS, HostTable, TaskTable

TRACE_KEY = "ci_trace"
SEED_KEY = "seed"
WEATHER_KEY = "wet_bulb_trace"
PRICE_KEY = "price_trace"
PV_KEY = "pv_cf_trace"
TASKTRACE_KEY = "arrival_trace"

_REDUCERS = {"min": torch.amin, "max": torch.amax,
             "argmin": torch.argmin, "argmax": torch.argmax}
_TRACE_KINDS = ("trace", "weather", "price", "renewable", "tasktrace")
_VALUE_KINDS = ("dyn", "seed")

# what the port refuses, and the ROADMAP item that brings it
_ITEM_4 = "ROADMAP Queue 1 item 4, fleet and spatial"
_ITEM_6F = ("ROADMAP Queue 1 item 6f, launch/ and distributed/: a multi-GPU "
            "executor for the grid")
_REFUSED = {"region": ("region_axis", _ITEM_4),
            "fleet": ("fleet_axis", _ITEM_4)}


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} is not ported yet ({item})")


class Axis(NamedTuple):
    """One grid dimension: `names[j]` is swept with `values[j]` (zipped).

    A trace axis' value is an f32 [L, S] tensor or a `QuantizedTrace` of
    [L, ...] tensors; a dyn axis' values are host (numpy) arrays of length
    L."""

    kind: str
    names: tuple[str, ...]
    values: tuple

    @property
    def length(self) -> int:
        v = self.values[0]
        return (v.q if isinstance(v, QuantizedTrace) else v).shape[0]


def _trace_rows(traces, what: str) -> torch.Tensor:
    """[L, S] traces as an f32 tensor (float64 rounds to nearest f32)."""
    x = (traces.to(torch.float32) if isinstance(traces, torch.Tensor)
         else torch.tensor(np.asarray(traces, np.float32)))
    if x.dim() != 2:
        raise ValueError(f"{what} wants f32[L, S], got {tuple(x.shape)}")
    return x


def _stored(traces: torch.Tensor, store: str):
    """Apply an axis' `store=` choice: raw f32 or a QuantizedTrace."""
    if store == "f32":
        return traces
    if store not in STORES:
        raise ValueError(f"unknown trace store '{store}'; "
                         f"pick one of {STORES}")
    return quantize_trace(traces, store)


def trace_axis(ci_traces, store: str = "f32") -> Axis:
    """Carbon-region axis: ci_traces f32[R, S] -> one grid dim of length R."""
    return Axis("trace", (TRACE_KEY,),
                (_stored(_trace_rows(ci_traces, "trace_axis"), store),))


def weather_axis(wb_traces, store: str = "f32") -> Axis:
    """Climate axis: wet-bulb traces f32[W, S] -> one grid dim of length W.
    Requires `cfg.cooling.enabled`."""
    return Axis("weather", (WEATHER_KEY,),
                (_stored(_trace_rows(wb_traces, "weather_axis"), store),))


def price_axis(price_traces, store: str = "f32") -> Axis:
    """Tariff axis: electricity-price traces f32[P, S] -> one grid dim of
    length P.  Requires `cfg.pricing.enabled`."""
    return Axis("price", (PRICE_KEY,),
                (_stored(_trace_rows(price_traces, "price_axis"), store),))


def renewable_axis(pv_cf_traces, store: str = "f32") -> Axis:
    """Solar-resource axis: capacity-factor traces f32[V, S] -> one grid
    dim of length V.  Requires `cfg.renewables.enabled`; pair it with
    `dyn_axis(pv_capacity_kw=...)` to sweep plant sizing."""
    return Axis("renewable", (PV_KEY,),
                (_stored(_trace_rows(pv_cf_traces, "renewable_axis"),
                         store),))


def host_values(v, dtype=None) -> np.ndarray:
    """An axis' values on the host, typed as the reference's `jnp.asarray`
    types them (float64 -> f32, int64 -> i32) unless `dtype` is given."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    v = np.asarray(v, dtype)
    if dtype is None and v.dtype == np.float64:
        v = v.astype(np.float32)
    if dtype is None and v.dtype == np.int64:
        v = v.astype(np.int32)
    return v


def dyn_axis(**named_values) -> Axis:
    """Scenario-scalar axis.  Several names sweep zipped along one
    dimension: `dyn_axis(batt_capacity_kwh=caps, batt_rate_kw=rates)` is
    one axis whose i-th point sets both keys; separate calls make a
    product."""
    if not named_values:
        raise ValueError("dyn_axis needs at least one name=values pair")
    names = tuple(named_values)
    values = tuple(host_values(v) for v in named_values.values())
    lengths = {v.shape[0] for v in values}
    if len(lengths) != 1:
        raise ValueError(f"zipped dyn_axis values disagree on length: "
                         f"{dict(zip(names, (v.shape for v in values)))}")
    return Axis("dyn", names, values)


def seed_axis(seeds) -> Axis:
    """PRNG-seed axis: the failure model's seeds (32-bit integers), one
    grid dim of their length."""
    return Axis("seed", (SEED_KEY,), (host_values(seeds, np.int32),))


def tasktrace_axis(arrivals) -> Axis:
    """Workload-arrival axis: per-task arrival sets f32[A, T] -> one grid
    dim of length A.  Each point re-times the task table with one row of
    arrival hours (`state.retime_task_table` through the `arrival_trace`
    dyn key): the same task population, arriving on another traffic curve.
    Rows are sorted here, on the host, since the table's FIFO order is its
    row order; the other columns keep theirs.  T must equal `tasks.n`
    (checked when the grid runs)."""
    x = (arrivals.detach().cpu().numpy() if isinstance(arrivals, torch.Tensor)
         else arrivals)
    arr = np.sort(np.asarray(x, np.float32), axis=-1)
    if arr.ndim != 2:
        raise ValueError(f"tasktrace_axis wants f32[A, T], got {arr.shape}")
    return Axis("tasktrace", (TASKTRACE_KEY,), (torch.from_numpy(arr),))


def region_axis(fleet) -> Axis:
    """Multi-datacenter fleet axis of the reference: refused."""
    _refuse("region_axis", _ITEM_4)


def fleet_axis(**named_values) -> Axis:
    """Per-region dyn axis of the reference: refused."""
    _refuse("fleet_axis", _ITEM_4)


def _normalize_reduce(reduce, ndim: int):
    """Validate a (op, axis) reduction spec; returns (op, positive_axis)."""
    if reduce is None:
        return None
    op, axis = reduce
    if op not in _REDUCERS:
        raise ValueError(f"unknown reduce op '{op}'; "
                         f"pick one of {sorted(_REDUCERS)}")
    axis = int(axis)
    if not -ndim <= axis < ndim:
        raise ValueError(f"reduce axis {axis} out of range for a "
                         f"{ndim}-dimensional grid")
    return op, axis % ndim


def _result_map(fn, *results: SimResult) -> SimResult:
    """Apply `fn` field by field (SimResult.probes stays None)."""
    return SimResult(*(None if xs[0] is None else fn(*xs)
                       for xs in zip(*results)))


class ScenarioGrid:
    """A validated list of axes; `shape` is the result's leading
    dimensions."""

    def __init__(self, axes: Sequence[Axis], base_dyn: dict | None = None):
        axes = list(axes)
        if not axes:
            raise ValueError("a ScenarioGrid needs at least one axis")
        seen: set[str] = set()
        for ax in axes:
            if ax.kind in _REFUSED:
                _refuse(*_REFUSED[ax.kind])
            if ax.kind not in (*_TRACE_KINDS, *_VALUE_KINDS):
                raise ValueError(f"unknown axis kind '{ax.kind}'")
            for name in ax.names:
                if name in seen:
                    raise ValueError(f"axis name '{name}' declared twice")
                seen.add(name)
        if base_dyn and (dup := seen & set(base_dyn)):
            raise ValueError(f"base dyn keys {sorted(dup)} shadow grid axes")
        self.axes = axes
        self.base_dyn = dict(base_dyn or {})

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(ax.length for ax in self.axes)

    @property
    def n_scenarios(self) -> int:
        return math.prod(self.shape)

    def has_trace_axis(self) -> bool:
        return any(ax.kind == "trace" for ax in self.axes)

    def _check_cfg(self, cfg: SimConfig):
        for kind, on, flag, what in (
                ("weather", cfg.cooling.enabled, "cooling",
                 "the wet-bulb trace"),
                ("price", cfg.pricing.enabled, "pricing",
                 "the price trace"),
                ("renewable", cfg.renewables.enabled, "renewables",
                 "the PV capacity-factor trace")):
            if not on and any(ax.kind == kind for ax in self.axes):
                raise ValueError(f"grid has a {kind}_axis but cfg.{flag}."
                                 f"enabled is False: {what} would be "
                                 "ignored")

    def _check_tasks(self, tasks: TaskTable):
        for ax in self.axes:
            if ax.kind == "tasktrace" and ax.values[0].shape[1] != tasks.n:
                raise ValueError(
                    f"tasktrace_axis carries {ax.values[0].shape[1]} "
                    f"arrivals per point but the task table has {tasks.n} "
                    "rows: generate the arrival sets with "
                    "n_tasks == tasks.n (retiming is a bijection on rows)")

    def _check_trace(self, ci_trace):
        if self.has_trace_axis():
            if ci_trace is not None:
                raise ValueError("grid already has a trace_axis; "
                                 "drop the ci_trace argument")
        elif ci_trace is None:
            raise ValueError("no trace_axis in the grid: pass ci_trace")

    def cells(self, start: int, stop: int, ci_trace, device):
        """(ci_trace, dyn, B) of the scenario rows whose leading index is in
        [start, stop), in C order of the axes: each axis' values gathered
        to the rows (trace rows on `device`, dyn values on the host)."""
        sub = (stop - start, *self.shape[1:])
        idx = np.indices(sub).reshape(len(sub), -1)
        idx[0] += start
        ci, dyn = ci_trace, dict(self.base_dyn)
        for ax, ix in zip(self.axes, idx):
            if ax.kind in _VALUE_KINDS:
                dyn.update((n, v[ix]) for n, v in zip(ax.names, ax.values))
                continue
            at = torch.as_tensor(ix, device=device)
            v = ax.values[0]
            rows = maybe_dequantize(type(v)(*(x.to(device)[at] for x in v))
                                    if isinstance(v, QuantizedTrace)
                                    else v.to(device)[at])
            if ax.kind == "trace":
                ci = rows
            else:
                dyn[ax.names[0]] = rows
        return ci, dyn, idx.shape[1]

    def run(self, tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
            ci_trace=None, *, chunk_size: int | None = None, mesh=None,
            jit: bool = True, reduce: tuple[str, int] | None = None,
            memory_budget_bytes: float | None = None,
            device="cuda") -> SimResult:
        """Evaluate the whole grid on `device`.  Returns a SimResult whose
        fields have leading dimensions `self.shape` (minus the reduced
        axis, if any).

        chunk_size: split the LEADING axis into chunks of at most this many
          points, one step loop a chunk (bounds device memory).  Omitted, it
          comes from `memory_budget_bytes`; grids that fit run unchunked.
        reduce: (op, axis) with op in {'min', 'max', 'argmin', 'argmax'}
          folds every field over that grid axis; it must not be the leading
          axis of a chunked run.
        jit: accepted for the reference's signature; no effect.
        mesh: refused (ROADMAP Queue 1 item 6f).
        """
        if mesh is not None:
            _refuse("a mesh-sharded grid (mesh=)", _ITEM_6F)
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self._check_cfg(cfg)
        self._check_tasks(tasks)
        red = _normalize_reduce(reduce, len(self.shape))
        self._check_trace(ci_trace)
        auto_chunked = chunk_size is None
        if auto_chunked:
            chunk_size = self._auto_chunk_size(tasks, hosts, cfg,
                                               memory_budget_bytes)
        lead = self.axes[0].length
        if red is not None and red[1] == 0 and lead > chunk_size:
            cause = ("chunk size auto-derived from the memory budget"
                     if auto_chunked else "explicit chunk_size")
            raise ValueError(
                f"reduce=({red[0]!r}, 0) targets the leading axis of a "
                f"chunked run (leading length {lead}, chunks of "
                f"{chunk_size}: {cause}): move the reduced axis off axis 0, "
                "raise the memory budget, or pass an explicit chunk_size >= "
                "the leading length")
        parts = []
        for start in range(0, lead, chunk_size):
            ci, dyn, b = self.cells(start, min(lead, start + chunk_size),
                                    ci_trace, device)
            final, _ = engine.run_cells(tasks, hosts, ci, cfg, b, dyn=dyn,
                                        device=device)
            parts.append(summarize(final, cfg))
        res = _result_map(lambda *xs: torch.cat(xs, 0).reshape(
            *self.shape, *xs[0].shape[1:]), *parts)
        if red is None:
            return res
        op, axis = red
        return _result_map(lambda x: _REDUCERS[op](x, dim=axis), res)

    def _per_lead_bytes(self, tasks: TaskTable, hosts: HostTable,
                        cfg: SimConfig) -> float:
        """Estimated device bytes per leading-axis point of this port's
        layout (core/state.py).  A scenario row holds its written task
        columns twice while a step replaces them, its share of a step's
        [B, T] temporaries (`_SCRATCH_BYTES_PER_TASK`), [B, H] host rows
        and its [B, S] series: the step inputs twice (rows and per-step
        columns), the megakernel's IT series and the facility kernel's
        copies.  Shared [1, T] columns are not per row.  Host failures add
        the two columns they write ([B, T] `ckpt_remaining`, `lost_work`),
        the hosts' `up` and `repair_at` rows, a step's bool failure draws
        ([S, B, H]) and keys.  A swept `arrival_trace` makes `arrival` (and
        `status`) a row's own; a swept `interactive_frac`, or an
        `arrival_trace` under priority levels, every task column."""
        t, h, s = (tasks.arrival.shape[-1], hosts.cores.shape[-1],
                   cfg.n_steps)
        swept = {n for ax in self.axes for n in ax.names}
        retimed = TASKTRACE_KEY in swept
        if "interactive_frac" in swept or (
                retimed and cfg.scheduler.priority_levels > 1):
            cols = TaskTable._fields
        else:
            cols = WRITTEN_TASK_COLUMNS + (("arrival",) if retimed else ())
        if cfg.failures.enabled:
            cols = set(cols) | {"ckpt_remaining", "lost_work"}
        written = sum(getattr(tasks, f).element_size() for f in cols)
        per_cell = ((2 * written + _SCRATCH_BYTES_PER_TASK) * t
                    + _HOST_ROW_BYTES * h
                    + (2 * len(engine.SERIES) + 10) * 4 * s)
        if cfg.failures.enabled:
            per_cell += 2 * 5 * h + s * (h + 16)
        return per_cell * (self.n_scenarios / max(self.axes[0].length, 1))

    def _auto_chunk_size(self, tasks, hosts, cfg: SimConfig,
                         budget_bytes: float | None) -> int:
        """Chunk size from a device-memory budget: the leading axis is
        chunked so `chunk * bytes per leading point` fits; a grid under
        budget returns its whole leading length (runs unchunked)."""
        if budget_bytes is None:
            budget_bytes = float(os.environ.get(
                "STEAM_SWEEP_MEMORY_BUDGET_MB", 4096)) * 2**20
        lead = self.axes[0].length
        per_lead = self._per_lead_bytes(tasks, hosts, cfg)
        return max(1, min(lead, int(budget_bytes // max(per_lead, 1.0))))

    def run_shard_map(self, *args, **kwargs):
        """The reference's weak-scaling executor: refused."""
        _refuse("ScenarioGrid.run_shard_map", _ITEM_6F)

    def shard_map_callable(self, *args, **kwargs):
        """The reference's weak-scaling executor: refused."""
        _refuse("ScenarioGrid.shard_map_callable", _ITEM_6F)

    def lower(self, *args, **kwargs):
        """The reference's whole-grid lowering: refused (nothing here is
        compiled as one program)."""
        _refuse("ScenarioGrid.lower", _ITEM_6F)


# a step's [B, T] temporaries, bytes per task and scenario row: the
# scheduler's int64 cumsum and bins, the per-host sums' [B, H + T] buffer,
# masks and the progress stage's f32 columns, a few live at a time.  With
# the written columns this makes 72 bytes a task and row; full-scale
# Marconi (T = 192,817) at 64 rows peaked at 12.5 MB a row, 65 bytes a
# task, on an H100 (chip_smoke.py's grid phase)
_SCRATCH_BYTES_PER_TASK = 32
# [B, H] rows of a step: utilizations, free capacity, power, masks
_HOST_ROW_BYTES = 48


def sweep_grid(tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
               axes: Sequence[Axis], ci_trace=None, *,
               dyn: dict | None = None, chunk_size: int | None = None,
               mesh=None, jit: bool = True,
               reduce: tuple[str, int] | None = None,
               memory_budget_bytes: float | None = None,
               executor: str = "chunked", device="cuda") -> SimResult:
    """One-call entry point: `sweep_grid(tasks, hosts, cfg, [axis, ...])`.

    `dyn` holds fixed (non-swept) scenario values applied to every grid
    point, e.g. `dyn={"n_active_hosts": 12}`.  `reduce=(op, axis)` folds an
    axis.  `executor="shard_map"` (the reference's weak-scaling executor) is
    refused.  See the module docstring for the axis kinds."""
    grid = ScenarioGrid(axes, base_dyn=dyn)
    if executor == "shard_map":
        _refuse("executor='shard_map'", _ITEM_6F)
    if executor != "chunked":
        raise ValueError(f"unknown executor {executor!r}; "
                         f"pick 'chunked' or 'shard_map'")
    return grid.run(tasks, hosts, cfg, ci_trace, chunk_size=chunk_size,
                    mesh=mesh, jit=jit, reduce=reduce,
                    memory_budget_bytes=memory_budget_bytes, device=device)
