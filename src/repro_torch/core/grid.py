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
  * `region_axis(fleet)` -- a multi-datacenter fleet (core/fleet.py): the
    FleetSpec's R regional datacenters (per-region carbon and weather
    traces, host counts, battery sizing, setpoints) run inside every grid
    cell.  Not a swept dimension: each cell is R consecutive scenario rows
    (cell-major, region-minor), each row a region's own [W] task table;
    the result is a `FleetResult` whose `per_region` fields carry a
    trailing R axis and whose `total` holds the fleet's totals.  Placement
    (spatial shifting) happens once, on the host, when the grid runs.
  * `fleet_axis(**named_values)` -- per-region dyn values [K, R]: each of
    the K grid points supplies one length-R vector (e.g. per-region host
    counts).  Requires a `region_axis`.

Refused with the reference's ValueError: more than one `region_axis`, a
`region_axis` leading other axes, a trace, weather, price, renewable or
task-trace axis beside it, a `fleet_axis` without it or of another R.

Multi-GPU executors (the reference's NamedSharding and `shard_map` ones).
`run(..., mesh=)` splits the leading axis over the mesh's `pod` x `data`
devices (launch/mesh.py; one process a card, `torchrun`): each rank runs
its block of every chunk (chunks rounded to a multiple of those devices)
through the chunk loop on its own card, then every result field is
gathered (`all_gather_into_tensor`) so that every rank returns the whole
grid in the reference's cell order.  Ranks along `model` compute the same
block, as GSPMD replicates it.  The cells are independent: there is no
collective inside the step loop, and a world of one is the chunked path
bit for bit.  `run_shard_map` / `shard_map_callable` give each lead
device one block of the whole leading axis (`lead % devices == 0`).
`lower` traces the grid's program on fake tensors and returns its
per-device operation counts (launch/op_analysis.py).

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

With `cfg.probes` on, `SimResult.probes` carries each cell's ring: fields
of shape `(*grid.shape, K)`.  A telemetry session sees the spans
`grid.build`, `grid.execute` and one `grid.chunk` a chunk, a "grid" run
record with the chunk plan, and a recompile guard over the chunk loop.
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Sequence

import numpy as np
import torch

from . import engine, telemetry
from .config import SimConfig
from .fleet import (FleetResult, check_fleet_cfg, fleet_place, split_dyn)
from .metrics import SimResult, fleet_totals, summarize
from .quant import STORES, QuantizedTrace, maybe_dequantize, quantize_trace
from .spatial import split_by_region
from .state import WRITTEN_TASK_COLUMNS, HostTable, TaskTable

TRACE_KEY = "ci_trace"
SEED_KEY = "seed"
WEATHER_KEY = "wet_bulb_trace"
PRICE_KEY = "price_trace"
PV_KEY = "pv_cf_trace"
TASKTRACE_KEY = "arrival_trace"
FLEET_CI_KEY = "fleet_ci_traces"
FLEET_WB_KEY = "fleet_wb_traces"
FLEET_PRICE_KEY = "fleet_price_traces"
FLEET_PV_KEY = "fleet_pv_traces"
# a fleet's per-region traces and the dyn trace keys they feed
_FLEET_TRACES = ((FLEET_WB_KEY, "wb_traces", WEATHER_KEY),
                 (FLEET_PRICE_KEY, "price_traces", PRICE_KEY),
                 (FLEET_PV_KEY, "pv_traces", PV_KEY))

_REDUCERS = {"min": torch.amin, "max": torch.amax,
             "argmin": torch.argmin, "argmax": torch.argmax}
_TRACE_KINDS = ("trace", "weather", "price", "renewable", "tasktrace")
_VALUE_KINDS = ("dyn", "seed")
_FLEET_KINDS = ("region", "fleet")

class Axis(NamedTuple):
    """One grid dimension: `names[j]` is swept with `values[j]` (zipped).

    A trace axis' value is an f32 [L, S] tensor or a `QuantizedTrace` of
    [L, ...] tensors; a dyn axis' values are host (numpy) arrays of length
    L, a fleet axis' [L, R].  A region axis holds its fleet's [R, S]
    traces and the FleetSpec (`meta`)."""

    kind: str
    names: tuple[str, ...]
    values: tuple
    meta: object = None

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
    """Fleet axis: the FleetSpec's R regional datacenters run inside every
    grid cell (core/fleet.py).  Not a swept result dimension: per-region
    results carry a trailing R axis.  Declare it after the swept axes (it
    cannot lead a chunked grid)."""
    values = (torch.from_numpy(fleet.ci_traces),)
    names = (FLEET_CI_KEY,)
    for key, attr, _ in _FLEET_TRACES:
        if getattr(fleet, attr) is not None:
            values += (torch.from_numpy(getattr(fleet, attr)),)
            names += (key,)
    return Axis("region", names, values, meta=fleet)


def fleet_axis(**named_values) -> Axis:
    """Per-region dyn axis: each value is [K, R], K grid points of one
    length-R vector applied region by region inside the fleet cell (e.g.
    `fleet_axis(n_active_hosts=counts)` sweeps per-region host counts).
    Requires a `region_axis` in the same grid; several names zip along K
    as in `dyn_axis`."""
    if not named_values:
        raise ValueError("fleet_axis needs at least one name=values pair")
    names = tuple(named_values)
    values = tuple(host_values(v) for v in named_values.values())
    for n, v in zip(names, values):
        if v.ndim != 2:
            raise ValueError(f"fleet_axis '{n}' wants [K, R] values, "
                             f"got shape {v.shape}")
    lengths = {v.shape[0] for v in values}
    if len(lengths) != 1:
        raise ValueError(f"zipped fleet_axis values disagree on length: "
                         f"{dict(zip(names, (v.shape for v in values)))}")
    return Axis("fleet", names, values)


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
    """Apply `fn` field by field, the probes' fields too."""
    def one(*xs):
        if xs[0] is None:
            return None
        if isinstance(xs[0], telemetry.Probes):
            return telemetry.Probes(*(fn(*f) for f in zip(*xs)))
        return fn(*xs)
    return SimResult(*(one(*xs) for xs in zip(*results)))


class ScenarioGrid:
    """A validated list of axes; `shape` is the result's leading
    dimensions (one a swept axis: a region axis is not swept)."""

    def __init__(self, axes: Sequence[Axis], base_dyn: dict | None = None):
        axes = list(axes)
        if not axes:
            raise ValueError("a ScenarioGrid needs at least one axis")
        seen: set[str] = set()
        for ax in axes:
            if ax.kind not in (*_TRACE_KINDS, *_VALUE_KINDS, *_FLEET_KINDS):
                raise ValueError(f"unknown axis kind '{ax.kind}'")
            for name in ax.names:
                if name in seen:
                    raise ValueError(f"axis name '{name}' declared twice")
                seen.add(name)
        if base_dyn and (dup := seen & set(base_dyn)):
            raise ValueError(f"base dyn keys {sorted(dup)} shadow grid axes")
        regions = [ax for ax in axes if ax.kind == "region"]
        if len(regions) > 1:
            raise ValueError("a grid can hold at most one region_axis")
        self.fleet = regions[0].meta if regions else None
        if self.fleet is not None:
            if axes[0].kind == "region" and len(axes) > 1:
                raise ValueError(
                    "region_axis cannot be the grid's leading axis: declare "
                    "it after the swept axes (chunking/sharding split the "
                    "leading axis, and a fleet must never be split)")
            if any(ax.kind in ("trace", "weather", "price", "renewable")
                   for ax in axes):
                raise ValueError(
                    "region_axis already carries per-region carbon/weather/"
                    "price/pv traces; drop the trace_axis/weather_axis/"
                    "price_axis/renewable_axis")
            if any(ax.kind == "tasktrace" for ax in axes):
                raise ValueError(
                    "tasktrace_axis re-times the task table, but a fleet "
                    "grid splits tasks across regions host-side before the "
                    "compiled program runs: re-timed arrivals could not "
                    "re-place them — sweep arrival sets by building one "
                    "fleet per set instead")
            for ax in axes:
                if ax.kind == "fleet":
                    for n, v in zip(ax.names, ax.values):
                        if v.shape[1] != self.fleet.n_regions:
                            raise ValueError(
                                f"fleet_axis '{n}' has {v.shape[1]} regions, "
                                f"the fleet has {self.fleet.n_regions}")
        elif any(ax.kind == "fleet" for ax in axes):
            raise ValueError("fleet_axis sweeps per-region values: the grid "
                             "also needs a region_axis(fleet)")
        self.axes = axes
        self.base_dyn = dict(base_dyn or {})

    @property
    def shape(self) -> tuple[int, ...]:
        """Leading result dimensions: one per swept axis (a fleet's R
        shows up trailing on its `per_region` fields)."""
        return tuple(ax.length for ax in self.axes if ax.kind != "region")

    @property
    def n_scenarios(self) -> int:
        return math.prod(self.shape)

    @property
    def _lead(self) -> int:
        """The length of the leading (chunked) axis; 1 for a lone region
        axis, which is not chunked."""
        return self.shape[0] if self.shape else 1

    def has_trace_axis(self) -> bool:
        return any(ax.kind in ("trace", "region") for ax in self.axes)

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
        if self.fleet is not None:
            check_fleet_cfg(self.fleet, cfg)

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

    def _points(self, start: int, stop: int) -> np.ndarray:
        """[n_swept, n] indices of the grid points whose leading index is
        in [start, stop), in C order of the swept axes."""
        sub = (stop - start, *self.shape[1:]) if self.shape else (1,)
        idx = np.indices(sub).reshape(len(sub), -1)
        idx[0] += start
        return idx

    def cells(self, start: int, stop: int, ci_trace, device):
        """(ci_trace, dyn, B) of the scenario rows whose leading index is in
        [start, stop), in C order of the axes: each axis' values gathered
        to the rows (trace rows on `device`, dyn values on the host)."""
        idx = self._points(start, stop)
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

    def fleet_cells(self, start: int, stop: int, device):
        """(ci_trace, dyn, B) of a fleet grid's scenario rows for the points
        whose leading index is in [start, stop): R consecutive rows a
        point (cell-major, region-minor).  A swept value holds for the
        point's R rows, a per-region value (the spec's, a length-R base dyn
        value, a `fleet_axis` point's [R]) is one a row and wins over a
        swept one of the same key, as in `simulate_fleet`; the region
        axis' traces are each point's [R, S] rows."""
        r = self.fleet.n_regions
        idx = self._points(start, stop)
        n = idx.shape[1]
        scalar, per_region = split_dyn(self.fleet, self.base_dyn)
        swept = {}
        for ax, ix in zip([a for a in self.axes if a.kind != "region"], idx):
            for name, v in zip(ax.names, ax.values):
                if ax.kind == "fleet":
                    per_region[name] = v[ix]              # [n, R]
                else:
                    swept[name] = np.repeat(v[ix], r)     # [n * R]
        dyn = {**scalar, **swept}
        for key, v in per_region.items():
            v = np.asarray(v)
            dyn[key] = v.reshape(-1) if v.ndim == 2 else np.tile(v, n)
        region = next(ax for ax in self.axes if ax.kind == "region")
        named = dict(zip(region.names, region.values))
        ci = named[FLEET_CI_KEY].to(device).repeat(n, 1)
        for key, _, dyn_key in _FLEET_TRACES:
            if key in named:
                dyn[dyn_key] = named[key].to(device).repeat(n, 1)
        return ci, dyn, n * r

    def _fleet_chunk(self, stacked: TaskTable, hosts: HostTable,
                     cfg: SimConfig, start: int, stop: int,
                     device) -> FleetResult:
        """One chunk of a fleet grid: its points' R rows each through one
        step loop, the [R, W] placed tables repeated a point."""
        r = self.fleet.n_regions
        ci, dyn, b = self.fleet_cells(start, stop, device)
        n = b // r
        tasks = TaskTable(*(col.repeat(n, 1) for col in stacked))
        final, _ = engine.run_cells(tasks, hosts, ci, cfg, b, dyn=dyn,
                                    device=device)
        per = _result_map(lambda x: x.reshape(n, r, *x.shape[1:]),
                          summarize(final, cfg))
        return FleetResult(total=fleet_totals(per, axis=1), per_region=per)

    def run(self, tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
            ci_trace=None, *, chunk_size: int | None = None, mesh=None,
            jit: bool = True, reduce: tuple[str, int] | None = None,
            memory_budget_bytes: float | None = None, device="cuda"):
        """Evaluate the whole grid on `device`.  Returns a SimResult whose
        fields have leading dimensions `self.shape` (minus the reduced
        axis, if any); for a fleet grid a FleetResult, whose `total` fields
        have those dimensions and whose `per_region` fields a trailing R.

        chunk_size: split the LEADING axis into chunks of at most this many
          points, one step loop a chunk (bounds device memory).  Omitted, it
          comes from `memory_budget_bytes`; grids that fit run unchunked.
          A lone region axis runs unchunked.
        reduce: (op, axis) with op in {'min', 'max', 'argmin', 'argmax'}
          folds every field over that grid axis; it must not be the leading
          axis of a chunked run.
        jit: accepted for the reference's signature; no effect.
        mesh: a DeviceMesh (launch/mesh.py) over the default process group;
          the leading axis is split over its `pod` x `data` devices, chunks
          rounded up to a multiple of them, and every rank returns the
          whole grid.
        """
        if mesh is not None and self.axes[0].kind == "region":
            raise ValueError("cannot shard a grid whose only axis is the "
                             "region_axis: add a swept leading axis")
        if chunk_size is not None and chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {chunk_size}")
        self._check_cfg(cfg)
        self._check_tasks(tasks)
        red = _normalize_reduce(reduce, len(self.shape))
        self._check_trace(ci_trace)
        with telemetry.span("grid.build", shape=str(self.shape)):
            if self.fleet is not None:
                # placement is exogenous and happens once, here, on the
                # host: the grid sweeps what the placed fleet runs, not
                # where tasks go
                region = fleet_place(tasks, hosts, self.fleet, cfg.dt_h,
                                     n_steps=cfg.n_steps)
                tasks = split_by_region(tasks, region, self.fleet.n_regions,
                                        device=device)
        with telemetry.run_recorder("grid", cfg, device=device) as rec:
            if telemetry.enabled():
                self._describe(rec)
                if mesh is not None:
                    rec.mesh = _mesh_record(mesh)
            return self._run(tasks, hosts, cfg, ci_trace, chunk_size, red,
                             memory_budget_bytes, device, rec, mesh)

    def _describe(self, rec) -> None:
        """The grid's shape, axes and trace dtypes in its run record."""
        rec.grid_shape = [int(n) for n in self.shape]
        rec.extra["n_scenarios"] = int(self.n_scenarios)
        rec.extra["axes"] = [{"kind": ax.kind, "names": list(ax.names),
                              "length": ax.length} for ax in self.axes]
        rec.trace_dtypes = {
            ax.names[0]: _dtype_name(ax.values[0]) for ax in self.axes
            if ax.kind in ("trace", "weather", "price", "renewable")}

    def _payload_bytes(self) -> int:
        """Bytes of the axes' values as the grid holds them."""
        def nbytes(v):
            if isinstance(v, QuantizedTrace):
                return sum(nbytes(x) for x in v)
            if isinstance(v, torch.Tensor):
                return v.numel() * v.element_size()
            return int(np.asarray(v).nbytes)
        return sum(nbytes(v) for ax in self.axes for v in ax.values)

    def _run(self, tasks, hosts, cfg, ci_trace, chunk_size, red,
             memory_budget_bytes, device, rec, mesh=None):
        """`run`'s execution body: the chunk loop (`rec` is the draft of
        the run record, filled in while a session is active).  On a mesh
        each rank runs its block of every chunk and the blocks are
        gathered."""
        lead = self._lead
        auto_chunked = chunk_size is None
        if not self.shape:
            chunk_size = 1
        elif auto_chunked:
            chunk_size = self._auto_chunk_size(tasks, hosts, cfg,
                                               memory_budget_bytes)
        ndev, me = 1, 0
        if mesh is not None:
            chunk_size = _round_chunk_to_mesh(mesh, chunk_size)
            ndev, me = _lead_devices(mesh), _lead_index(mesh)
            if lead % ndev:
                raise ValueError(
                    f"a sharded grid splits its leading axis ({lead} cells) "
                    f"over the mesh's {ndev} pod x data devices: size it as "
                    "cells = k * devices")
        if red is not None and red[1] == 0 and lead > chunk_size:
            cause = ("chunk size auto-derived from the memory budget"
                     if auto_chunked else "explicit chunk_size")
            raise ValueError(
                f"reduce=({red[0]!r}, 0) targets the leading axis of a "
                f"chunked run (leading length {lead}, chunks of "
                f"{chunk_size}: {cause}): move the reduced axis off axis 0, "
                "raise the memory budget, or pass an explicit chunk_size >= "
                "the leading length")
        if telemetry.enabled():
            # the chunk plan: predicted (estimate-based) vs actual bytes
            rec.chunk = {
                "chunk_size": int(chunk_size),
                "n_chunks": -(-lead // chunk_size),
                "auto": bool(auto_chunked),
                "predicted_bytes_per_lead": float(
                    self._per_lead_bytes(tasks, hosts, cfg)),
                "actual_payload_bytes": self._payload_bytes()}
        # every chunk runs the same kernels: builds belong to the first
        guard = telemetry.recompile_guard("grid.run chunk loop", allowed=1)
        parts = []
        with telemetry.span("grid.execute", chunks=-(-lead // chunk_size)), \
                guard:
            for i, start in enumerate(range(0, lead, chunk_size)):
                stop = min(lead, start + chunk_size)
                blk = (stop - start) // ndev
                lo = start + me * blk
                with telemetry.span("grid.chunk", index=i, start=lo):
                    guard.mark()
                    part = self._chunk(tasks, hosts, cfg, ci_trace, lo,
                                       lo + blk, device)
                    parts.append(part if mesh is None
                                 else _gather_lead(part, mesh))
                guard.tick()

        return self._finish(parts, red)

    def _finish(self, parts: list, red=None):
        """The chunks' results joined along the leading axis, reshaped to
        the grid and reduced (a fleet grid's total and per-region parts
        alike)."""
        def finish(results: list[SimResult]) -> SimResult:
            res = _result_map(lambda *xs: torch.cat(xs, 0).reshape(
                (*self.shape, *xs[0].shape[1:])), *results)
            if red is None:
                return res
            op, axis = red
            return _result_map(lambda x: _REDUCERS[op](x, dim=axis), res)

        if self.fleet is None:
            return finish(parts)
        return FleetResult(total=finish([p.total for p in parts]),
                           per_region=finish([p.per_region for p in parts]))

    def _chunk(self, tasks, hosts, cfg, ci_trace, start: int, stop: int,
               device):
        """The SimResult (a fleet grid's FleetResult) of the points whose
        leading index is in [start, stop): one step loop."""
        if self.fleet is not None:
            return self._fleet_chunk(tasks, hosts, cfg, start, stop, device)
        ci, dyn, b = self.cells(start, stop, ci_trace, device)
        final, _ = engine.run_cells(tasks, hosts, ci, cfg, b, dyn=dyn,
                                    device=device)
        return summarize(final, cfg)

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
        `arrival_trace` under priority levels, every task column.  The
        probe bus adds its ring (`telemetry.Probes`' fields, K samples
        each).  A fleet grid's point is R rows, and every task column is a
        row's own: pass the placed [R, W] tables (`split_by_region`) as
        `tasks`."""
        t, h, s = (tasks.arrival.shape[-1], hosts.cores.shape[-1],
                   cfg.n_steps)
        swept = {n for ax in self.axes for n in ax.names}
        retimed = TASKTRACE_KEY in swept
        if self.fleet is not None or "interactive_frac" in swept or (
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
        if cfg.probes.enabled:
            per_cell += len(telemetry.Probes._fields) * 4 * (
                telemetry.probe_capacity(s, cfg.probes))
        if self.fleet is not None:
            per_cell *= self.fleet.n_regions
        return per_cell * (self.n_scenarios / max(self._lead, 1))

    def _auto_chunk_size(self, tasks, hosts, cfg: SimConfig,
                         budget_bytes: float | None) -> int:
        """Chunk size from a device-memory budget: the leading axis is
        chunked so `chunk * bytes per leading point` fits; a grid under
        budget returns its whole leading length (runs unchunked)."""
        if budget_bytes is None:
            budget_bytes = float(os.environ.get(
                "STEAM_SWEEP_MEMORY_BUDGET_MB", 4096)) * 2**20
        lead = self._lead
        per_lead = self._per_lead_bytes(tasks, hosts, cfg)
        return max(1, min(lead, int(budget_bytes // max(per_lead, 1.0))))

    def payloads(self) -> tuple:
        """The axes' values, one tuple an axis (what `shard_map_callable`'s
        callable takes)."""
        return tuple(ax.values for ax in self.axes)

    def _with_lead(self, values: tuple, start: int, stop: int,
                   device) -> "ScenarioGrid":
        """This grid with the leading axis' values `values` cut to points
        [start, stop) and held on `device`."""
        def cut(v):
            if isinstance(v, QuantizedTrace):
                return type(v)(*(cut(x) for x in v))
            if isinstance(v, torch.Tensor):
                return v[start:stop].to(device)
            return v[start:stop]
        first = self.axes[0]._replace(values=tuple(cut(v) for v in values))
        return ScenarioGrid([first, *self.axes[1:]], base_dyn=self.base_dyn)

    def shard_map_callable(self, tasks: TaskTable, hosts: HostTable,
                           cfg: SimConfig, ci_trace=None, *, mesh=None,
                           donate: bool = True, device="cuda"):
        """The weak-scaling executor: `f(*payloads) -> SimResult`.

        Each device along the mesh's `pod` x `data` axes runs one block of
        `lead / devices` points of the leading axis as one step loop on its
        own card, with no collective inside the loop; the blocks are then
        gathered, so every rank returns the whole grid.  The leading axis
        must divide evenly.  The rank's block is copied to its card once a
        call; `donate=True` releases that copy after the block's run,
        `donate=False` keeps it for the next call with the same payload
        (repeated timing calls).  `mesh=None` is a one-dimensional `data`
        mesh over the default process group, or one device without one."""
        if self.axes[0].kind == "region":
            raise ValueError("cannot shard a grid whose leading axis is the "
                             "region_axis: add a swept leading axis")
        mesh = _default_mesh(mesh, device)
        ndev = 1 if mesh is None else _lead_devices(mesh)
        me = 0 if mesh is None else _lead_index(mesh)
        lead = self._lead
        if lead % ndev:
            raise ValueError(
                f"shard_map executor: leading axis ({lead} cells) must "
                f"divide evenly over the mesh's {ndev} devices — pad the "
                f"axis or size the grid as cells = k * device_count")
        blk = lead // ndev
        if self.fleet is not None:
            region = fleet_place(tasks, hosts, self.fleet, cfg.dt_h,
                                 n_steps=cfg.n_steps)
            tasks = split_by_region(tasks, region, self.fleet.n_regions,
                                    device=device)
        kept: list = []

        def call(*payloads):
            if kept and kept[0] is payloads[0]:
                block = kept[1]
            else:
                block = self._with_lead(payloads[0], me * blk,
                                        (me + 1) * blk, device)
                kept[:] = [] if donate else [payloads[0], block]
            part = block._chunk(tasks, hosts, cfg, ci_trace, 0, blk, device)
            del block
            return self._finish([part if mesh is None
                                 else _gather_lead(part, mesh)])
        return call

    def run_shard_map(self, tasks: TaskTable, hosts: HostTable,
                      cfg: SimConfig, ci_trace=None, *, mesh=None,
                      donate: bool = True, device="cuda"):
        """Evaluate the grid with the weak-scaling executor
        (`shard_map_callable`): the same result as `run`, the leading axis
        split one block a device instead of looped; at one device it is
        the unchunked run bit for bit."""
        self._check_cfg(cfg)
        self._check_tasks(tasks)
        self._check_trace(ci_trace)
        mesh = _default_mesh(mesh, device)
        with telemetry.span("grid.build", shape=str(self.shape),
                            executor="shard_map"):
            call = self.shard_map_callable(tasks, hosts, cfg, ci_trace,
                                           mesh=mesh, donate=donate,
                                           device=device)
        with telemetry.run_recorder("grid", cfg, device=device) as rec:
            if telemetry.enabled():
                self._describe(rec)
                rec.extra["executor"] = "shard_map"
                ndev = 1 if mesh is None else _lead_devices(mesh)
                if mesh is not None:
                    rec.mesh = _mesh_record(mesh)
                rec.chunk = {
                    "chunk_size": int(self._lead // ndev),
                    "n_chunks": int(ndev),
                    "auto": False,
                    "predicted_bytes_per_lead": float(
                        self._per_lead_bytes(tasks, hosts, cfg)),
                    "actual_payload_bytes": self._payload_bytes()}
            with telemetry.span("grid.execute", executor="shard_map"):
                return call(*self.payloads())

    def lower(self, tasks: TaskTable, hosts: HostTable, cfg: SimConfig,
              ci_trace=None, *, mesh=None,
              reduce: tuple[str, int] | None = None):
        """Trace (without running) the whole-grid program and return its
        per-device counts (`launch.op_analysis.Lowered`: `analyze()` gives
        matmul FLOPs, op-boundary bytes and collective bytes).  The grid
        runs on fake tensors at the payloads' shapes, with nothing
        allocated; on a mesh a device runs `lead / devices` points and
        gathers the rest."""
        from ..launch import op_analysis
        self._check_cfg(cfg)
        self._check_tasks(tasks)
        red = _normalize_reduce(reduce, len(self.shape))
        self._check_trace(ci_trace)
        return op_analysis.lower_grid(self, tasks, hosts, cfg, ci_trace,
                                      mesh=mesh, reduce=red)


def _mesh_record(mesh) -> dict:
    return {"axis_names": [str(a) for a in mesh.mesh_dim_names],
            "shape": [int(s) for s in mesh.shape]}


def _default_mesh(mesh, device):
    """`mesh`, or a one-dimensional `data` mesh over the default process
    group when there is one (None without)."""
    import torch.distributed as dist
    if mesh is not None or not dist.is_initialized():
        return mesh
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type,
                            (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def _mesh_spec(mesh) -> tuple:
    """The leading axis' spec entry: the mesh's `pod` and `data` axes (a
    group of names, kept a tuple even with one name)."""
    return (tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names),)


def _lead_devices(mesh) -> int:
    """Device count along the mesh axes the leading axis splits over."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    ndev = 1
    for a in _mesh_spec(mesh)[0]:
        ndev *= sizes[a]
    return ndev


def _round_chunk_to_mesh(mesh, chunk_size: int) -> int:
    """Round a chunk up to a multiple of the lead devices: each device runs
    an equal block of every chunk (the leading length must divide too)."""
    ndev = _lead_devices(mesh)
    return max(ndev, -(-chunk_size // ndev) * ndev)


def _lead_ranks(mesh) -> list[int]:
    """The global ranks that hold the leading axis' blocks, in block order:
    the `pod` x `data` coordinates (pod major) at every other axis' 0."""
    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    for i in reversed(range(len(names))):
        if names[i] not in ("pod", "data"):
            ranks = ranks.select(i, 0)
    return [int(r) for r in ranks.reshape(-1)]


def _lead_index(mesh) -> int:
    """This rank's block of the leading axis."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    sizes = dict(zip(names, mesh.shape))
    idx = 0
    for a in _mesh_spec(mesh)[0]:
        idx = idx * sizes[a] + coord[names.index(a)]
    return idx


def _gather_lead(part, mesh):
    """Every field of a block's result gathered over the mesh's ranks and
    laid out in the lead devices' block order (the reference's cell
    order): every rank returns the whole result."""
    import torch.distributed as dist
    if dist.get_world_size() != mesh.size():
        raise ValueError("a sharded grid's mesh must span the default "
                         "process group")
    order = _lead_ranks(mesh)
    world = mesh.size()

    def gather(x):
        src = x.contiguous()
        if src.dtype == torch.bool:
            src = src.view(torch.uint8)
        out = src.new_empty((world * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src)
        out = out.reshape(world, *src.shape)[order]
        out = out.reshape(len(order) * src.shape[0], *src.shape[1:])
        return out.view(torch.bool) if x.dtype == torch.bool else out
    if isinstance(part, FleetResult):
        return FleetResult(total=_result_map(gather, part.total),
                           per_region=_result_map(gather, part.per_region))
    return _result_map(gather, part)


def _dtype_name(v) -> str:
    """The stored dtype of a trace axis' values ('float32', 'bfloat16',
    'int8'), as the reference's records name them."""
    q = v.q if isinstance(v, QuantizedTrace) else v
    return str(q.dtype).replace("torch.", "")


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
               executor: str = "chunked", device="cuda"):
    """One-call entry point: `sweep_grid(tasks, hosts, cfg, [axis, ...])`.

    `dyn` holds fixed (non-swept) scenario values applied to every grid
    point, e.g. `dyn={"n_active_hosts": 12}`.  `reduce=(op, axis)` folds an
    axis.  A grid with a `region_axis` returns a FleetResult.
    `mesh=` splits the leading axis over the mesh's `pod` x `data` devices
    (`ScenarioGrid.run`).  `executor="shard_map"` routes through the
    weak-scaling executor (`ScenarioGrid.run_shard_map`): one leading-axis
    block a device, `lead % devices == 0` required; `chunk_size`, `reduce`
    and `memory_budget_bytes` do not apply there.  See the module docstring
    for the axis kinds."""
    grid = ScenarioGrid(axes, base_dyn=dyn)
    if executor == "shard_map":
        if chunk_size is not None or reduce is not None:
            raise ValueError("executor='shard_map' places one chunk per "
                             "device: chunk_size/reduce do not apply")
        return grid.run_shard_map(tasks, hosts, cfg, ci_trace, mesh=mesh,
                                  device=device)
    if executor != "chunked":
        raise ValueError(f"unknown executor {executor!r}; "
                         f"pick 'chunked' or 'shard_map'")
    return grid.run(tasks, hosts, cfg, ci_trace, chunk_size=chunk_size,
                    mesh=mesh, jit=jit, reduce=reduce,
                    memory_budget_bytes=memory_budget_bytes, device=device)
