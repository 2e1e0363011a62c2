"""Per-device operation counts of a traced program: the dry run's roofline
numerators.

The counterpart of the reference's `launch/hlo_analysis.py`, which reads
the per-device HLO text that XLA's SPMD partitioner compiles.  PyTorch has
no HLO, so this module counts the operations a program dispatches while it
runs (on fake tensors, so nothing is computed or allocated), through a
`TorchDispatchMode`, and records per device the same three numerators:

  flops            -- matrix-product FLOPs: every product is
                      2 x |output| x |contracted dimension|
  bytes            -- op-boundary traffic: each op's result plus operand
                      bytes, views and shape ops skipped
  collective_bytes -- result bytes of all-reduce / all-gather /
                      reduce-scatter / all-to-all / permute, by kind, with
                      their counts (the reference's
                      `parse_collective_bytes`)

Per device.  An op on DTensors is counted once, at the shapes of one
rank's shards: its local output, and the contracted dimension divided by
the mesh dimensions over which the result is a partial sum (the contracted
dimension was split there).  An op on plain tensors is replicated work and
counts whole on every device.  The collectives are those the DTensors'
redistributions issue (the `_c10d_functional` ops), seen on the local
shards.  A loop runs every trip here, so nothing needs scaling by a trip
count.  Elementwise FLOPs are not counted, as in the reference.

The live bytes of the tensors a program makes are tracked as it runs
(each result's storage counted until it is freed): `peak_bytes` is the
arguments' bytes plus the largest rise above them.
"""
from __future__ import annotations

import contextlib
import time
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

_FUNCOL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
           "all_reduce_coalesced": "all-reduce",
           "all_gather_into_tensor": "all-gather",
           "all_gather_into_tensor_coalesced": "all-gather",
           "reduce_scatter_tensor": "reduce-scatter",
           "reduce_scatter_tensor_coalesced": "reduce-scatter",
           "all_to_all_single": "all-to-all",
           "broadcast": "collective-permute",
           "broadcast_": "collective-permute"}
# ops that move no bytes: aliases, shape queries, allocation, bookkeeping
_SKIP = {"detach", "lift_fresh", "empty", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "expand", "alias",
         "wait_tensor", "device", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size", "_local_scalar_dense"}
# (output dims after the contraction, index of the lhs argument)
_PRODUCTS = {aten.mm.default: 0, aten.bmm.default: 0,
             aten.addmm.default: 1, aten.baddbmm.default: 1,
             aten.addbmm.default: 1}


def _tensors(x, out=None) -> list:
    out = [] if out is None else out
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return getattr(t, "_local_tensor", t)


def _nbytes(t: torch.Tensor) -> int:
    t = _local(t)
    return t.numel() * t.element_size()


def _short(func) -> str:
    return func.__name__.split(".")[0] if hasattr(func, "__name__") \
        else str(func)


def _op_name(func) -> str:
    return func._opname if hasattr(func, "_opname") else _short(func)


@dataclass
class Totals:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = field(default_factory=dict)
    counts: dict = field(default_factory=dict)
    peak_rise: int = 0

    def note_collective(self, kind: str, nbytes: float, n: int = 1):
        self.coll[kind] = self.coll.get(kind, 0.0) + float(nbytes)
        self.counts[kind] = self.counts.get(kind, 0) + n


class _Live:
    """Bytes of the result storages still alive (weak references)."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self._seen: set = set()

    def add(self, t: torch.Tensor):
        try:
            st = _local(t).untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = id(st)
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)

        def gone(k=key, n=n, live=self):
            live.live -= n
            live._seen.discard(k)
        try:
            weakref.finalize(st, gone)
        except TypeError:
            self._seen.discard(key)
            self.live -= n


class _CollectivesOnly(TorchDispatchMode):
    """Inside a DTensor op: the collectives its redistributions issue on
    the local shards (the local compute is counted at the DTensor op)."""

    def __init__(self, counter: "OpCounter"):
        super().__init__()
        self.counter = counter

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.counter._collective(func, args, out)
        return out


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


class OpCounter(TorchDispatchMode):
    """Counts a program's per-device FLOPs, bytes and collectives while it
    runs under this mode (see the module docstring)."""

    def __init__(self):
        super().__init__()
        self.totals = Totals()
        self._live = _Live()

    @property
    def peak_rise(self) -> int:
        return self._live.peak

    def _collective(self, func, args, out) -> bool:
        ns = getattr(func, "namespace", "")
        if ns not in ("_c10d_functional", "c10d_functional", "c10d"):
            return False
        kind = _FUNCOL.get(_op_name(func))
        if kind is not None:
            self.totals.note_collective(
                kind, sum(_nbytes(t) for t in _tensors(out)))
        return True

    def _product(self, func, args, out) -> None:
        lhs = args[_PRODUCTS[func]]
        k = lhs.shape[-1]
        o = _local(out)
        from torch.distributed.tensor import DTensor
        if isinstance(out, DTensor):
            for i, p in enumerate(out.placements):
                if p.is_partial():
                    k = k / out.device_mesh.size(i)
        self.totals.flops += 2.0 * o.numel() * k

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = any(_is_dtensor_type(t) for t in types)
        if dtensor:
            with _CollectivesOnly(self):
                out = func(*args, **kwargs)
        else:
            out = func(*args, **kwargs)
            if self._collective(func, args, out):
                return out
        name = _op_name(func)
        if func in _PRODUCTS:
            self._product(func, args, out)
        if not (getattr(func, "is_view", False) or name in _SKIP):
            ins = _tensors(args) + _tensors(kwargs)
            outs = _tensors(out)
            self.totals.bytes += sum(_nbytes(t) for t in ins + outs)
            for t in outs:
                self._live.add(t)
        return out


def count(fn, *args, **kwargs):
    """(fn's result, Totals, seconds) of `fn(*args, **kwargs)` run under an
    OpCounter (and DTensor's implicit replication of plain tensors, which
    an installed mesh has on already: `ctx.use_mesh`)."""
    from torch.distributed.tensor.experimental import implicit_replication
    from ..distributed.ctx import current_mesh
    counter = OpCounter()
    t0 = time.perf_counter()
    rep = (contextlib.nullcontext() if current_mesh() is not None
           else implicit_replication())
    with rep, counter:
        out = fn(*args, **kwargs)
    counter.totals.peak_rise = counter.peak_rise
    return out, counter.totals, time.perf_counter() - t0


def analyze(totals: Totals) -> dict:
    """The reference's `hlo_analysis.analyze` fields, plus the collectives'
    counts (`parse_collective_bytes`'s)."""
    return {"flops": totals.flops, "bytes": totals.bytes,
            "collective_bytes": sum(totals.coll.values()),
            "collectives": dict(totals.coll),
            "counts": dict(totals.counts)}


class Lowered:
    """A traced program's per-device counts (the reference's lowered and
    compiled object, for what the dry run reads of it)."""

    def __init__(self, totals: Totals, trace_s: float, argument_bytes: int,
                 output_bytes: int):
        self.totals = totals
        self.trace_s = trace_s
        self.argument_bytes = argument_bytes
        self.output_bytes = output_bytes

    def analyze(self) -> dict:
        return analyze(self.totals)


def lower_grid(grid, tasks, hosts, cfg, ci_trace, *, mesh=None, reduce=None):
    """Trace one device's share of a scenario grid on fake tensors: the
    axes' values at their shapes (nothing allocated), the block of
    `lead / devices` leading points a device of `mesh` runs, then the
    all-gather of its result fields.  Tables live on the CPU here."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..core.grid import (_REDUCERS, FleetResult, QuantizedTrace,
                             ScenarioGrid, _lead_devices, _result_map)
    from ..core.state import HostTable, TaskTable

    def host(t):
        return type(t)(*(c.cpu() if isinstance(c, torch.Tensor) else c
                         for c in t))
    tasks, hosts = host(tasks), host(hosts)
    assert isinstance(tasks, TaskTable) and isinstance(hosts, HostTable)
    if isinstance(ci_trace, torch.Tensor):
        ci_trace = ci_trace.cpu()
    mode = FakeTensorMode(allow_non_fake_inputs=True)

    def fake(v):
        if isinstance(v, QuantizedTrace):
            return type(v)(*(fake(x) for x in v))
        if isinstance(v, torch.Tensor):
            return torch.empty(v.shape, dtype=v.dtype)
        return v
    with mode:
        axes = [ax._replace(values=tuple(fake(v) for v in ax.values))
                for ax in grid.axes]
    g = ScenarioGrid(axes, base_dyn=grid.base_dyn)
    ndev = 1 if mesh is None else _lead_devices(mesh)
    blk = max(g._lead // ndev, 1)
    arg_bytes = sum(
        (sum(_nbytes(x) for x in v) if isinstance(v, QuantizedTrace) else
         _nbytes(v) if isinstance(v, torch.Tensor) else 0)
        for v in g.payloads()[0]) // ndev + sum(
        _nbytes(v) for ax in g.axes[1:] for v in ax.values
        if isinstance(v, torch.Tensor))

    def run():
        block = g._with_lead(g.payloads()[0], 0, blk, "cpu")
        return block._chunk(tasks, hosts, cfg, ci_trace, 0, blk, "cpu")
    with mode:
        part, totals, secs = count(run)
        fields = (_tensors(list(part.total) + list(part.per_region))
                  if isinstance(part, FleetResult) else _tensors(list(part)))
        out_bytes = sum(_nbytes(t) for t in fields)
        if ndev > 1:
            totals.note_collective("all-gather", out_bytes * ndev,
                                   n=len(fields))
        if reduce is not None and reduce[1] != 0:
            op, axis = reduce
            shape = (blk, *g.shape[1:])
            _result_map(lambda x: _REDUCERS[op](
                x.reshape(*shape, *x.shape[1:]), dim=axis),
                part.total if isinstance(part, FleetResult) else part)
    return Lowered(totals, secs, int(arg_bytes), int(out_bytes * ndev))
