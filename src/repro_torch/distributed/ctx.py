"""The installed mesh, partition specs and the sharding constraint.

The port of the reference's `distributed/ctx.py`.  Model code annotates
activations with logical specs through `constrain`; with a mesh installed
(`use_mesh`) and more than one device the constraint redistributes the
tensor (a DTensor) to the spec's placements, otherwise it returns the
tensor unchanged, so the same model code runs on one card and on a mesh.
Axis names the installed mesh lacks ("pod" on a single-pod mesh) are
dropped from the spec.

PyTorch has no `PartitionSpec`, so `P` is the port's own: a tuple with
one entry a tensor dimension, each None (replicated), an axis name or a
tuple of axis names (the dimension split over those mesh axes, the first
the major one).  A group of one name stays a tuple, as written.

A mesh is a `torch.distributed.device_mesh.DeviceMesh` with
`mesh_dim_names` (launch/mesh.py builds them).
"""
from __future__ import annotations

import contextlib
import threading

import torch

_state = threading.local()


class P(tuple):
    """A partition spec: `P("data", None)`, `P(("pod", "data"), "model")`."""

    def __new__(cls, *parts):
        return super().__new__(cls, tuple(
            tuple(p) if isinstance(p, list) else p for p in parts))

    def __repr__(self) -> str:
        return "P" + (tuple.__repr__(self) if len(self) != 1
                      else f"({self[0]!r})")


def current_mesh():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Install `mesh` for `constrain`.  With a mesh, a plain tensor that
    meets a DTensor (an `arange`, a mask, positions) is taken as replicated
    on it (DTensor's implicit replication)."""
    prev = current_mesh()
    _state.mesh = mesh
    try:
        if mesh is None:
            yield mesh
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield mesh
    finally:
        _state.mesh = prev


def axis_names(mesh) -> tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(axis_names(mesh), mesh.shape))


def _filter_spec(spec: P, names) -> P:
    """Drop mesh axes the installed mesh does not have."""
    out = []
    for part in spec:
        if part is None:
            out.append(None)
        elif isinstance(part, tuple):
            kept = tuple(a for a in part if a in names)
            out.append(kept if kept else None)
        else:
            out.append(part if part in names else None)
    return P(*out)


def filter_spec(spec: P) -> P:
    mesh = current_mesh()
    if mesh is None:
        return spec
    return _filter_spec(spec, set(axis_names(mesh)))


def placements(spec: P, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: `Shard(i)` on every mesh
    dimension that splits tensor dimension i, `Replicate()` on the rest.
    A dimension split over several mesh axes takes them in mesh order (the
    major axis first), as JAX lays out `P(("pod", "data"))`."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, part in enumerate(_filter_spec(spec, set(names))):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            out[names.index(a)] = Shard(i)
    return tuple(out)


def constrain(x, spec: P):
    """`x` redistributed to `spec` on the installed mesh; `x` itself without
    a mesh or on a mesh of one device.  A plain tensor on a larger mesh is
    taken as replicated on it; a dimension the spec's axes do not divide
    is replicated (DTensor keeps no padded shards)."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    from .sharding import _divisible_spec
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    spec = _divisible_spec(_filter_spec(spec, set(axis_names(mesh))),
                           x.shape, mesh)
    return x.redistribute(mesh, placements(spec, mesh))


def sharding_for(spec: P):
    """The placements of `spec` on the installed mesh (None without one)."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return placements(spec, mesh)


def on_shards(fn, args, specs, out_spec: P, out_shape, partial=()):
    """`fn` over each rank's shards, as JAX's `shard_map` runs a function:
    every DTensor (or plain tensor, taken as replicated) of `args` is laid
    out by its spec in `specs` (None: passed as is), with dimensions that
    the spec's axes do not divide replicated; `fn` gets the local tensors;
    its result is a DTensor of global shape `out_shape` laid out by
    `out_spec`, a partial sum over the mesh axes named in `partial` that
    split an input but not the result.  Without DTensors it is
    `fn(*args)`."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = next((a.device_mesh for a in args if isinstance(a, DTensor)),
                None)
    if mesh is None:
        return fn(*args)
    from .sharding import _divisible_spec
    names = set(axis_names(mesh))
    local, used = [], set()
    for a, s in zip(args, specs):
        if s is None or not isinstance(a, torch.Tensor):
            local.append(a)
            continue
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        pl = placements(_divisible_spec(_filter_spec(s, names), a.shape,
                                        mesh), mesh)
        used |= {i for i, p in enumerate(pl) if p.is_shard()}
        local.append(a.redistribute(mesh, pl))
    opl = list(placements(_divisible_spec(_filter_spec(out_spec, names),
                                          out_shape, mesh), mesh))
    split = used | split_dims(opl)
    local = [local_of(a, split) if isinstance(a, DTensor) else a
             for a in local]
    out = fn(*local).contiguous()
    for a in partial:
        i = axis_names(mesh).index(a) if a in names else None
        if i is not None and i in used and not opl[i].is_shard():
            opl[i] = Partial()
    shape = tuple(out_shape)
    return DTensor.from_local(out, mesh, opl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def attention_layout(q, k, rows: bool):
    """(mesh, q's placements, k's and v's placements) for attention on
    each rank's shards of DTensor q [B, Sq, H, D] and k [B, Sk, KV, D]:
    q keeps its batch split, its row split where `rows`, and its head
    split where that keeps every GQA group whole on one rank; k and v take
    q's batch and head splits, their key axis whole; nothing splits D."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = q.device_mesh
    keep = (0, 1, 2) if rows else (0, 2)
    qp, kvp = [], []
    for i, p in enumerate(q.placements):
        d = p.dim if p.is_shard() else None
        if d == 2 and k.shape[2] % mesh.size(i):
            d = None                      # a GQA group would be split
        qp.append(Shard(d) if d in keep else Replicate())
        kvp.append(Shard(d) if d in (0, 2) else Replicate())
    return mesh, qp, kvp


def to_layout(x, mesh, pl):
    """`x` (a DTensor, or a plain tensor taken as replicated) laid out as
    `pl`."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    return x.redistribute(mesh, pl)


def from_local(out, mesh, pl, shape):
    """A DTensor of global `shape` laid out as `pl` from this rank's
    `out`."""
    from torch.distributed.tensor import DTensor
    shape = tuple(shape)
    return DTensor.from_local(out.contiguous(), mesh, pl, run_check=False,
                              shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def local_of(x, used) -> "torch.Tensor":
    """This rank's shard of DTensor `x` for a computation on shards whose
    other operands or result are split over the mesh dimensions `used`:
    along such a dimension a replicated `x` meets different shards on each
    rank, so its gradient there is a partial sum (`grad_placements`);
    along the others it stays as `x` is laid out."""
    from torch.distributed.tensor import Partial
    grad = [Partial() if (i in used and not p.is_shard()) else p
            for i, p in enumerate(x.placements)]
    return x.to_local(grad_placements=grad)


def split_dims(*layouts) -> set:
    """The mesh dimensions that split any of `layouts` (placement lists)."""
    return {i for pl in layouts for i, p in enumerate(pl)
            if p.is_shard() or p.is_partial()}


def shard_offset(x, dim: int, placements=None) -> int:
    """Where this rank's shard of DTensor `x` starts along tensor dimension
    `dim` (DTensor's chunks, split in mesh order), under `placements`
    (`x`'s own by default)."""
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    off, size = 0, x.shape[dim]
    for i, p in enumerate(placements or x.placements):
        if p == Shard(dim):
            size = -(-size // mesh.size(i))
            off += coord[i] * size
    return off
