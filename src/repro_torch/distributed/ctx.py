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
import math
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
    """Install `mesh` for `constrain` in this thread.  With a mesh, a plain
    tensor that meets a DTensor (an `arange`, a mask, positions) is taken
    as replicated on it: DTensor's implicit replication is turned on, and
    on leaving set back to what the block found (`implicit_replication()`
    turns it off, under an enclosing block too)."""
    prev = current_mesh()
    _state.mesh = mesh
    disp = None
    if mesh is not None:
        from torch.distributed.tensor import DTensor
        disp = DTensor._op_dispatcher
        found = disp._allow_implicit_replication
        disp._allow_implicit_replication = True
    try:
        yield mesh
    finally:
        _state.mesh = prev
        if disp is not None:
            disp._allow_implicit_replication = found


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
    major axis first), as JAX lays out `P(("pod", "data"))`.  A mesh
    dimension of size 1 splits nothing: `Replicate()` (DTensor would keep
    a tensor dimension "split" one way that no reshape may then merge)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    out = [Replicate()] * len(names)
    for i, part in enumerate(_filter_spec(spec, set(names))):
        if part is None:
            continue
        for a in (part if isinstance(part, tuple) else (part,)):
            if mesh.shape[names.index(a)] > 1:
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


def on_attention_shards(fn, q, k, v):
    """`fn(q, k, v)` on each rank's shards of DTensors q [B, Sq, H, D] and
    k / v [B, Sk, KV, *] (`attention_layout`: q's batch and head
    splits kept, a GQA group never split, the keys whole on every rank),
    as a DTensor laid out as q of width fn's.  The attention of one rank's
    heads needs no other rank's, so DTensor's rules for the products and
    the softmax over a split key axis, which differ between PyTorch
    releases, are not needed.  Without DTensors it is `fn(q, k, v)`."""
    from torch.distributed.tensor import DTensor
    if not isinstance(q, DTensor):
        return fn(q, k, v)
    mesh, qp, kvp = attention_layout(q, k, rows=False)
    out = fn(to_layout(q, mesh, qp).to_local(),
             to_layout(k, mesh, kvp).to_local(),
             to_layout(v, mesh, kvp).to_local())
    return from_local(out, mesh, qp, (*q.shape[:3], out.shape[-1]))


def on_key_shards(fn, qs, kvs):
    """Attention of queries `qs` (tensors [B, Sq, H, *]) over a decode
    cache `kvs` (tensors [B, Sk, *] laid out alike, the key positions on
    dimension 1) on each rank's shards, the cache left as it is laid out:
    `fn(qs, kvs, start)` gives (out [B, Sq, H, Dv], its masked f32 logits
    [B, Sq, H, s]) over local keys whose first is at position `start`.
    The queries (gathered as one tensor) take the cache's batch split and,
    where the cache has a head axis ([B, Sk, KV, *]) and every rank keeps
    whole GQA groups, its head split; on the mesh dimensions that split
    the key positions the queries are whole, and one all-gather of every
    rank's output and logsumexp gives each rank their combination, so no
    rank gathers the cache.  DTensor's rules for the products and the
    softmax over a split key axis, which differ between PyTorch releases,
    are not needed.  Without DTensors it is fn's out."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    q, k = qs[0], kvs[0]
    if not isinstance(q, DTensor):
        return fn(qs, kvs, 0)[0]
    mesh = q.device_mesh
    kpl = k.placements if isinstance(k, DTensor) else \
        [Replicate()] * mesh.ndim
    heads = all(t.dim() == 4 for t in kvs)
    qp, kvp, seq = [], [], []
    for i, (a, b) in enumerate(zip(kpl, q.placements)):
        if a == Shard(1):
            seq.append(i)
            qp.append(Replicate())
            kvp.append(a)
        elif Shard(0) in (a, b):
            qp.append(Shard(0))
            kvp.append(Shard(0))
        elif heads and Shard(2) in (a, b) and k.shape[2] % mesh.size(i) == 0:
            qp.append(Shard(2))
            kvp.append(Shard(2))
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
    start = shard_box(k.shape, kvp, mesh)[1][0]
    widths = [t.shape[-1] for t in qs]
    ql = to_layout(torch.cat(qs, dim=-1) if len(qs) > 1 else q, mesh,
                   qp).to_local()
    out, logits = fn(tuple(torch.split(ql, widths, dim=-1)),
                     tuple(to_layout(t, mesh, kvp).to_local() for t in kvs),
                     start)
    shape = (*q.shape[:3], out.shape[-1])
    if not seq:
        return from_local(out, mesh, qp, shape)
    # every rank's (output, logsumexp) [n, B, Sq, H, Dv + 1], n the ranks
    # over the position split, combined alike on each
    lse = torch.logsumexp(logits, dim=-1)[..., None]
    part = torch.cat([out.float(), lse], dim=-1)[None]
    pl = [Shard(p.dim + 1) if p.is_shard() else p for p in qp]
    n = math.prod(mesh.size(i) for i in seq)
    every = from_local(part, mesh, [Shard(0) if i in seq else p
                                    for i, p in enumerate(pl)],
                       (n, *shape[:3], shape[3] + 1))
    every = every.redistribute(mesh, pl).to_local()
    lse = every[..., -1]
    w = torch.exp(lse - lse.amax(dim=0))
    comb = (every[..., :-1] * w[..., None]).sum(0) / w.sum(0)[..., None]
    return from_local(comb.to(out.dtype), mesh, qp, shape)


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


def shard_box(shape, pl, mesh) -> list[tuple[int, int]]:
    """(start, length) along each dimension of this rank's shard of a
    tensor of global `shape` laid out as `pl` on `mesh`: DTensor's chunks
    (`torch.chunk`'s sizes, the last ones short or empty where a dimension
    does not divide), a dimension split over several mesh dimensions in
    mesh order."""
    box = [[0, n] for n in shape]
    coord = mesh.get_coordinate()
    for i, p in enumerate(pl):
        if p.is_shard():
            off, n = box[p.dim]
            size = -(-n // mesh.size(i))
            start = min(coord[i] * size, n)
            box[p.dim] = [off + start, min(size, n - start)]
    return [tuple(b) for b in box]


def made_on_mesh(make, shape, spec: P, mesh):
    """A DTensor of global `shape` laid out by `spec` on `mesh` (axes it
    lacks dropped), of which this rank makes only its shard:
    `make(box)`, `box` the shard's (start, length) a dimension
    (`shard_box`)."""
    pl = placements(spec, mesh)
    return from_local(make(shard_box(shape, pl, mesh)), mesh, pl, shape)


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
