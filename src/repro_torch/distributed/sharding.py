"""Spec trees to placements, parameter placement and elastic re-meshing.

The port of the reference's `distributed/sharding.py`.  Specs in model code
name the logical axes ("pod", "data", "model"); every function here drops
the axes the concrete mesh lacks, so one spec tree serves the single-pod
(16, 16) mesh, the multi-pod (2, 16, 16) one and small test meshes.  A
tree is nested dicts, tuples and NamedTuples (`TrainState`, `OptState`)
whose leaves are tensors (meta, fake or real) and whose spec tree has a
`P` where the tree has a tensor (None where it has None).
"""
from __future__ import annotations

import torch

from .ctx import P, _filter_spec, axis_names, axis_sizes, placements


class NamedSharding:
    """A mesh and a spec on it, with the spec's DTensor placements (JAX's
    `NamedSharding`)."""

    def __init__(self, mesh, spec: P):
        self.mesh, self.spec = mesh, spec
        self.placements = placements(spec, mesh)

    def __repr__(self) -> str:
        return f"NamedSharding({self.spec!r}, {self.placements})"


def _is_leaf(x) -> bool:
    return x is None or isinstance(x, (torch.Tensor, P, NamedSharding))


def tree_map(fn, tree, *rest):
    """`fn` on every leaf of `tree` and the leaves at the same places of
    `rest` (trees of the same structure, or `tree`'s prefix of it)."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    items = [tree_map(fn, v, *(r[i] for r in rest))
             for i, v in enumerate(tree)]
    return type(tree)(*items) if hasattr(tree, "_fields") else \
        type(tree)(items)


def tree_leaves(tree) -> list:
    out = []
    tree_map(lambda x: out.append(x), tree)
    return out


def shardings_for(mesh, spec_tree):
    """Spec tree -> tree of NamedShardings on `mesh` (axes it lacks
    dropped)."""
    names = set(axis_names(mesh))
    return tree_map(lambda s: None if s is None else NamedSharding(
        mesh, _filter_spec(s, names)), spec_tree)


def _divisible_spec(spec: P, shape, mesh) -> P:
    """Drop spec axes that do not evenly divide the tensor dimension (a
    batch of 1 over ("pod", "data"), an odd vocab over `model`):
    replicating that dimension is always legal."""
    sizes = axis_sizes(mesh)
    out = []
    for i, part in enumerate(spec):
        if part is None or i >= len(shape):
            out.append(None if i >= len(shape) else part)
            continue
        div = 1
        for a in (part if isinstance(part, tuple) else (part,)):
            div *= sizes.get(a, 1)
        out.append(part if div and shape[i] % div == 0 else None)
    return P(*out)


def shardings_for_shaped(mesh, abstract_tree, spec_tree):
    """Like `shardings_for`, but each dimension that the spec's axes do not
    divide in `abstract_tree`'s shapes is replicated."""
    names = set(axis_names(mesh))

    def one(a, s):
        if a is None:
            return None
        return NamedSharding(mesh, _divisible_spec(_filter_spec(s, names),
                                                   a.shape, mesh))
    return tree_map(one, abstract_tree, spec_tree)


def put(x, sharding: NamedSharding):
    """One tensor as a DTensor laid out by `sharding`.  The rank holds the
    whole tensor and keeps its own shard (no communication), as the
    reference's `device_put` from the host does."""
    from torch.distributed.tensor import distribute_tensor
    if x is None:
        return None
    x = x.detach()
    if x.device.type != sharding.mesh.device_type:
        x = x.to(sharding.mesh.device_type)
    return distribute_tensor(x, sharding.mesh, sharding.placements,
                             src_data_rank=None)


def place(mesh, tree, spec_tree):
    """Every tensor of `tree` as a DTensor on `mesh`, laid out by its spec
    (`put`)."""
    return tree_map(put, tree, shardings_for(mesh, spec_tree))


def remesh(tree, old_mesh, new_mesh, spec_tree):
    """Elastic re-meshing: move a placed tree onto another mesh (another
    device count or layout) through the whole tensors on the host."""
    del old_mesh  # the tensors carry their own mesh
    from torch.distributed.tensor import DTensor

    def host(x):
        if x is None:
            return None
        return (x.full_tensor() if isinstance(x, DTensor) else x).cpu()
    return place(new_mesh, tree_map(host, tree), spec_tree)


def bytes_per_device(tree, mesh, spec_tree) -> int:
    """Bytes a device holds of a spec'd tree (an upper bound: uneven
    shards round up)."""
    sizes = axis_sizes(mesh)
    names = set(sizes)
    total = 0

    def leaf(x, s):
        nonlocal total
        if x is None:
            return
        shape = list(x.shape)
        for i, part in enumerate(_filter_spec(s, names)):
            if part is None:
                continue
            div = 1
            for a in (part if isinstance(part, tuple) else (part,)):
                div *= sizes[a]
            shape[i] = -(-shape[i] // div)
        n = 1
        for d in shape:
            n *= d
        total += n * x.dtype.itemsize
    tree_map(leaf, tree, spec_tree)
    return total
