"""Checkpoints as numpy files (the port of the reference's
`train/checkpoint.py`).

Layout: one directory per step, `step_%08d`, one .npy file per leaf plus a
JSON manifest (names, files, shapes, dtypes, step).  The files are the
interface, shared with the reference: the same leaf names (the reference
names a leaf by its JAX tree path: a NamedTuple field as ".name", a dict
key as itself, a sequence index as its number, joined with "_", so a
`TrainState`'s leaves are ".params_embed_tok", ".opt_.step",
".opt_.m_layers_attn_bq", ...), the same manifest, and bf16 leaves stored
as their uint16 bits with the dtype "bfloat16".  A directory written by
either package restores in the other.

Fault-tolerance contract (used by train/carbon_aware.py): atomic directory
rename on completion, `latest_step()` discovery on restart, and tolerance
of a torn (unrenamed) tmp directory from a crashed writer.

On a mesh: `save` gathers one DTensor leaf at a time, in blocks along an
axis its layout does not split (every rank takes part), and rank 0 copies
each block to the host and into the leaf's file, so no rank holds more
than its shards of the state and one block of one leaf (the reference
streams its leaves to the host one at a time); `restore(...,
shardings=)` places every leaf on the target mesh, each rank reading only
its shard of the file (a tree of `distributed.sharding.NamedSharding`s,
the reference's elastic restore: the same call restores a checkpoint
written on one mesh onto a mesh of another size).
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

def _children(node) -> list | None:
    """(key, child) pairs in the reference's tree order, or None for a
    leaf: a NamedTuple's fields as ".name", a dict's sorted keys, a list's
    or tuple's indices; None holds no leaf."""
    if node is None:
        return []
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f".{f}", getattr(node, f)) for f in node._fields]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), c) for i, c in enumerate(node)]
    return None


def _leaf_paths(tree) -> list:
    """[(name, leaf)] in the reference's flatten order."""
    out = []

    def walk(node, path):
        kids = _children(node)
        if kids is None:
            out.append(("_".join(path), node))
            return
        for k, c in kids:
            walk(c, path + (k,))
    walk(tree, ())
    return out


def _rebuild(like, leaves: list):
    """`like`'s structure with its leaves taken in order from `leaves`."""
    it = iter(leaves)

    def walk(node):
        if node is None:
            return None
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*[walk(getattr(node, f))
                                for f in node._fields])
        if isinstance(node, dict):
            built = {k: walk(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(c) for c in node)
        return next(it)
    return walk(like)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to write, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _group():
    """(rank, world size) of the default process group, (0, 1) without."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# elements of a leaf gathered at once while it is written: beyond its
# shards a card holds at most one such block of the leaf being written
_SAVE_BLOCK = 1 << 26


def _save_blocks(leaf) -> list:
    """(axis, start, length) blocks of at most _SAVE_BLOCK elements that
    cut DTensor `leaf` along its first dimension that no mesh dimension
    splits (a stacked leaf's layer axis); [None] (the whole leaf at once)
    for a small leaf or one split along every dimension."""
    split = {p.dim for p in leaf.placements if p.is_shard()}
    axis = next((i for i in range(leaf.ndim)
                 if i not in split and leaf.shape[i] > 1), None)
    if axis is None or leaf.numel() <= _SAVE_BLOCK:
        return [None]
    n = max(_SAVE_BLOCK // (leaf.numel() // leaf.shape[axis]), 1)
    return [(axis, i, min(n, leaf.shape[axis] - i))
            for i in range(0, leaf.shape[axis], n)]


def _gathered(leaf, block):
    """The whole `block` of DTensor `leaf` (a collective every rank takes
    part in): the block of each rank's shard, gathered."""
    if block is None:
        return leaf.full_tensor()
    from ..distributed.ctx import from_local
    axis, start, n = block
    shape = list(leaf.shape)
    shape[axis] = n
    return from_local(leaf.to_local().narrow(axis, start, n),
                      leaf.device_mesh, leaf.placements, shape).full_tensor()


def _write_leaf(path: str, leaf, rank: int) -> tuple[list, str]:
    """Write one leaf to `path` (.npy) on rank 0; (shape, dtype name).
    A DTensor leaf is gathered a block at a time (`_save_blocks`), every
    rank taking part, and rank 0 copies each block to the host and into
    the file, so neither a card nor the host holds more of it than one
    block."""
    if type(leaf).__name__ != "DTensor":
        arr, dtype = _to_numpy(leaf)
        if rank == 0:
            np.save(path, arr, allow_pickle=False)
        return list(arr.shape), dtype
    blocks = _save_blocks(leaf)
    out, dtype = None, None
    for block in blocks:
        whole = _gathered(leaf, block)
        if rank == 0:
            arr, dtype = _to_numpy(whole)
            if block is None:
                np.save(path, arr, allow_pickle=False)
            else:
                if out is None:
                    out = np.lib.format.open_memmap(
                        path, mode="w+", dtype=arr.dtype,
                        shape=tuple(leaf.shape))
                axis, start, n = block
                out[(slice(None),) * axis + (slice(start, start + n),)] = arr
            del arr
        del whole
    if out is not None:
        out.flush()
        del out
    return list(leaf.shape), dtype


def save(ckpt_dir: str, step: int, state) -> str:
    """Write `state` (a tree of tensors) for `step`.  Atomic via rename.
    Under a process group every rank calls it: each DTensor leaf in turn is
    gathered (a block at a time) and written by rank 0, and all return
    once the directory is in place."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    rank, world = _group()
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)      # torn write from a crashed run
        os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    with torch.no_grad():
        for name, leaf in _leaf_paths(state):
            fname = f"{name}.npy"
            shape, dtype = _write_leaf(os.path.join(tmp, fname), leaf, rank)
            manifest["leaves"].append({"name": name, "file": fname,
                                       "shape": shape, "dtype": dtype})
    if rank == 0:
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    if world > 1:
        import torch.distributed as dist
        dist.barrier()
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, step: int, like, device="cuda", shardings=None):
    """Load into the structure of `like` (a tree of tensors): each leaf in
    its `like` leaf's type, on `device`, requiring grad where that leaf
    does.  `shardings`: a matching tree of NamedShardings
    (`distributed.sharding.shardings_for_shaped`), which places every leaf
    on its mesh as a DTensor (on the mesh's device type) instead, each
    rank reading only its shard of the leaf's file."""
    from ..distributed.ctx import made_on_mesh
    flat_shard = ([s for _, s in _leaf_paths(shardings)]
                  if shardings is not None else None)
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    out = []
    paths = _leaf_paths(like)
    if flat_shard is not None:
        if len(flat_shard) != len(paths):
            raise ValueError(f"{len(flat_shard)} shardings for "
                             f"{len(paths)} leaves")
    for i, (name, leaf) in enumerate(paths):
        meta = by_name[name]
        arr = np.load(os.path.join(d, meta["file"]),
                      mmap_mode=None if flat_shard is None else "r")
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}: checkpoint shape {tuple(arr.shape)} "
                             f"!= expected {tuple(leaf.shape)}")
        if flat_shard is not None:
            s = flat_shard[i]
            t = made_on_mesh(lambda box, a=arr, m=meta: _from_numpy(
                a[tuple(slice(o, o + n) for o, n in box)], m["dtype"]).to(
                    s.mesh.device_type, dtype=leaf.dtype),
                arr.shape, s.spec, s.mesh)
        else:
            t = _from_numpy(arr, meta["dtype"]).to(device=device,
                                                   dtype=leaf.dtype)
        del arr
        out.append(t.requires_grad_(True) if leaf.requires_grad else t)
    return _rebuild(like, out)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A host tensor of a copy of `arr` (read into memory: the file's map
    is read-only), bf16 from its uint16 bits."""
    arr = np.array(arr, order="C")
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def prune(ckpt_dir: str, keep: int = 3):
    """Retain only the most recent `keep` checkpoints."""
    if not os.path.isdir(ckpt_dir):
        return
    dirs = sorted(d for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and not d.endswith(".tmp"))
    for d in dirs[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d))
