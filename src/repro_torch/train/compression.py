"""Gradient compression: int8 block quantisation with error feedback (the
port of the reference's `train/compression.py`).

Per-block (128-lane) absmax scaling, and an error-feedback accumulator that
carries the quantisation residual into the next step.  On one device the
compressed path is a quantise / dequantise round trip of each gradient
leaf (the numerics of the wire format); on a mesh with a `pod` axis
`cross_pod_allreduce_compressed` averages the round-tripped gradients
over the pods (the all-reduce of the decoded f32 values: the int8 payload
is what would cross the hosts' network).

The block scale is max|x| times the f32 reciprocal of 127, as the jitted
reference computes its division by the constant (`config.inv_f32`).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.config import inv_f32
from ..models.layers import flatten, tree_map, unflatten
from .optimizer import zeros_f32

BLOCK = 128
F32 = torch.float32
# elements of a leaf quantised at once in `apply_error_feedback` (bounds
# its f64 temporaries, 1 GiB each)
_CHUNK = 1 << 27


def _pad_to(x, mult: int):
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % mult
    return F.pad(flat, (0, pad)), pad


def quantize_int8(g):
    """g: any-shape float -> (q int8 [N/B, B], scale f32 [N/B, 1], meta)."""
    flat, pad = _pad_to(g.to(F32), BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.amax(torch.abs(blocks), dim=1, keepdim=True) * inv_f32(127)
    scale = torch.clamp(scale, min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, (tuple(g.shape), pad)


def dequantize_int8(q, scale, meta, dtype):
    shape, pad = meta
    flat = (q.to(F32) * scale).reshape(-1)
    if pad:
        flat = flat[:-pad]
    return flat.reshape(shape).to(dtype)


def compress_roundtrip(g):
    """Quantise + dequantise one leaf (the wire format's numerics)."""
    q, s, meta = quantize_int8(g)
    return dequantize_int8(q, s, meta, g.dtype)


def _feedback(g, e):
    """(sent, residual) of plain tensors: `g` plus residual `e`, quantised
    and decoded in blocks of BLOCK, and what the quantisation lost.  The
    blocks are taken a chunk of _CHUNK elements at a time (the same bits:
    each block is quantised alone), which bounds the f64 temporaries."""
    corrected = g.to(F32) + e
    flat, pad = _pad_to(corrected, BLOCK)
    blocks = flat.reshape(-1, BLOCK)
    sent, resid = torch.empty_like(blocks), torch.empty_like(blocks)
    rows = max(_CHUNK // BLOCK, 1)
    for i in range(0, blocks.shape[0], rows):
        b = blocks[i:i + rows]
        q, scale, _ = quantize_int8(b)
        sent[i:i + rows] = q.to(F32) * scale
        resid[i:i + rows] = (b.double()
                             - q.double() * scale.double()).to(F32)
    n = corrected.numel()
    return (sent.reshape(-1)[:n].reshape(corrected.shape).to(g.dtype),
            resid.reshape(-1)[:n].reshape(corrected.shape))


def _split_ways(placements, mesh_shape) -> dict:
    """{tensor dimension: the number of shards along it} of `placements`
    on a mesh of `mesh_shape` (a mesh dimension of size 1 splits
    nothing)."""
    ways: dict = {}
    for p, n in zip(placements, mesh_shape):
        if p.is_shard() and n > 1:
            ways[p.dim] = ways.get(p.dim, 1) * n
    return ways


def blocks_aligned(shape, placements, mesh_shape) -> bool:
    """Whether every block of BLOCK consecutive elements of the global
    row-major flattening of a tensor of `shape` (its tail zero-padded)
    lies whole inside one shard under `placements`, at a multiple of BLOCK
    of the shard's own flattening, so that each rank may quantise its
    local shard alone.  With j the innermost split dimension, l_j its
    local extent and s the product of the dimensions after it: each
    shard is runs of l_j x s consecutive global elements starting at
    multiples of l_j x s, so the condition is that l_j x s is a multiple of
    BLOCK.  An uneven split of j (its last shard shorter) counts as not
    aligned."""
    ways = _split_ways(placements, mesh_shape)
    if not ways:
        return True
    j = max(ways)
    if shape[j] % ways[j]:
        return False
    return (shape[j] // ways[j]) * math.prod(shape[j + 1:]) % BLOCK == 0


def block_placements(shape, placements, mesh_shape) -> tuple:
    """`placements` with the innermost split dimension replicated, then
    the next, until the blocks are aligned (`blocks_aligned`): the layout
    in which a rank quantises its shard alone, gathering a leaf only as
    far as its blocks need."""
    from torch.distributed.tensor import Replicate
    pl = tuple(placements)
    while not blocks_aligned(shape, pl, mesh_shape):
        j = max(_split_ways(pl, mesh_shape))
        pl = tuple(Replicate() if p.is_shard() and p.dim == j else p
                   for p in pl)
    return pl


def _on_blocks(fn, g, *rest, pod: int | None = None):
    """`fn` (plain tensors -> a tuple of tensors shaped as `g`) over the
    leaf `g` and the leaves `rest`.  For a DTensor `g`: each is laid out
    by `block_placements` of `g`'s placements with the mesh dimension
    `pod` (where given) replicated, `fn` runs on the local shards, and
    each result is laid out as `g` again (a gradient holds no partial
    sum: `step.value_and_grad` lays it out as its parameter)."""
    if type(g).__name__ != "DTensor":
        return fn(g, *rest)
    from torch.distributed.tensor import Replicate
    from ..distributed.ctx import from_local, to_layout
    mesh = g.device_mesh
    pl = tuple(Replicate() if i == pod else p
               for i, p in enumerate(g.placements))
    pl = block_placements(g.shape, pl, tuple(mesh.shape))
    local = [to_layout(x, mesh, pl).to_local() for x in (g, *rest)]
    return tuple(from_local(o, mesh, pl, g.shape).redistribute(
        mesh, g.placements) for o in fn(*local))


def apply_error_feedback(grads: dict, ef_state: dict):
    """grads += residual; compressed := Q(grads); residual := grads -
    compressed.  Returns (compressed grads, new ef state); `ef_state` is a
    tree of f32 residuals matching grads (zeros at init).

    The jitted reference fuses the residual's dequantising product and its
    difference into one multiply-add, so the residual is `corrected - q *
    scale` rounded once: computed here in f64, where the product of an
    int8 and an f32 is exact.

    On a mesh (DTensor leaves) the blocks are the reference's, those of
    the whole leaf's row-major flattening: a rank quantises its shard
    alone where every block lies inside one shard (`blocks_aligned`), and
    otherwise the leaf is gathered only along the dimensions the blocks
    need (`block_placements`); the compressed gradient and the residual
    come out laid out as the gradient (its parameter's placements)."""
    flat_e = flatten(ef_state)
    sent, resid = {}, {}
    with torch.no_grad():
        for path, g in flatten(grads).items():
            sent[path], resid[path] = _on_blocks(_feedback, g, flat_e[path])
    return unflatten(sent), unflatten(resid)


def init_ef_state(params: dict) -> dict:
    """Zero f32 residuals laid out as `params` (`optimizer.zeros_f32`)."""
    return zeros_f32(params)


def cross_pod_allreduce_compressed(grads, mesh):
    """The gradients' mean over the mesh's `pod` axis, each leaf quantised
    to int8 and decoded first (the reference's explicit compressed
    all-reduce, which quantises each leaf whole); the identity without a
    `pod` axis.  A plain leaf is this rank's tensor; a DTensor leaf is
    quantised in the whole leaf's blocks on each rank's shard, laid out as
    for `apply_error_feedback` and replicated over `pod`, and comes out
    laid out as it came in.  The all-reduce runs over the `pod` group
    only."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        return grads
    import torch.distributed as dist
    pod = names.index("pod")
    group = mesh.get_group(pod)
    npod = mesh.shape[pod]

    def reduce_local(local):
        deq = compress_roundtrip(local.to(F32))
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        return ((deq * inv_f32(npod)).to(local.dtype),)

    with torch.no_grad():
        return tree_map(lambda g: _on_blocks(reduce_local, g, pod=pod)[0],
                        grads)
