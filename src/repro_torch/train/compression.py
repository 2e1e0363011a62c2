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

import torch
import torch.nn.functional as F

from ..core.config import inv_f32
from ..models.layers import flatten, tree_map, unflatten
from .optimizer import zeros_f32

BLOCK = 128
F32 = torch.float32


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


def apply_error_feedback(grads: dict, ef_state: dict):
    """grads += residual; compressed := Q(grads); residual := grads -
    compressed.  Returns (compressed grads, new ef state); `ef_state` is a
    tree of f32 residuals matching grads (zeros at init).

    The jitted reference fuses the residual's dequantising product and its
    difference into one multiply-add, so the residual is `corrected - q *
    scale` rounded once: computed here in f64, where the product of an
    int8 and an f32 is exact."""
    flat_e = flatten(ef_state)
    sent, resid = {}, {}
    for path, g in flatten(grads).items():
        corrected = g.to(F32) + flat_e[path]
        q, scale, meta = quantize_int8(corrected)
        sent[path] = dequantize_int8(q, scale, meta, g.dtype)
        flat, pad = _pad_to(corrected, BLOCK)
        r = (flat.reshape(-1, BLOCK).double()
             - q.double() * scale.double()).to(F32).reshape(-1)
        resid[path] = (r[:-pad] if pad else r).reshape(corrected.shape)
    return unflatten(sent), unflatten(resid)


def init_ef_state(params: dict) -> dict:
    """Zero f32 residuals laid out as `params` (`optimizer.zeros_f32`)."""
    return zeros_f32(params)


def cross_pod_allreduce_compressed(grads, mesh):
    """The gradients' mean over the mesh's `pod` axis, each leaf quantised
    to int8 and decoded first (the reference's explicit compressed
    all-reduce); the identity without a `pod` axis.  A leaf is this rank's
    tensor (a DTensor's local shard: gradients are replicated across pods
    here), and keeps its type."""
    names = tuple(mesh.mesh_dim_names or ())
    if "pod" not in names:
        return grads
    import torch.distributed as dist
    group = mesh.get_group(names.index("pod"))
    npod = mesh.shape[names.index("pod")]

    def reduce_leaf(g):
        dt = type(g).__name__ == "DTensor"
        local = g.to_local() if dt else g
        q, s, meta = quantize_int8(local)
        deq = dequantize_int8(q, s, meta, F32)
        dist.all_reduce(deq, op=dist.ReduceOp.SUM, group=group)
        out = (deq * inv_f32(npod)).to(local.dtype)
        if dt:
            from torch.distributed.tensor import DTensor
            return DTensor.from_local(out, g.device_mesh, g.placements,
                                      run_check=False, shape=g.shape,
                                      stride=g.stride())
        return out
    return tree_map(reduce_leaf, grads)
