"""AdamW over the port's parameter dicts (the port of the reference's
`train/optimizer.py`; plain tensor ops, no `torch.optim`).

Moments are f32 whatever the parameter type; for bf16 parameter trees the
update is computed in f32 and cast back (the f32 moments act as the
high-precision accumulator, so there is no separate master copy).
On a mesh the parameters, gradients and moments are DTensors laid out
alike (`zeros_f32` makes the moments with their parameter's layout), so
each rank updates its own shards: the update is elementwise, and only the
gradient's global norm crosses the ranks.

Numerics as the jitted reference, whose arithmetic XLA rewrites: a
division by a compile-time constant (the schedule's warm-up and decay
lengths) is the product with its f32 reciprocal (`config.inv_f32`); a
multiply feeding an add is one fused multiply-add (the moments' `b * m +
c * g`, the decay's `wd * p + delta`, the step's `p - lr * x`, the
schedule's cosine term), which `_fma` computes as the exact f64 product
plus the addend, rounded once to f32; and `(m / b1c) / d` is `m / (b1c *
d)`.  The bias corrections divide by values that depend on the step and
stay IEEE divisions.  `adamw_update` writes each new parameter and moment
into its tensor in place (the reference's new arrays, the same bits), so
a step keeps no second copy of them; a large leaf is updated a block of
at most _UPDATE_CHUNK elements at a time along its first axis, which
bounds the f64 temporaries of `_fma` and gives the same bits.  The
moments' partition specs (`opt_state_specs`) are their parameters'.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..core.config import inv_f32
from ..models.layers import flatten, tree_map

F32 = torch.float32
# elements of a leaf updated at once: the f64 temporaries of a block are
# 1 GiB each (an expert stack is 10^9 elements a card)
_UPDATE_CHUNK = 1 << 27


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: torch.Tensor       # int32, 0-d
    m: dict
    v: dict


def zeros_f32(params: dict) -> dict:
    """Zero f32 tensors laid out as `params`: on the parameter's device,
    and for a DTensor parameter a DTensor with its placements (each rank
    allocating only its shard), as the reference's zeros come out under
    jit with the state's shardings."""
    return tree_map(lambda p: torch.zeros_like(
        p, dtype=F32, memory_format=torch.contiguous_format), params)


def init_opt_state(params: dict) -> OptState:
    """Step 0 and zero f32 moments laid out as the parameters."""
    leaf = next(iter(flatten(params).values()))
    return OptState(step=torch.zeros((), dtype=torch.int32,
                                     device=leaf.device),
                    m=zeros_f32(params), v=zeros_f32(params))


def opt_state_specs(param_spec_tree) -> OptState:
    """The partition-spec tree of OptState: the moments laid out as the
    parameters, the step replicated."""
    from ..distributed.ctx import P
    return OptState(step=P(), m=param_spec_tree,
                    v=tree_map(lambda s: s, param_spec_tree))


def _f32(x: float) -> np.float32:
    """A Python number as the f32 constant the reference's weak typing
    makes of it."""
    return np.float32(x)


def _fma(a, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32, as a fused multiply-add: `a` an f32
    tensor, `b` an f32 value (a number or a 0-d tensor), `c` f32.  The
    product of two f32 values is exact in f64."""
    t = a.double()
    t.mul_(b.double() if isinstance(b, torch.Tensor) else float(b))
    return t.add_(c).to(F32)


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_frac (f32, 0-d, on the step's
    device)."""
    s = step.to(F32)
    warm = s * inv_f32(max(cfg.warmup_steps, 1))
    prog = torch.clamp((s - _f32(cfg.warmup_steps))
                       * inv_f32(max(cfg.total_steps - cfg.warmup_steps, 1)),
                       0, 1)
    cos = _fma(1 + torch.cos(_f32(math.pi) * prog),
               _f32((1 - cfg.min_lr_frac) * 0.5), float(_f32(cfg.min_lr_frac)))
    return _f32(cfg.lr) * torch.minimum(warm, cos)


def _leaves(tree: dict) -> list:
    """Leaves in the reference's tree order (sorted key paths)."""
    return [t for _, t in sorted(flatten(tree).items())]


def global_norm(tree: dict) -> torch.Tensor:
    total = 0
    for x in _leaves(tree):
        total = total + torch.sum(torch.square(x.to(F32)))
    return torch.sqrt(total)


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(_f32(max_norm) / torch.clamp(norm, min=_f32(1e-9)),
                       max=1.0)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most `max_norm`, the norm)."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def _local(x) -> torch.Tensor:
    """This rank's shard of a DTensor (a replicated one: the whole value),
    the tensor itself otherwise; under no_grad, the shard's own storage."""
    return x.to_local() if type(x).__name__ == "DTensor" else x


def _blocks(t: torch.Tensor) -> list:
    """Slices of `t`'s first axis of at most _UPDATE_CHUNK elements (one
    row at least); the whole tensor when it is small."""
    if t.dim() == 0 or t.numel() <= _UPDATE_CHUNK:
        return [slice(None)]
    rows = max(_UPDATE_CHUNK // (t.numel() // t.shape[0]), 1)
    return [slice(i, i + rows) for i in range(0, t.shape[0], rows)]


def adamw_update(cfg: AdamWConfig, params: dict, grads: dict,
                 state: OptState):
    """Returns (params, new state, metrics {grad_norm, lr}); the parameter
    and moment tensors are updated in place.  Each gradient leaf is clipped
    as it is used (`clip_by_global_norm`'s bits, without a clipped copy of
    the whole tree).  A DTensor leaf's gradient and moments must be laid
    out as the parameter (`step.value_and_grad` gives such gradients): the
    update runs on each rank's shards."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    sf = step.to(F32)
    b1c = 1 - torch.pow(_f32(cfg.b1), sf)
    b2c = 1 - torch.pow(_f32(cfg.b2), sf)
    b1, c1 = _f32(cfg.b1), _f32(1 - cfg.b1)
    b2, c2 = _f32(cfg.b2), _f32(1 - cfg.b2)
    wd, eps = _f32(cfg.weight_decay), _f32(cfg.eps)
    # the scalars every rank holds whole
    scale_l, lr_l, b1c_l, b2c_l = (_local(x) for x in (scale, lr, b1c, b2c))
    flat_g, flat_m, flat_v = flatten(grads), flatten(state.m), flatten(
        state.v)
    with torch.no_grad():
        for path, p in flatten(params).items():
            ts = (p, flat_g[path], flat_m[path], flat_v[path])
            if type(p).__name__ == "DTensor" and any(
                    t.placements != p.placements for t in ts[1:]):
                raise ValueError(f"adamw_update {path}: gradient or moments "
                                 f"not laid out as the parameter "
                                 f"({[t.placements for t in ts]})")
            pl, gl, ml, vl = (_local(t) for t in ts)
            for sl in _blocks(pl):
                g = gl[sl]
                g = (g * scale_l.to(g.dtype)).to(F32)
                m, v = ml[sl], vl[sl]
                m.copy_(_fma(m, b1, c1 * g))
                v.copy_(_fma(v, b2, c2 * g * g))
                pf = pl[sl].to(F32)
                x = m / (b1c_l * (torch.sqrt(v / b2c_l) + eps))
                if p.ndim >= 2:             # decay on matrices only
                    x = _fma(pf, wd, x)
                pl[sl].copy_(_fma(x, -lr_l, pf).to(p.dtype))
    return params, OptState(step, state.m, state.v), {"grad_norm": gnorm,
                                                      "lr": lr}
