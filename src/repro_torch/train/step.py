"""Train-step construction: loss -> grads -> (optional compression) -> AdamW
(the port of the reference's `train/step.py`).

`make_train_step(model, tcfg)` returns a (state, batch) -> (state, metrics)
function.  Value and gradients come from `torch.autograd` through the
model's loss, which is its plain path: no kernel runs in a step (the
kernels have no backward, and the reference trains on its jnp paths).
Parameters are leaves that require grad; the optimizer updates them, and
its moments, in place under `torch.no_grad()`.  The dry run's abstract
state (`abstract_train_state`: tensors with no values) and its partition
specs (`train_state_specs`) are the reference's.

On a mesh (`launch/mesh.py`) the state is DTensors laid out by
`train_state_specs` (`init_train_state(..., mesh=)` draws each rank's
shards; moments, residuals and the accumulator are made with their
parameter's layout) and the batch is split over ("pod", "data"); the step
runs under `ctx.use_mesh(mesh)`.  Autograd runs through the losses' plain
paths on DTensors (attention and the MoE's dispatch on each rank's
shards), and every gradient is then laid out as its parameter
(`laid_out_as`): a partial sum over `data` (a parameter replicated there)
is all-reduced, one over an FSDP split reduce-scattered.  AdamW then
updates each rank's shards.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from ..core import telemetry
from ..core.config import inv_f32
from ..models.layers import flatten, tree_map, unflatten
from ..models.registry import Model
from . import compression
from .optimizer import AdamWConfig, OptState, adamw_update, init_opt_state, \
    opt_state_specs, zeros_f32

F32 = torch.float32


@dataclass(frozen=True)
class TrainConfig:
    opt: AdamWConfig = field(default_factory=AdamWConfig)
    grad_compression: bool = False   # int8 + error feedback (cross-pod DCN)
    microbatches: int = 1            # gradient accumulation: peak-activation
                                     # memory / microbatches


class TrainState(NamedTuple):
    params: dict
    opt: OptState
    ef: dict | None    # error-feedback residuals (None unless compressing)


def trainable(params: dict) -> dict:
    """`params` with every leaf requiring grad (in place)."""
    return tree_map(lambda p: p.requires_grad_(True), params)


def new_train_state(params: dict, tcfg: TrainConfig) -> TrainState:
    """A step-0 state around `params` (made trainable): zero moments, and
    zero error-feedback residuals when compressing."""
    params = trainable(params)
    return TrainState(
        params=params, opt=init_opt_state(params),
        ef=compression.init_ef_state(params) if tcfg.grad_compression
        else None)


def init_train_state(model: Model, generator: torch.Generator,
                     tcfg: TrainConfig, device="cuda",
                     mesh=None) -> TrainState:
    """Random parameters from `generator` (which lives on `device`) and a
    step-0 optimizer state.  With `mesh`, DTensors laid out by
    `train_state_specs`, each rank drawing only its shards of the
    parameters (`Model.init(..., mesh=)`: the slices of the same draws
    without a mesh) and allocating only its shards of the moments."""
    return new_train_state(model.init(generator, device=device, mesh=mesh),
                           tcfg)


def abstract_train_state(model: Model, tcfg: TrainConfig,
                         device="meta") -> TrainState:
    """The TrainState as tensors with no values (meta, or fake under a
    `FakeTensorMode` with device "cpu"): parameters in their dtype, f32
    moments and residuals, an i32 step."""
    params = model.abstract_params(device)
    f32 = lambda p: torch.empty(p.shape, dtype=F32, device=device)  # noqa: E731,E501
    return TrainState(
        params=params,
        opt=OptState(step=torch.empty((), dtype=torch.int32, device=device),
                     m=tree_map(f32, params), v=tree_map(f32, params)),
        ef=tree_map(f32, params) if tcfg.grad_compression else None)


def train_state_specs(model: Model, tcfg: TrainConfig) -> TrainState:
    """The partition-spec tree of the TrainState: moments and residuals
    laid out as their parameters."""
    pspecs = model.param_specs()
    return TrainState(
        params=pspecs, opt=opt_state_specs(pspecs),
        ef=tree_map(lambda s: s, pspecs) if tcfg.grad_compression else None)


def laid_out_as(g, p):
    """Gradient `g` in its parameter `p`'s layout: for DTensors, `g`
    redistributed to `p`'s placements (a partial sum reduced: all-reduced
    where `p` is replicated, reduce-scattered where it is split); plain
    tensors as they are."""
    if type(p).__name__ != "DTensor" or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def value_and_grad(model: Model, params: dict, batch: dict):
    """(loss, gradient tree) of `model.loss` at `params`; on a mesh each
    gradient laid out as its parameter (`laid_out_as`)."""
    paths, leaves = zip(*sorted(flatten(params).items()))
    if not all(p.requires_grad for p in leaves):
        raise ValueError("train step: every parameter must require grad "
                         "(init_train_state / new_train_state make them so)")
    with torch.enable_grad():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    grads = [laid_out_as(g, p) for g, p in zip(grads, leaves)]
    return loss.detach(), unflatten(dict(zip(paths, grads)))


def microbatch(x, i: int, mb: int):
    """Rows [i B / mb, (i + 1) B / mb) of batch leaf `x` [B, ...] (the
    reference's split).  A DTensor leaf (its rows split over ("pod",
    "data")) is gathered whole, a batch of token ids being small, and the
    slice laid out as `x` again, each rank keeping its rows of it."""
    n = x.shape[0] // mb
    if type(x).__name__ != "DTensor":
        return x[i * n:(i + 1) * n]
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(x.full_tensor()[i * n:(i + 1) * n],
                             x.device_mesh, x.placements, src_data_rank=None)


def make_train_step(model: Model, tcfg: TrainConfig):
    mb = max(tcfg.microbatches, 1)

    def train_step(state: TrainState, batch: dict):
        if mb == 1:
            loss, grads = value_and_grad(model, state.params, batch)
        else:
            # gradient accumulation over microbatch slices (the reference's
            # scan): each microbatch's activations are released before the
            # next; the f32 accumulator adds one params-sized buffer
            acc = zeros_f32(state.params)
            loss_sum = torch.zeros((), dtype=F32,
                                   device=state.opt.step.device)
            flat_acc = flatten(acc)
            for i in range(mb):
                loss, grads = value_and_grad(
                    model, state.params,
                    {k: microbatch(v, i, mb) for k, v in batch.items()})
                for path, g in flatten(grads).items():
                    flat_acc[path].add_(g.to(F32))
                del grads
                loss_sum = loss_sum + loss
            grads = tree_map(lambda a: a.mul_(inv_f32(mb)), acc)
            loss = loss_sum * inv_f32(mb)
        ef = state.ef
        if tcfg.grad_compression:
            grads, ef = compression.apply_error_feedback(grads, ef)
        with telemetry.stage_scope("optimizer", state.opt.step.device):
            params, opt, metrics = adamw_update(tcfg.opt, state.params,
                                                grads, state.opt)
        return TrainState(params, opt, ef), dict(metrics, loss=loss)

    return train_step


def make_eval_step(model: Model):
    """(params, batch) -> the loss, without gradients."""
    def eval_step(params, batch):
        with torch.no_grad():
            return model.loss(params, batch)
    return eval_step
