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
    opt_state_specs

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
                     tcfg: TrainConfig, device="cuda") -> TrainState:
    """Random parameters from `generator` (which lives on `device`) and a
    step-0 optimizer state."""
    return new_train_state(model.init(generator, device=device), tcfg)


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


def value_and_grad(model: Model, params: dict, batch: dict):
    """(loss, gradient tree) of `model.loss` at `params`."""
    paths, leaves = zip(*sorted(flatten(params).items()))
    if not all(p.requires_grad for p in leaves):
        raise ValueError("train step: every parameter must require grad "
                         "(init_train_state / new_train_state make them so)")
    with torch.enable_grad():
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), unflatten(dict(zip(paths, grads)))


def make_train_step(model: Model, tcfg: TrainConfig):
    mb = max(tcfg.microbatches, 1)

    def train_step(state: TrainState, batch: dict):
        if mb == 1:
            loss, grads = value_and_grad(model, state.params, batch)
        else:
            # gradient accumulation over microbatch slices (the reference's
            # scan): each microbatch's activations are released before the
            # next; the f32 accumulator adds one params-sized buffer
            split = {k: v.reshape((mb, v.shape[0] // mb) + v.shape[1:])
                     for k, v in batch.items()}
            dev = state.opt.step.device
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                 device=dev), state.params)
            loss_sum = torch.zeros((), dtype=F32, device=dev)
            flat_acc = flatten(acc)
            for i in range(mb):
                loss, grads = value_and_grad(
                    model, state.params, {k: v[i] for k, v in split.items()})
                for path, g in flatten(grads).items():
                    flat_acc[path].add_(g.to(F32))
                loss_sum = loss_sum + loss
            grads = tree_map(lambda a: a * inv_f32(mb), acc)
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
