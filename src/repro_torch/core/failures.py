"""Host failures and checkpointing (paper §VI-A2).

Failures follow the reference's memoryless model: each step an up,
provisioned host fails with probability ``1 - exp(-hazard * dt / mtbf)``
and comes back `repair_h` later.  Tasks running on a host that fails are
requeued; with checkpointing they resume from their last snapshot (every
`checkpoint_interval_h`), otherwise from scratch, and the work redone is
counted per task (the mechanism behind the paper's finding F1: failures
erode the carbon savings of down-scaling).

The draws are the reference's threefry bits (core/threefry.py): each step
takes `rng, k_fail = split(rng)` and `bernoulli(k_fail, p_fail, [H])`.
Neither the keys nor the failure probability depend on the simulation
state, so the engine draws every step's [H] flags before the loop
(`draw_host_failures`, one [S, B, H] bool tensor) and each step applies its
slice (`host_failure_transition`); `step_host_failures` is the reference's
one-step form of the same draw.

`u < p_fail` is exact only for a bit-equal `p_fail`.  The reference
computes its exponential with XLA's CPU polynomial (a Cephes range
reduction and degree-6 polynomial in fused multiply-adds); `exp_f32` is
that polynomial, each fused multiply-add taken as an exact product and sum
in f64 rounded once to f32, so the same `p_fail` comes out on the CPU and
on the card.  (Where the reference's exponent is a compile-time constant,
XLA folds the exponential with the host's libm `expf` instead; see
`failure_probability`.)
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry
from .config import FailureConfig
from .state import PENDING, RUNNING, HostTable, TaskTable

F32 = torch.float32
F64 = torch.float64

# XLA's CPU exp (Cephes): range reduction by ln 2 in two parts, then a
# degree-6 polynomial of the remainder
_LOG2E = np.float32(1.44269504088896341)
_LN2_HI = np.float32(0.693359375)
_LN2_LO = np.float32(-2.12194440e-4)
_EXP_POLY = tuple(np.float32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))


def _f64(x):
    return x.to(F64) if isinstance(x, torch.Tensor) else float(x)


def _fma(a, b, c):
    """f32 fused multiply-add: the f32 product is exact in f64, and the sum
    rounds once to f64 and again to f32 (the two roundings differ from one
    only at an f32 halfway point, met by none of 8M inputs checked)."""
    return (_f64(a) * _f64(b) + _f64(c)).to(F32)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    """exp of an f32 tensor as the reference's compiled XLA CPU code
    computes it, bit for bit on any device for |x| <= 87 (outside, XLA
    treats subnormal and overflowing results its own way; below -87,
    `1 - exp(x)` is 1.0 either way)."""
    x = torch.clamp(x.to(F32), -87.8, 88.8)
    n = torch.floor(_fma(x, _LOG2E, np.float32(0.5)))
    r = _fma(n, -_LN2_HI, x)
    r = _fma(n, -_LN2_LO, r)
    z = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma(z, r, c)
    z = _fma(z, r * r, r)
    z = 1.0 + z
    pow2 = ((n.to(torch.int32) + 127) << 23).view(F32)
    return z * pow2


def failure_probability(hazard, dt_h: float, mtbf_h: float) -> torch.Tensor:
    """f32 per-step failure probability ``1 - exp(-hazard * dt / mtbf)``
    in the reference's f32 steps; `hazard` None is the baseline
    ``1 - exp(-dt / mtbf)``, a tensor or host number gives its shape.

    XLA folds an exponential whose argument is a compile-time constant
    with libm's `expf` (error under 0.502 ulp) rather than this polynomial,
    so where the reference's hazard is constant in its compiled program --
    no hazard (failures without resilience), or a heat multiplier of 0
    with an unswept `failure_hazard_scale` -- its probability can sit one
    ulp from this one; a draw then differs with probability 2^-23."""
    c = np.float32(dt_h / mtbf_h)
    if hazard is None:
        x = torch.tensor(-c)
    else:
        h = (hazard if isinstance(hazard, torch.Tensor)
             else torch.tensor(np.asarray(hazard, np.float32)))
        x = -h.to(F32) * c
    return 1.0 - exp_f32(x)


def host_failure_transition(hosts: HostTable, now, fail_draw,
                            cfg: FailureConfig):
    """One step of the host failure model from this step's bool draws
    ([H] or [B, H]).  Returns (hosts, newly_down)."""
    newly_down = hosts.up & hosts.active & fail_draw
    repaired = (~hosts.up) & (now >= hosts.repair_at)
    up = (hosts.up & ~newly_down) | repaired
    repair_at = torch.where(newly_down, now + cfg.repair_h, hosts.repair_at)
    return hosts._replace(up=up, repair_at=repair_at), newly_down


def step_host_failures(rng, hosts: HostTable, now, dt_h: float,
                       cfg: FailureConfig, hazard=None):
    """The reference's step: `rng, k = split(rng)`, draw with `k`, apply.
    Returns (rng, hosts, newly_down).  `rng` is a key [2] or [B, 2];
    `hazard` (None, a host number or a tensor) scales the failure rate."""
    if not cfg.enabled:
        return rng, hosts, torch.zeros_like(hosts.up)
    keys = threefry.split(rng)
    rng, k_fail = keys[..., 0, :], keys[..., 1, :]
    p = failure_probability(hazard, dt_h, cfg.mtbf_h).to(rng.device)
    if rng.dim() > 1:
        p = p.reshape(-1, 1)
    h = hosts.up.shape[-1]
    draw = threefry.uniform(k_fail, h) < p
    hosts, newly_down = host_failure_transition(hosts, now, draw, cfg)
    return rng, hosts, newly_down


# elements of threefry bits drawn at once by `draw_host_failures` (its
# int64 temporaries are 32 MB each)
_DRAW_CHUNK = 1 << 22


def draw_host_failures(seeds, p_fail: torch.Tensor, n_hosts: int,
                       device="cuda"):
    """Every step's host failure draws of a run of B scenario rows.

    `seeds` are the rows' seeds (one, or B), `p_fail` the f32 failure
    probability of each step ([S], or [B, S] rows).  The key chain is
    walked on the host; the bits are drawn on `device` in chunks of steps.
    Returns (keys int64 [S + 1, B, 2], the state's key before each step
    and after the last; draws bool [S, B, H]), B the rows of either input
    (1 where both are shared)."""
    s = p_fail.shape[-1]
    keys, subs = threefry.split_chain(seeds, s)
    p = p_fail.to(device=device, dtype=F32).reshape(-1, s)
    b = max(keys.shape[1], p.shape[0])
    subs = torch.from_numpy(subs.astype(np.int64)).to(device).expand(s, b, 2)
    p = p.expand(b, s).t()
    out = torch.empty((s, b, n_hosts), dtype=torch.bool, device=device)
    chunk = max(1, _DRAW_CHUNK // (b * max(n_hosts, 1)))
    for i in range(0, s, chunk):
        j = min(s, i + chunk)
        out[i:j] = threefry.uniform(subs[i:j], n_hosts) < p[i:j, :, None]
    keys = torch.from_numpy(keys.astype(np.int64)).to(device)
    return keys.expand(s + 1, b, 2), out


def interrupt_tasks(tasks: TaskTable, newly_down, cfg: FailureConfig):
    """Requeue the tasks whose host just failed.  Returns (tasks, the count
    interrupted along the last axis)."""
    h = newly_down.shape[-1]
    idx = torch.clamp(tasks.host, 0, h - 1).long()
    hit = torch.gather(newly_down.expand(*idx.shape[:-1], h), -1, idx)
    on_down = (tasks.status == RUNNING) & (tasks.host >= 0) & hit
    rollback = tasks.ckpt_remaining if cfg.checkpointing else tasks.duration
    lost = torch.where(on_down, rollback - tasks.remaining, 0.0)
    return tasks._replace(
        status=torch.where(on_down, PENDING, tasks.status).to(torch.int32),
        host=torch.where(on_down, -1, tasks.host).to(torch.int32),
        remaining=torch.where(on_down, rollback, tasks.remaining),
        lost_work=tasks.lost_work + torch.clamp(lost, min=0.0),
    ), on_down.to(F32).sum(-1)


def checkpoint_interval_steps(cfg: FailureConfig, dt_h: float) -> int:
    """Steps per checkpoint interval."""
    return max(int(round(cfg.checkpoint_interval_h / dt_h)), 1)


def checkpoint_tick(tasks: TaskTable, step, interval_steps: int,
                    cfg: FailureConfig):
    """Snapshot the running tasks' progress on every interval boundary,
    compared on integer step counts.  `step` is the step index: a host
    integer (the engine's loop knows it, so off-boundary steps launch
    nothing) or a tensor, as in the reference."""
    if not (cfg.enabled and cfg.checkpointing):
        return tasks
    boundary = step % interval_steps == 0
    if not isinstance(boundary, torch.Tensor) and not boundary:
        return tasks
    take = (tasks.status == RUNNING) & boundary
    return tasks._replace(ckpt_remaining=torch.where(
        take, tasks.remaining, tasks.ckpt_remaining))
