"""The analytical temporal-shifting model the paper critiques (§III).

Prior work (Sukprasert et al., Bostandoost et al.) estimated shifting savings
per task: the carbon intensity over a task's run at its original start
against the best start within the delay budget, averaged over tasks --
blind to capacity (task stacking), idle-host draw and failures.  This is
that model, so a study can set its estimate beside what the full simulation
delivers (paper finding F5: the estimate is several times larger).

Each task's D candidate starts are one [T, D] broadcast, made a chunk of
tasks at a time so the temporaries stay small at 10^5-10^6 tasks.  The
cumulative trace grows to ~10^6, where an f32 ulp is ~0.1, and an average
is the difference of two of its values: the cumsum associates as the
reference's does on the CPU (`battery.blocked_cumsum`), and every division
is an IEEE quotient of two tensors.
"""
from __future__ import annotations

import numpy as np
import torch

from .battery import blocked_cumsum
from .state import as_tensor

F32 = torch.float32
# tasks a chunk: [chunk, D] f32 temporaries of ~6 MB at D = 97
_CHUNK_TASKS = 16384


def _delay_grid(max_delay_h: float, n: int) -> np.ndarray:
    """`jnp.linspace(0.0, max_delay_h, n)` in f32, computed as JAX does:
    start * (1 - step) + stop * step with step = iota / (n - 1), and the
    stop itself as the last point."""
    start, stop = np.float32(0.0), np.float32(max_delay_h)
    if n == 1:
        return np.array([start], np.float32)
    div = np.float32(n - 1)
    step = np.arange(n - 1, dtype=np.float32) / div
    out = start * (np.float32(1.0) - step) + stop * step
    return np.concatenate([out, [stop]]).astype(np.float32)


def _avg_ci(csum, dt, dur_min, start_h, dur_h):
    """Mean carbon intensity over [start, start + dur), linearly
    interpolated on the cumulative trace: csum[k] is the integral of the
    trace over its first k steps (in step units), `dt` the step length as
    a 0-d tensor; durations below `dur_min` count as `dur_min`."""
    s = csum.shape[0] - 1

    def integral(t_h):
        x = torch.clamp(t_h / dt, 0.0, float(s))
        i = torch.floor(x).to(torch.int64)
        frac = x - i.to(F32)
        lo = csum[i]
        hi = csum[torch.clamp(i + 1, max=s)]
        return lo + (hi - lo) * frac

    dur = torch.clamp(dur_h, min=dur_min)
    return (integral(start_h + dur) - integral(start_h)) / (dur / dt)


def analytical_shifting_savings(arrival_h, duration_h, ci_trace, dt_h,
                                max_delay_h: float = 24.0,
                                n_delay_grid: int = 97, oracle: bool = True,
                                threshold=None, device="cuda"):
    """Per-task shifting savings, capacity-blind (the §III strawman), on
    `device`.

    oracle=True: each task independently picks the delay in [0, max_delay]
    minimizing its average carbon intensity (the 'oracle' of prior work).
    oracle=False: each task starts at the first grid delay whose average
    is at most the threshold at its arrival step (`threshold[S]`, default
    the trace itself), else at once (threshold policy, still
    capacity-blind).

    Returns (mean_savings_pct, per_task_savings_pct) as f32 tensors: 0-d
    and [T].
    """
    ci = as_tensor(ci_trace, F32, device)
    csum = torch.cat([ci.new_zeros(1), blocked_cumsum(ci)])
    arrival = as_tensor(arrival_h, F32, device)
    duration = as_tensor(duration_h, F32, device)
    # the step as a device tensor: `tensor / python_float` may multiply by
    # a reciprocal on the card
    dt = torch.tensor(np.float32(dt_h), device=device)
    dur_min = float(np.float32(dt_h * 1e-3))
    delays = torch.as_tensor(_delay_grid(max_delay_h, n_delay_grid),
                             device=device)
    thr_trace = ci if threshold is None else as_tensor(threshold, F32,
                                                       device)
    parts = []
    for lo in range(0, arrival.shape[0], _CHUNK_TASKS):
        a = arrival[lo:lo + _CHUNK_TASKS]
        d = duration[lo:lo + _CHUNK_TASKS]
        base = _avg_ci(csum, dt, dur_min, a, d)
        cands = _avg_ci(csum, dt, dur_min, a[:, None] + delays, d[:, None])
        if oracle:
            best = cands.amin(-1)
        else:
            thr_idx = torch.clamp((a / dt).to(torch.int32), 0,
                                  ci.shape[0] - 1).long()
            ok = cands <= thr_trace[thr_idx][:, None]
            first = torch.argmax(ok.to(torch.int8), -1, keepdim=True)
            best = torch.where(ok.any(-1),
                               torch.gather(cands, -1, first)[:, 0], base)
        parts.append(100.0 * (base - best) / torch.clamp(base, min=1e-9))
    savings = (torch.cat(parts) if parts
               else torch.zeros(0, dtype=F32, device=device))
    return savings.mean(), savings
