"""Temporal shifting (paper §V-B2).

A task may start only while the carbon intensity is at or below the 35th
percentile of the NEXT week's forecast (the trace itself serves as a perfect
forecast, as in the paper); each task may be delayed at most `max_delay_h`,
after which plain FIFO applies.  An optional task-stopper pauses running
tasks during high-carbon periods and resumes them when green energy returns.

The per-step threshold depends only on the trace, so it is precomputed.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ShiftingConfig

# window rows sorted at a time: bounds the transient at ~_CHUNK_ROWS * W * 4
# bytes (22 MB at the week window of 15-minute steps)
_CHUNK_ROWS = 8192


def _interpolation(levels: np.ndarray, w: int):
    """The reference's f32 constants of `jnp.quantile`'s linear method:
    order-statistic depths low/high and their weights, per level."""
    n1 = np.float32(w) - np.float32(1.0)
    qn = levels.astype(np.float32) * n1
    low = np.clip(np.floor(qn), np.float32(0.0), n1).astype(np.int64)
    high = np.clip(np.ceil(qn), np.float32(0.0), n1).astype(np.int64)
    hw = (qn - np.floor(qn)).astype(np.float32)
    lw = (np.float32(1.0) - hw).astype(np.float32)
    return low, high, lw, hw


def forward_window_quantiles(trace, dt_h: float, window_h: float, quantiles,
                             chunk_rows: int = _CHUNK_ROWS):
    """threshold[..., t] = each `quantile` level of the trace over [t,
    t+window), for each row of an [..., S] trace.

    Windows that run past the end see copies of the last value (the
    reference clips its window indices the same way).  Each window is
    sorted once for all levels; the two order statistics of each level are
    interpolated as `v_lo * lw + v_hi * hw` in f32, and a window holding a
    NaN yields NaN.  `quantiles` is a host scalar (returns f32[..., S]) or a
    sequence of Q levels (returns f32[Q, ..., S]).  About `chunk_rows`
    windows are sorted at a time, over all rows together."""
    x = trace.to(torch.float32)
    lead, s = x.shape[:-1], x.shape[-1]
    x = x.reshape(-1, s)
    r = x.shape[0]
    w = max(int(round(window_h / dt_h)), 1)
    levels = np.atleast_1d(np.asarray(quantiles, np.float32))
    low, high, lw, hw = _interpolation(levels, w)
    padded = torch.cat([x, x[:, -1:].expand(r, w - 1)], 1)
    windows = padded.unfold(1, w, 1)                 # [R, S, W] view
    nan_csum = torch.cat([x.new_zeros(r, 1, dtype=torch.int64),
                          torch.cumsum(torch.isnan(padded).to(torch.int64),
                                       1)], 1)
    poison = (nan_csum[:, w:w + s] - nan_csum[:, :s]) > 0
    out = torch.empty((levels.shape[0], r, s), dtype=torch.float32,
                      device=x.device)
    step = max(1, chunk_rows // r)
    for r0 in range(0, s, step):
        srt = torch.sort(windows[:, r0:r0 + step], dim=-1).values
        for q in range(levels.shape[0]):
            out[q, :, r0:r0 + step] = (srt[..., low[q]] * lw[q]
                                       + srt[..., high[q]] * hw[q])
    out = torch.where(poison[None], float("nan"), out).reshape(
        levels.shape[0], *lead, s)
    return out[0] if np.ndim(quantiles) == 0 else out


def forward_window_quantile(trace, dt_h: float, window_h: float, quantile):
    """`forward_window_quantiles` at one level."""
    return forward_window_quantiles(trace, dt_h, window_h, quantile)


def precompute_shift_threshold(ci_trace, dt_h: float, cfg: ShiftingConfig,
                               quantile=None):
    """threshold[..., t] = `quantile` of ci over the forward window.
    `quantile` (dyn `shift_quantile_value`) overrides the config's level: a
    host number, a 0-d tensor, or one level per scenario row ([B] or [B, 1]
    values; the trace is then [S] or [B, S] and the result [B, S]).  The
    levels are read on the host, before the step loop: each distinct level
    gets its own order-statistic pair, and every row takes its own level's
    threshold from one sort of its windows."""
    q = cfg.quantile if quantile is None else quantile
    if isinstance(q, torch.Tensor):
        q = q.cpu().numpy()
    q = np.asarray(q, np.float32)
    if q.size == 1:
        return forward_window_quantile(ci_trace, dt_h, cfg.forecast_window_h,
                                       np.float32(q.reshape(())))
    levels, pick = np.unique(q.reshape(-1), return_inverse=True)
    th = forward_window_quantiles(ci_trace, dt_h, cfg.forecast_window_h,
                                  levels)
    b, s = pick.shape[0], th.shape[-1]
    rows = th.reshape(levels.shape[0], -1, s).expand(levels.shape[0], b, s)
    dev = th.device
    return rows[torch.as_tensor(pick, device=dev),
                torch.arange(b, device=dev)]


def start_allowed(ci, threshold, now, arrival, cfg: ShiftingConfig,
                  shiftable=None):
    """bool[T]: may a PENDING task start now?  Overdue and non-shiftable
    tasks bypass the gate."""
    if not cfg.enabled:
        return torch.ones_like(arrival, dtype=torch.bool)
    green = ci <= threshold
    overdue = (now - arrival) >= cfg.max_delay_h
    ok = green | overdue
    if shiftable is not None:
        ok = ok | ~shiftable
    return ok


def should_stop(ci, threshold, now, arrival, cfg: ShiftingConfig,
                shiftable=None):
    """Task-stopper predicate for RUNNING tasks (graceful pause)."""
    if not (cfg.enabled and cfg.stop_running):
        return torch.zeros_like(arrival, dtype=torch.bool)
    red = ci > threshold
    within_budget = (now - arrival) < cfg.max_delay_h
    stop = red & within_budget
    if shiftable is not None:
        stop = stop & shiftable
    return stop
