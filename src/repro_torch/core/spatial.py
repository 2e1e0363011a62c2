"""Spatial workload shifting: placement policies for the fleet engine.

The paper evaluates temporal shifting and cites Sukprasert et al. on
spatial + temporal shifting as the natural extension (§IX, §XI).  This
module adds the fourth technique without touching the engine: tasks are
assigned at submission to one of R regional datacenters by a carbon-aware
placement policy, then each region's sub-workload runs through the
unchanged engine as one scenario row of a step loop (core/fleet.py).

Placement policies (forecast-based, mirroring the temporal policy of
§V-B2 rather than an oracle):

* ``spatial_assign`` (greedy): each task goes to the region with the lowest
  mean forecast carbon intensity over [arrival, arrival + duration],
  subject to a per-region aggregate core-hour cap.  An optimistic-batch
  vectorized algorithm with exactly the semantics of the sequential greedy
  loop (``spatial_assign_reference``, the executable spec).
* ``spatial_assign_online`` (spill): an online capacity-aware router that
  tracks each region's time-resolved core occupancy; a task spills to the
  next-cheapest region when its first choice is saturated anywhere inside
  the task's own run window.

Placement happens on the host, in numpy, with the reference package's f64
forecast arithmetic and tie-breaking, so region ids are bit-equal to the
reference's: it depends only on the traces and the task list.  Ties in
forecast CI break toward the lower region index; the processing order
breaks arrival ties by (duration, cores) content, not input position.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import (TaskTable, make_task_table, pad_task_table,
                    stack_task_tables)

_BLOCK = 4096  # optimistic-batch size for the capped greedy
BACKENDS = ("numpy", "torch")


def host_array(x) -> np.ndarray:
    """A task column or trace on the host, as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _mean_ci_matrix(traces: np.ndarray, arrival, duration, dt_h: float,
                    forecast_h: float):
    """f64[T, R] mean forecast CI per (task, region) over each task's window.

    Shared by every placement policy and the sequential reference, so they
    can differ only in the assignment logic.  Returns (matrix, i0, i1) with
    the step-index window [i0, i1) of each task.
    """
    r, s = traces.shape
    csum = np.concatenate([np.zeros((r, 1), np.float64),
                           np.cumsum(traces.astype(np.float64), axis=1)],
                          axis=1)
    horizon = np.minimum(np.asarray(duration, np.float64), forecast_h)
    t0 = np.asarray(arrival, np.float64)
    with np.errstate(invalid="ignore"):  # inf padding rows: clipped below
        i0 = np.clip(np.nan_to_num(t0 / dt_h, posinf=0).astype(np.int64),
                     0, s - 1)
        i1 = np.clip(np.nan_to_num(np.ceil((t0 + horizon) / dt_h),
                                   posinf=0).astype(np.int64), i0 + 1, s)
    m = (csum[:, i1] - csum[:, i0]) / (i1 - i0)        # [R, T]
    return m.T, i0, i1


def placement_order(tasks: TaskTable) -> np.ndarray:
    """FIFO processing order with content-based tie-breaking: arrival
    first, ties by (duration, cores) rather than input position."""
    return np.lexsort((host_array(tasks.cores), host_array(tasks.duration),
                       host_array(tasks.arrival)))


def spatial_assign(tasks: TaskTable, traces, dt_h: float,
                   capacity_core_h=None, forecast_h: float = 24.0,
                   backend: str = "numpy", device="cuda"):
    """Assign each task to a region.  Returns i32[T] region ids (-1 pad).

    traces: f32[R, S] carbon traces.  capacity_core_h: optional per-region
    cap on total assigned core-hours (None = uncapped).  backend: 'numpy'
    (default) or 'torch', the uncapped argmin as one `torch.argmin` on
    `device` (first index on ties, as `np.argmin`); the capped path keeps
    its load state on the host either way.

    Greedy invariant: every task lands on the region with minimal mean
    forecast CI among regions that still have aggregate headroom at its
    (arrival-ordered) turn; when no region has headroom the least-loaded
    region (relative to its cap) takes the overflow.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown placement backend {backend!r}; pick one "
                         f"of {BACKENDS} (the reference's 'jax' argmin is "
                         "'torch' here)")
    traces = host_array(traces).astype(np.float32)
    r = traces.shape[0]
    arrival = host_array(tasks.arrival)
    valid = np.isfinite(arrival)
    region = np.full(arrival.shape[0], -1, np.int32)
    ci, _, _ = _mean_ci_matrix(traces, arrival, host_array(tasks.duration),
                               dt_h, forecast_h)

    if capacity_core_h is None:
        # uncapped: placement is a pure per-task argmin, one vector op
        if backend == "torch":
            best = torch.argmin(torch.from_numpy(ci).to(device), 1).cpu()
            best = best.numpy()
        else:
            best = np.argmin(ci, axis=1)
        region[valid] = best[valid].astype(np.int32)
        return region

    cap = np.asarray(capacity_core_h, np.float64)
    work = (host_array(tasks.cores).astype(np.float64)
            * host_array(tasks.duration).astype(np.float64))
    order = placement_order(tasks)
    order = order[valid[order]]
    load = np.zeros(r, np.float64)
    pos = 0
    while pos < order.shape[0]:
        blk = order[pos:pos + _BLOCK]
        w = work[blk]
        # cheapest region with headroom, judged from block-start loads
        headroom = load[None, :] + w[:, None] <= cap[None, :]      # [b, R]
        any_head = headroom.any(axis=1)
        choice = np.argmin(np.where(headroom, ci[blk], np.inf), axis=1)
        # within-block load each choice adds to its region, before each task
        add = np.zeros((blk.shape[0], r))
        add[np.arange(blk.shape[0]), choice] = w
        before = np.cumsum(add, axis=0) - add
        ok = any_head & (load[choice] + before[np.arange(blk.shape[0]), choice]
                         + w <= cap[choice])
        # the optimistic prefix is exact: loads only grow, so a region that
        # was cheapest-with-headroom at block start and still fits the task
        # at its turn is still cheapest-with-headroom (cheaper regions that
        # lacked headroom cannot regain it)
        k = int(np.argmax(~ok)) if not ok.all() else blk.shape[0]
        taken = blk[:k]
        region[taken] = choice[:k].astype(np.int32)
        load += add[:k].sum(axis=0)
        pos += k
        if k < blk.shape[0] and not any_head[k]:
            # all regions full for this task: least-loaded fallback, then
            # re-enter the batch loop with the updated loads
            i = blk[k]
            rr = int(np.argmin(load / np.maximum(cap, 1e-9)))
            region[i] = rr
            load[rr] += work[i]
            pos += 1
        # else: a cap was crossed mid-block; re-evaluate from the violator
    return region


def spatial_assign_reference(tasks: TaskTable, traces, dt_h: float,
                             capacity_core_h=None, forecast_h: float = 24.0):
    """Sequential greedy placement, the executable spec: one task at a time
    in `placement_order`, the cheapest region with aggregate headroom,
    least-loaded fallback.  `spatial_assign` matches it bit for bit."""
    traces = host_array(traces).astype(np.float32)
    r = traces.shape[0]
    arrival = host_array(tasks.arrival)
    valid = np.isfinite(arrival)
    ci, _, _ = _mean_ci_matrix(traces, arrival, host_array(tasks.duration),
                               dt_h, forecast_h)
    work = (host_array(tasks.cores).astype(np.float64)
            * host_array(tasks.duration).astype(np.float64))
    cap = (np.full(r, np.inf) if capacity_core_h is None
           else np.asarray(capacity_core_h, np.float64))
    load = np.zeros(r)
    region = np.full(arrival.shape[0], -1, np.int32)
    for i in placement_order(tasks):
        if not valid[i]:
            continue
        for rr in np.argsort(ci[i], kind="stable"):
            if load[rr] + work[i] <= cap[rr]:
                region[i] = rr
                load[rr] += work[i]
                break
        else:
            rr = int(np.argmin(load / np.maximum(cap, 1e-9)))
            region[i] = rr
            load[rr] += work[i]
    return region


def spatial_assign_online(tasks: TaskTable, traces, dt_h: float,
                          capacity_cores, n_steps: int | None = None,
                          forecast_h: float = 24.0):
    """Online capacity-aware re-routing ("spill" policy).

    Tracks per-region core occupancy over time: a task goes to the cheapest
    region whose occupancy stays within `capacity_cores[r]` throughout the
    task's own run window, spilling to the next-cheapest region when its
    first choice is saturated anywhere mid-run; if every region saturates,
    the one with the smallest peak overflow takes it.

    capacity_cores: f32[R] concurrent-core capacity per region.
    Returns i32[T] region ids (-1 for padding rows).
    """
    traces = host_array(traces).astype(np.float32)
    r, s = traces.shape
    s = s if n_steps is None else min(s, n_steps)
    # truncate to the simulated horizon before the forecast matrix so the
    # occupancy windows (i0) and j1 share one step range
    traces = traces[:, :s]
    arrival = host_array(tasks.arrival)
    valid = np.isfinite(arrival)
    cores = host_array(tasks.cores).astype(np.float64)
    duration = host_array(tasks.duration).astype(np.float64)
    cap = np.asarray(capacity_cores, np.float64)
    ci, i0, _ = _mean_ci_matrix(traces, arrival, duration, dt_h,
                                forecast_h)
    # occupancy windows cover the full nominal run, not just the forecast
    with np.errstate(invalid="ignore"):
        j1 = np.clip(np.nan_to_num(np.ceil((arrival + duration) / dt_h),
                                   posinf=0).astype(np.int64), i0 + 1, s)
    occ = np.zeros((r, s))
    region = np.full(arrival.shape[0], -1, np.int32)
    for i in placement_order(tasks):
        if not valid[i]:
            continue
        lo, hi = int(i0[i]), int(j1[i])
        peak = occ[:, lo:hi].max(axis=1)          # [R] current peak in window
        fits = peak + cores[i] <= cap
        if fits.any():
            rr = int(np.argmin(np.where(fits, ci[i], np.inf)))
        else:                                     # least peak overflow
            rr = int(np.argmin(peak + cores[i] - cap))
        region[i] = rr
        occ[rr, lo:hi] += cores[i]
    return region


def split_by_region(tasks: TaskTable, region, n_regions: int,
                    width: int | None = None, device="cuda") -> TaskTable:
    """Per-region padded task tables, stacked [R, W] on `device`: each
    region's tasks are one scenario row of the fleet's step loop.

    width: pad every region's table to this many rows (default: the largest
    region's count).  Pass `tasks.n` when a fixed, region-count-independent
    shape is needed (or room to receive spilled tasks)."""
    region = host_array(region)
    cols = {f: host_array(getattr(tasks, f)) for f in (
        "arrival", "duration", "cores", "gpus", "cpu_util", "gpu_util",
        "job_class", "priority", "shiftable", "sla_grace")}
    subsets = [np.where(region == rr)[0] for rr in range(n_regions)]
    w = max(max((len(i) for i in subsets), default=0), 1)
    if width is not None:
        if width < w:
            raise ValueError(f"width {width} < largest region {w}")
        w = width
    out = []
    for idx in subsets:
        # the class columns too, or a fleet split would silently drop
        # classes, priorities and SLOs on the way in
        t = make_task_table(*(cols[f][idx] for f in (
            "arrival", "duration", "cores", "gpus", "cpu_util", "gpu_util")),
            job_class=cols["job_class"][idx],
            priority=cols["priority"][idx],
            shiftable=cols["shiftable"][idx],
            sla_grace=cols["sla_grace"][idx], device=device)
        # empty regions become a full-width invalid table through the same
        # pad path as everyone else
        out.append(pad_task_table(t, w))
    return stack_task_tables(out)
