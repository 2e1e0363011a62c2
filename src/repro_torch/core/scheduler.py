"""Tensorized FIFO scheduling (paper §IV-A resource managers).

FIFO priority is arrival order and the task table is pre-sorted by arrival,
so "the next tasks to schedule" are the first K eligible rows, selected with
a cumsum and K binary searches.  Every function works along the last axis:
[T] tables, or the [B, T] rows of a run of B scenarios (one binary search,
one first-fit launch for all rows).  Placement is exact greedy first-fit: each
of the K candidates takes the lowest-index usable host whose free cores and
GPUs cover it, through `kernels/ops.first_fit_place` -- one launch of the
hand-written kernel per step on the card, its plain version on the CPU.
With a `host_order` (failure-reactive placement, core/resilience.py), the
"lowest index" is the lowest place in that order: the free capacities go
to the kernel gathered in that order, and the chosen places map back.

Mode 'aggregate' is the fragmentation-blind admission of the analytical
models the paper critiques (§III): eager PyTorch ops, no kernel.
"""
from __future__ import annotations

import torch

from ..kernels import ops
from .config import SchedulerConfig
from .state import PENDING, RUNNING, HostTable, TaskTable

F32 = torch.float32
I32 = torch.int32


def free_capacity(tasks: TaskTable, hosts: HostTable):
    """Per-host free CPU cores and GPUs, recomputed from the task table:
    the running, placed tasks' cores and GPUs summed per host in task order
    (`ops.per_host_sum`: on the card one launch on the table's own
    columns)."""
    h = hosts.cores.shape[-1]
    used_c, used_g = ops.per_host_sum(tasks.status, tasks.host, tasks.cores,
                                      tasks.gpus, h)
    avail = (hosts.active & hosts.up).to(F32)
    return hosts.cores * avail - used_c, hosts.n_gpus * avail - used_g


def host_utilization(tasks: TaskTable, hosts: HostTable):
    """Per-host CPU/GPU utilization in [0, 1] from running tasks (their
    cores and GPUs weighted by utilization, summed per host in one
    `ops.per_host_sum`)."""
    h = hosts.cores.shape[-1]
    cpu, gpu = ops.per_host_sum(tasks.status, tasks.host, tasks.cores,
                                tasks.gpus, h, tasks.cpu_util, tasks.gpu_util)
    cpu_u = torch.where(hosts.cores > 0,
                        cpu / torch.clamp(hosts.cores, min=1e-6), 0.0)
    gpu_u = torch.where(hosts.n_gpus > 0,
                        gpu / torch.clamp(hosts.n_gpus, min=1e-6), 0.0)
    return torch.clamp(cpu_u, 0.0, 1.0), torch.clamp(gpu_u, 0.0, 1.0)


def take(col, idx):
    """col[..., idx] row by row, as one gather: a [B, N] column (or a shared
    [1, N] / [N] one) read at [B, M] indices (or shared [1, M] / [M] ones,
    such as a host order common to the rows)."""
    lead = torch.broadcast_shapes(col.shape[:-1], idx.shape[:-1])
    return torch.gather(col.expand(*lead, col.shape[-1]), -1,
                        idx.expand(*lead, idx.shape[-1]))


def _eligible(tasks: TaskTable, now, shift_ok):
    return (tasks.status == PENDING) & (tasks.arrival <= now) & shift_ok


def _first_slots(csum, k: int):
    """(rows of the first k True entries, slot numbers 1..k) from the
    inclusive count `csum` of a mask along its last axis; -1 past the
    mask's last True entry.  The s-th True index is the first i with
    csum[i] == s + 1: one batched binary search a row."""
    wanted = torch.arange(1, k + 1, device=csum.device)
    idx = torch.searchsorted(
        csum, wanted.expand(*csum.shape[:-1], k).contiguous(), side="left")
    return torch.where(wanted <= csum[..., -1:], idx, -1), wanted


def _first_k_indices(mask, k: int):
    """Indices of the first k True entries of mask along its last axis
    (padded with -1).  `torch.cumsum` of an int32 tensor returns int64, and
    so do the indices."""
    return _first_slots(torch.cumsum(mask.to(I32), -1), k)[0]


def schedule_first_fit(tasks: TaskTable, hosts: HostTable, now, shift_ok,
                       cfg: SchedulerConfig, slots=None, host_order=None,
                       presorted: bool = False):
    """Exact bounded first-fit.  Returns the updated task table.

    `cfg.slots_per_step` bounds the candidates per step; `slots` (dyn
    `slots_per_step`: a host int, a 0-d tensor or a [B, 1] count a scenario
    row) masks the slots past it.
    `host_order` (a permutation of the hosts, [H] or [B, H]) makes the
    first fit the first fitting host in that order; down and inactive hosts
    never fit either way.
    `presorted=True` asserts the rows are already in (priority desc,
    arrival) order (`state.priority_schedule_order`), so admission is the
    plain FIFO prefix; otherwise priority levels > 1 select from the
    level-major flattened [L*T] mask ([B, L*T] for [B, T] rows).

    The reference places with a `while_loop` that stops early once no
    remaining candidate fits any usable host, or at the first -1 slot;
    both stops skip only iterations that place nothing, so one pass of the
    greedy first-fit over all K slots gives the same placement.  Unusable
    hosts enter with -inf free capacity and -1 slots with +inf needs, so
    neither ever fits, not even a zero-footprint task.
    """
    k = cfg.slots_per_step
    t = tasks.arrival.shape[-1]
    dev = tasks.arrival.device
    elig = _eligible(tasks, now, shift_ok)
    multi = cfg.priority_levels > 1 and not presorted
    if multi:
        # level-major flattened mask: merged (priority desc, arrival) order
        lvl = torch.arange(cfg.priority_levels - 1, -1, -1, device=dev,
                           dtype=tasks.priority.dtype)
        m = (elig[..., None, :] & (tasks.priority[..., None, :]
                                   == lvl[:, None])).flatten(-2)
    else:
        m = elig
    # one cumsum maps slots to rows (k binary searches) and rows to slots
    # (a row's rank is its cumsum - 1)
    csum = torch.cumsum(m.to(I32), -1)
    idx, wanted = _first_slots(csum, k)
    cand = torch.where(idx >= 0, idx % t, -1) if multi else idx
    if slots is not None:  # the masked tail of a swept slot count
        cand = torch.where(wanted <= slots, cand, -1)
    free_c, free_g = free_capacity(tasks, hosts)
    usable = hosts.active & hosts.up
    cj = torch.clamp(cand, min=0)
    inf = float("inf")
    need_c = torch.where(cand >= 0, take(tasks.cores, cj), inf)
    need_g = torch.where(cand >= 0, take(tasks.gpus, cj), inf)
    free_c = torch.where(usable, free_c, -inf)
    free_g = torch.where(usable, free_g, -inf)
    if host_order is not None:
        free_c, free_g = take(free_c, host_order), take(free_g, host_order)
    sel_host, _, _ = ops.first_fit_place(need_c, need_g, free_c, free_g)
    if host_order is not None:  # a place in the order -> its host
        sel_host = torch.where(
            sel_host >= 0,
            take(host_order, torch.clamp(sel_host, min=0).long()),
            -1).to(I32)
    # deferred table writes through the inverse candidate map
    if multi:
        lvl_t = (cfg.priority_levels - 1
                 - torch.clamp(tasks.priority, 0, cfg.priority_levels - 1))
        pos_t = lvl_t.to(torch.int64) * t + torch.arange(t, device=dev)
        rank = take(csum, pos_t.expand(*csum.shape[:-1], t)) - 1
        in_k = take(m, pos_t.expand(*m.shape[:-1], t)) & (rank < k)
    else:
        rank = csum - 1
        in_k = elig & (rank < k)
    host_t = take(sel_host, torch.clamp(rank, 0, k - 1))
    placed = in_k & (host_t >= 0)
    return tasks._replace(
        status=torch.where(placed, RUNNING, tasks.status).to(I32),
        host=torch.where(placed, torch.clamp(host_t, min=0),
                         tasks.host).to(I32),
        first_start=torch.where(placed, torch.clamp(tasks.first_start,
                                                    max=now),
                                tasks.first_start))


def schedule_aggregate(tasks: TaskTable, hosts: HostTable, now, shift_ok,
                       cfg: SchedulerConfig):
    """Capacity-only admission (fragmentation-blind, analytical-model-like).

    Admits the longest FIFO prefix of eligible tasks whose total core and
    GPU demand fits the total free capacity, then maps each admitted task
    onto a host by the position of its core-demand midpoint in the
    cumulative free-core distribution over hosts (approximate placement).
    Each scenario row searches its own [B, H] distribution.

    The f32 cumsums run over integer-valued core and GPU needs, so they are
    exact in any association while the eligible backlog's sum stays below
    2^24 (the half-integer midpoints below 2^23); `torch.cumsum` then gives
    the reference's bits.  Slots and host orders do not apply here."""
    elig = _eligible(tasks, now, shift_ok)
    free_c, free_g = free_capacity(tasks, hosts)
    total_c = free_c.sum(-1, keepdim=True)
    total_g = free_g.sum(-1, keepdim=True)
    need_c = torch.where(elig, tasks.cores, 0.0)
    need_g = torch.where(elig, tasks.gpus, 0.0)
    cum_need_c = torch.cumsum(need_c, -1)
    admit = (elig & (cum_need_c <= total_c)
             & (torch.cumsum(need_g, -1) <= total_g))
    cum_c = torch.cumsum(torch.clamp(free_c, min=0.0), -1)
    pos = cum_need_c - need_c * 0.5
    h = hosts.cores.shape[-1]
    host = torch.clamp(torch.searchsorted(
        cum_c.expand(*pos.shape[:-1], h).contiguous(), pos.contiguous(),
        side="left"), 0, h - 1)
    # a down or inactive host spans zero width of the cumsum, yet a
    # zero-need task's midpoint can land exactly on it (0 >= 0): bump every
    # task to the next usable host at or after its mapped position, and
    # refuse admission when there is none
    usable = hosts.active & hosts.up
    idx = torch.arange(h, device=usable.device)
    next_usable = torch.flip(torch.cummin(torch.flip(
        torch.where(usable, idx, h), [-1]), -1).values, [-1])
    bumped = take(next_usable, host)
    ok = bumped < h
    admit = admit & ok
    host = torch.where(ok, bumped, 0)
    return tasks._replace(
        status=torch.where(admit, RUNNING, tasks.status).to(I32),
        host=torch.where(admit, host, tasks.host).to(I32),
        first_start=torch.where(admit, torch.clamp(tasks.first_start,
                                                   max=now),
                                tasks.first_start))


def schedule_step(tasks: TaskTable, hosts: HostTable, now, shift_ok,
                  cfg: SchedulerConfig, slots=None, host_order=None,
                  presorted: bool = False):
    if cfg.mode == "first_fit":
        return schedule_first_fit(tasks, hosts, now, shift_ok, cfg,
                                  slots=slots, host_order=host_order,
                                  presorted=presorted)
    if cfg.mode == "aggregate":
        if cfg.priority_levels > 1:
            raise ValueError(
                "scheduler mode 'aggregate' admits the longest FIFO prefix "
                "and cannot honor priority classes; use mode='first_fit' "
                "with priority_levels > 1")
        return schedule_aggregate(tasks, hosts, now, shift_ok, cfg)
    raise ValueError(f"unknown scheduler mode '{cfg.mode}'")
