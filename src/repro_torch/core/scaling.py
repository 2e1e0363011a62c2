"""Horizontal scaling (paper §VI-A).

Scaling is the host table's `active` mask: a scale of N provisions the first
N hosts and powers the rest off entirely (no idle draw, no embodied share).
`find_min_scale` binary-searches the smallest scale meeting an SLA target:
the paper's "smallest datacenter with <1% SLA violations" procedure.
"""
from __future__ import annotations

from typing import Callable

from .state import HostTable, active_host_mask


def with_scale(hosts: HostTable, n_active) -> HostTable:
    """Provision the first `n_active` hosts (dyn key `n_active_hosts`): a
    count, or [B] counts (one a scenario row; the mask is then [B, H])."""
    return hosts._replace(active=active_host_mask(
        hosts.cores.shape[-1], n_active, hosts.cores.device))


def find_min_scale(eval_sla: Callable[[int], float], lo: int, hi: int,
                   target: float = 0.01) -> tuple[int, dict[int, float]]:
    """Binary search the smallest n_active in [lo, hi] with SLA violations
    <= target.  eval_sla(n) -> violation fraction; assumed non-increasing in
    n.  Returns (best_n, evaluated {n: sla}); best_n = hi + 1 if
    unreachable (then only `hi` was evaluated, once)."""
    evaluated: dict[int, float] = {}
    sla = eval_sla(hi)
    if sla > target:
        evaluated[hi] = sla
        return hi + 1, evaluated
    best = hi
    while lo < hi:
        mid = (lo + hi) // 2
        sla = eval_sla(mid)
        evaluated[mid] = sla
        if sla <= target:
            best, hi = mid, mid
        else:
            lo = mid + 1
    return best, evaluated
