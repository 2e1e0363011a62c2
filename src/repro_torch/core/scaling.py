"""Horizontal scaling (paper §VI-A).

Scaling is the host table's `active` mask: a scale of N provisions the first
N hosts and powers the rest off entirely (no idle draw, no embodied share).
"""
from __future__ import annotations

from .state import HostTable, active_host_mask


def with_scale(hosts: HostTable, n_active) -> HostTable:
    """Provision the first `n_active` hosts (dyn key `n_active_hosts`): a
    count, or [B] counts (one a scenario row; the mask is then [B, H])."""
    return hosts._replace(active=active_host_mask(
        hosts.cores.shape[-1], n_active, hosts.cores.device))
