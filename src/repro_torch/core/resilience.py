"""Closed-loop resilience: facility failures, thermal throttling, reactive
placement (paper §VI-A2, finding F1), as in the reference:

1. Facility failure injection (`facility_failure_series`): memoryless
   chiller-derate and PDU-cap processes with the host model's MTBF and
   deterministic-repair shape.  They depend only on the run seed and the
   hazard scale, never on the simulation state, so `build_step_inputs`
   computes them once as exogenous per-step series; both executors read
   the same series, and the megakernel's facility kernel takes the derate
   as an input.
2. Thermal throttling (`inlet_proxy_c`, `next_throttle`): a rack-inlet
   proxy from wet-bulb and IT load, divided by the chiller derate; above
   the trip point the NEXT step runs at `throttle_factor`, and a PDU clamp
   scales the next step's utilization toward the cap.  The one-step delay
   keeps the recurrence causal.
3. Failure-reactive placement (`host_rank`, `cross_region_spill`): the
   scheduler prefers hosts that are up and longest since their repair; the
   fleet moves interrupted tasks to its healthiest region.

Tensors carry the engine's scenario rows: series [S] or [B, S], a row's
scalars [B, 1], host columns [H] or [B, H].
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry
from .config import ResilienceConfig
from .failures import failure_probability
from .scheduler import _first_k_indices
from .state import INVALID, PENDING, HostTable, MetricsAcc, TaskTable

F32 = torch.float32

# fold_in constants decorrelating the facility processes from the host
# failure stream and from each other
_CHILLER_STREAM = 101
_PDU_STREAM = 103


def _failure_process(key, n_steps: int, dt_h: float, mtbf_h: float,
                     repair_h: float, hazard_scale) -> np.ndarray:
    """bool [B, n_steps] 'derated' flags of a memoryless failure process
    per key row ([B, 2] keys; a [B] or 0-d hazard): per-step failure
    probability ``1 - exp(-hazard * dt / mtbf)`` while healthy, then a
    repair countdown of ``round(repair_h / dt_h)`` steps (at least 1).
    The uniforms come from the keys on the host, the walk is numpy."""
    u = threefry.uniform(key.cpu(), n_steps).numpy()
    p = failure_probability(hazard_scale, dt_h, mtbf_h).numpy()
    fail_ok = u < p.reshape(-1, 1)
    repair_steps = max(int(round(repair_h / dt_h)), 1)
    down = np.zeros(fail_ok.shape[0], np.int64)
    out = np.empty(fail_ok.shape, bool)
    for t in range(n_steps):
        fail = (down == 0) & fail_ok[:, t]
        down = np.where(fail, repair_steps, np.maximum(down - 1, 0))
        out[:, t] = down > 0
    return out


def facility_failure_series(seed, n_steps: int, dt_h: float,
                            cfg: ResilienceConfig, hazard_scale=None,
                            device="cuda"):
    """The exogenous facility failure series of a run: (chiller_derate f32,
    pdu_down bool), [n_steps] for one seed and hazard, [B, n_steps] for B
    of either.  The derate is `cfg.chiller_derate` while the chiller is
    down and 1.0 otherwise; the engine turns `pdu_down` into a kW clamp.
    `seed` and `hazard_scale` are host values or tensors (read once)."""
    if isinstance(seed, torch.Tensor):
        seed = seed.cpu().numpy()
    if isinstance(hazard_scale, torch.Tensor):
        hazard_scale = hazard_scale.cpu()
    hazard = (np.float32(1.0) if hazard_scale is None else hazard_scale)
    key = threefry.prng_key(np.asarray(seed).reshape(-1))
    chiller = _failure_process(threefry.fold_in(key, _CHILLER_STREAM),
                               n_steps, dt_h, cfg.chiller_mtbf_h,
                               cfg.chiller_repair_h, hazard)
    pdu = _failure_process(threefry.fold_in(key, _PDU_STREAM), n_steps,
                           dt_h, cfg.pdu_mtbf_h, cfg.pdu_repair_h, hazard)
    derate = np.where(chiller, np.float32(cfg.chiller_derate),
                      np.float32(1.0))
    if np.ndim(seed) == 0 and np.ndim(hazard) == 0:
        derate, pdu = derate[0], pdu[0]
    return (torch.from_numpy(derate).to(device),
            torch.from_numpy(pdu).to(device))


def inlet_proxy_c(it_kw, wet_bulb_c, chiller_derate,
                  cfg: ResilienceConfig):
    """Rack-inlet temperature proxy (degC): ``wet_bulb + approach +
    load_coeff * it_kw / derate``, the derate floored at 1e-3."""
    derate = torch.clamp(torch.as_tensor(chiller_derate, dtype=F32,
                                         device=it_kw.device), min=1e-3)
    return (wet_bulb_c + cfg.inlet_approach_c
            + cfg.inlet_load_c_per_kw * it_kw / derate)


def next_throttle(it_kw, raw_it_kw, wet_bulb_c, chiller_derate, pdu_cap_kw,
                  cfg: ResilienceConfig, threshold_c=None):
    """Host speed/utilization cap for the NEXT step, in (0, 1]: the least
    of the thermal trip (`cfg.throttle_factor` when the inlet proxy at the
    capped IT load exceeds `threshold_c`, default `cfg.throttle_inlet_c`)
    and the PDU headroom ``clip(cap / raw demand, 0, 1)``."""
    th = (np.float32(cfg.throttle_inlet_c) if threshold_c is None
          else threshold_c)
    inlet = inlet_proxy_c(it_kw, wet_bulb_c, chiller_derate, cfg)
    thermal = torch.where(inlet > th, np.float32(cfg.throttle_factor),
                          np.float32(1.0))
    raw = torch.clamp(raw_it_kw, min=1e-6)
    pdu = torch.clamp(pdu_cap_kw / raw, 0.0, 1.0)
    return torch.minimum(thermal, pdu)


def host_rank(hosts: HostTable, now) -> torch.Tensor:
    """i64 [H] (or [B, H]) host preference order for failure-reactive
    placement: usable hosts by time since their last repair, longest first,
    then the down and inactive ones; a stable sort, so with no failure
    history the order is the identity."""
    usable = hosts.active & hosts.up
    since_repair = now - hosts.repair_at
    score = torch.where(usable, since_repair, -float("inf"))
    return torch.argsort(-score, dim=-1, stable=True)


_SPILL_FILL = {"arrival": float("inf"), "duration": 0, "remaining": 0,
               "ckpt_remaining": 0, "cores": 0, "gpus": 0, "cpu_util": 0,
               "gpu_util": 0, "status": INVALID, "host": -1,
               "first_start": float("inf"), "finish": float("inf"),
               "lost_work": 0, "job_class": 0, "priority": 0,
               "shiftable": True, "sla_grace": -1.0}


def cross_region_spill(tasks: TaskTable, hosts: HostTable,
                       metrics: MetricsAcc, max_spills: int):
    """Move up to `max_spills` interrupted tasks to the healthiest region.

    Every column carries a leading region axis ([R, W] tasks, [R, H]
    hosts, [R] or [R, 1] metrics).  A candidate is a PENDING task that has
    started once (finite `first_start`) in a region less healthy than the
    healthiest (health: the share of provisioned hosts up).  Each move
    copies the row into the target region's first INVALID slot and
    invalidates the source; `metrics.n_spills` counts moves per source
    region.  With every region healthy nothing moves.

    The reference moves one task at a time, each the first candidate (in
    row-major order) into the first free slot.  A move takes a candidate
    out and fills a slot of the target region, which holds no candidate,
    so the k-th move is the k-th candidate into the k-th free slot: all
    moves at once here, as gathers and index writes on the device (a move
    that does not happen writes into K spare slots past the table's end,
    which are then dropped), reading nothing back."""
    act = hosts.active.to(F32)
    up = (hosts.active & hosts.up).to(F32)
    health = up.sum(1) / torch.clamp(act.sum(1), min=1.0)
    target = torch.argmax(health, 0, keepdim=True)                # [1]
    r, w = tasks.status.shape
    behind = (health < health[target])[:, None]
    cand = ((tasks.status == PENDING) & torch.isfinite(tasks.first_start)
            & behind)
    src = _first_k_indices(cand.reshape(-1), max_spills)          # [K]
    slot = _first_k_indices(tasks.status[target][0] == INVALID, max_spills)
    do = (src >= 0) & (slot >= 0)
    spare = r * w + torch.arange(max_spills, device=src.device)
    src = torch.where(do, src, spare)
    dst = torch.where(do, target * w + slot, spare)
    cols = {}
    for f, col in tasks._asdict().items():
        flat = torch.cat([col.reshape(-1), col.new_empty(max_spills)])
        v = flat[src]
        flat[dst] = v
        flat[src] = torch.where(do, _SPILL_FILL[f], v)
        cols[f] = flat[:r * w].view(r, w)
    moved = torch.zeros(r, dtype=metrics.n_spills.dtype,
                        device=src.device).index_add_(
        0, torch.where(do, src // w, 0), do.to(metrics.n_spills.dtype))
    return TaskTable(**cols), metrics._replace(
        n_spills=metrics.n_spills + moved.reshape(metrics.n_spills.shape))
