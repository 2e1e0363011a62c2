#!/usr/bin/env python3
"""The Fig 12 scenario grid spread over the cards of one host.

    torchrun --nproc-per-node 4 scripts/mesh_grid_cards.py
    torchrun --nproc-per-node 4 scripts/mesh_grid_cards.py --device cpu

(the second a rehearsal on gloo ranks at a small scale, 192 steps).

One process a card, NCCL (`launch.mesh.init_distributed`; the loopback for
NCCL's bootstrap unless NCCL_SOCKET_IFNAME is set).  Full-scale Marconi at
`chip_smoke.py`'s main configuration on the megakernel, as the grids of
its phase 4c: 8 carbon regions x 2 and x 8 battery sizes (B = 16 and 64).
For each grid every rank first runs the whole grid unsharded on its own
card, then through `sweep_grid(mesh=)` on a (N,) ("data",) mesh and
through `executor="shard_map"`: each rank runs B / N cells and the fields
are gathered.  On every rank the outcome counts must equal the unsharded
run's exactly and every other field within the reference's grid contract
(rtol 1e-5, atol 1e-6; `tests/test_grid.py`); whether they are the same
bits is reported beside it, with the fields that differ and by how much
(a CUDA reduction over a [B, T] tensor picks its order from the whole
shape, so a row's last bits may move with the rows beside it).  Rank 0
prints the card's name and power limit, then one JSON line a run: its
wall (host clock from a barrier to a synchronise on every rank), the
slowest rank's wall, peak device memory and launch counts; and last
`{"ok": true, ...}`.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402


def main() -> int:
    cpu = "--device" in sys.argv and sys.argv[sys.argv.index(
        "--device") + 1] == "cpu"
    scale, steps, active = (0.02, 192, 15) if cpu else (
        1.0, S.MAIN_STEPS, S.MARCONI_ACTIVE)
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rank, world = M.init_distributed("cpu" if cpu else "cuda")
    dev = (torch.device("cpu") if cpu
           else torch.device("cuda", torch.cuda.current_device()))
    if rank == 0 and not cpu:
        build.build_all()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        print(json.dumps({"nvidia_smi": smi, "world": world,
                          "torch": torch.__version__}), flush=True)
    dist.barrier()
    mesh = M.make_mesh((world,), ("data",), device_type=dev.type)
    tasks, hosts, _, meta = S.make_workload(
        "marconi", scale=scale, seed=0, dt_h=S.DT_H,
        horizon_days=steps * S.DT_H / 24, device=dev)
    cfg = S.main_config(steps, meta["embodied"],
                        meta["n_hosts"]).replace(backend="megakernel")
    _, wb, price, cf = S.facility_traces(steps, dev)
    dyn = {"n_active_hosts": active, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}

    def timed(fn):
        dist.barrier()
        out, info = S.measured(fn, dev)
        walls = [None] * world
        dist.all_gather_object(walls, info["wall_s"])
        return out, {**info, "slowest_rank_wall_s": max(walls)}

    ok = True
    for r, c in ((8, 2), (8, 8)):
        axes = S.grid_axes(r, c, steps, cfg.battery.capacity_kwh)
        want = None
        for executor, m in (("unsharded", None), ("chunked", mesh),
                            ("shard_map", mesh)):
            out, info = timed(lambda: S.result_to_numpy(S.sweep_grid(
                tasks, hosts, cfg, axes, dyn=dyn, mesh=m,
                executor="chunked" if executor == "unsharded" else executor,
                device=dev)))
            if want is None:
                want = out
            diff = {k: float(np.max(np.abs(out[k].astype(np.float64)
                                           - want[k].astype(np.float64))
                                    / (np.abs(want[k].astype(np.float64))
                                       + 1e-30)))
                    for k in want if not np.array_equal(out[k], want[k])}
            good = (not any(k in diff for k in S.COUNTS + ("n_interrupts",))
                    and all(np.allclose(out[k], want[k], rtol=1e-5,
                                        atol=1e-6) for k in want))
            flags = [None] * world
            dist.all_gather_object(flags, (not diff, good, diff))
            ok &= all(f[1] for f in flags)
            if rank == 0:
                b = r * c
                years = b * cfg.n_steps * cfg.dt_h / S.C.HOURS_PER_YEAR
                print(json.dumps({
                    "grid": [r, c], "cells": b, "executor": executor,
                    "cards": 1 if m is None else world,
                    "cells_per_card": b if m is None else b // world,
                    "bit_equal_on_every_rank": all(f[0] for f in flags),
                    "within_contract_on_every_rank": all(f[1]
                                                         for f in flags),
                    "max_rel_diff_rank0": flags[0][2],
                    "wall_s": info["wall_s"],
                    "slowest_rank_wall_s": info["slowest_rank_wall_s"],
                    "sim_years_per_s": years / info["slowest_rank_wall_s"],
                    "max_memory_allocated": info["max_memory_allocated"],
                    "launches": {k: v for k, v in info["launches"].items()
                                 if v}}), flush=True)
    M.shutdown()
    if rank == 0:
        print(json.dumps({"ok": bool(ok), "device": None if cpu else {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
