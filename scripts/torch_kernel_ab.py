#!/usr/bin/env python3
"""Time the port's simulator kernels and main path of two checkouts in turns
on one card.

    python3 scripts/torch_kernel_ab.py OLD_ROOT NEW_ROOT

Each turn starts a fresh process inside one checkout and runs that
checkout's own `chip_smoke.time_kernels` at the simulator's main-path
shapes (H = 972 hosts, 750 on; K = 64 candidates; S = 2880 steps), so each
side builds and times its own kernels and wrappers.  The turns run old,
new, new, old (A = OLD_ROOT, B = NEW_ROOT): two versions are compared only
within one run on one card, because host clocks and power limits differ
between machines.  Prints one JSON line per turn with, for each of the four
simulator kernels, the mean ms per call through the wrapper (CUDA events),
the device ms (profiler), and the plain version's ms; beside them the
outputs each side's kernels give on the same inputs: the facility kernel's
18 accumulator lanes at the main path's configuration, at a step of 0.1 h
(its divisions by the step then round) and with the main path's battery at
a tenth of its size, each lane as f32 bits (and its count of tiles run
with the division written out, where the kernel has that lane), and a
checksum of the power kernel's per-host power (`ci` None, as the
megakernel calls it).  Each turn first runs that checkout's
`chip_smoke.main_path` MAIN_REPS times (before any profiling: a run timed
after the profiler has been used pays its leftover host cost): one
full-scale Marconi `simulate` per step executor (192,817 tasks, 972 hosts,
750 on, 2880 steps) each time, after building that checkout's kernels,
giving every run's wall seconds and the outcome counts.  Then one line
per side and executor with its runs' walls sorted, a summary line saying
whether every turn gave the same bits and counts, and the card's name and
power limit.  Needs a CUDA card; exits non-zero if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = ("fused_power_carbon", "fused_facility_power", "first_fit_place",
           "fused_facility_totals")
KEYS = ("ms", "device_ms", "plain_ms", "launch_floor_ms", "device_ms_k0",
        "device_ms_year")
# full-scale runs of each step executor a turn (the host's spread between
# runs is as large as the effects compared)
MAIN_REPS = 3
# the facility row's lanes that come out of its chain and window walk:
# soc_final, window peak, was_charging, demand charge, grid peak
CHAIN_LANES = (0, 1, 2, 3, 7)

CHILD = f"""
import json, sys
sys.argv = ["chip_smoke.py"]
import torch
import chip_smoke as cs
from repro_torch.core import config as C
from repro_torch.kernels import build
# the main path first: a run timed after the profiler has been used pays
# its leftover host cost
dev = torch.device("cuda")
build.build_all()  # the first run would otherwise build the kernels
walls = {{}}
for _ in range({MAIN_REPS}):
    _, results, infos = cs.main_path(dev, 1.0, cs.MAIN_STEPS,
                                     cs.MARCONI_ACTIVE, True)
    for i in infos:
        walls.setdefault(i["backend"], []).append(i["wall_s"])
res = {{n: {{}} for n in build.KERNELS}}
cs.time_kernels(torch.device("cuda"), res,
                cs.main_config(cs.MAIN_STEPS, C.EmbodiedConfig()))
out = {{n: {{k: res[n].get(k) for k in {KEYS!r}}} for n in {KERNELS!r}}}
# the outputs: the same inputs on both sides, from seeds
import dataclasses, hashlib
from repro_torch.kernels import fused_step as fs_k, power_carbon as pc_k
dev = torch.device("cuda")
gen = torch.Generator(device=dev).manual_seed(11)
cu, gu, ng, on = (x[0] for x in cs._host_inputs(gen, 1, 972, dev))
on[cs.MARCONI_ACTIVE:] = 0.0
cfg = cs.main_config(cs.MAIN_STEPS, C.EmbodiedConfig())
power = pc_k.fused_power_carbon(cu, gu, ng, on, None, 0.0, cfg.cpu_power,
                                cfg.gpu_power)[0]
out["power_sha256"] = hashlib.sha256(
    power.cpu().numpy().tobytes()).hexdigest()
it_kw = 700.0 + 300.0 * torch.rand(cs.MAIN_STEPS, generator=gen, device=dev)
small = dataclasses.replace(cfg.battery,
                            capacity_kwh=cfg.battery.capacity_kwh / 10)
rows, slow = {{}}, {{}}
for name, c in (("main", cfg), ("dt_0.1", cfg.replace(dt_h=0.1)),
                ("small_battery", cfg.replace(battery=small))):
    args = cs.facility_args(c, it_kw, cs.facility_traces(cs.MAIN_STEPS, dev))
    acc = fs_k.launch(*fs_k.prepare(*args, c))[0].cpu()
    rows[name] = acc[:18].view(torch.int32).tolist()
    # a later kernel's 19th lane: the tiles its chain ran slow
    slow[name] = acc[18].item() if acc.numel() > 18 else None
out["facility_row_bits"] = rows
out["facility_slow_tiles"] = slow
out["main_path_wall_s"] = walls
out["main_path_counts"] = {{b: [float(r[k]) for k in ("n_done", "n_started",
                                                      "n_decided")]
                           for b, r in results.items()}}
print(json.dumps(out))
"""


def turn(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if out.returncode != 0:
        raise SystemExit(f"turn in {root} failed:\n{out.stderr[-4000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old_root")
    ap.add_argument("new_root")
    args = ap.parse_args()
    roots = {"A": os.path.abspath(args.old_root),
             "B": os.path.abspath(args.new_root)}
    outs = []
    for i, side in enumerate("ABBA"):
        outs.append(turn(roots[side]))
        print(json.dumps({"turn": i, "side": side, "root": roots[side],
                          "kernels": outs[-1]}), flush=True)
    chain = [{name: [row[i] for i in CHAIN_LANES]
              for name, row in o["facility_row_bits"].items()} for o in outs]
    for side in "AB":
        for backend in ("stage-pipeline", "megakernel"):
            runs = sorted(w for o, sd in zip(outs, "ABBA") if sd == side
                          for w in o["main_path_wall_s"][backend])
            print(json.dumps({"side": side, "backend": backend,
                              "main_path_wall_s_sorted": runs}), flush=True)
    print(json.dumps({"bit_equal_across_turns": {
        "power": all(o["power_sha256"] == outs[0]["power_sha256"]
                     for o in outs),
        "facility_chain_lanes": all(c == chain[0] for c in chain),
        "facility_all_lanes": all(o["facility_row_bits"]
                                  == outs[0]["facility_row_bits"]
                                  for o in outs),
        "main_path_counts": all(o["main_path_counts"]
                                == outs[0]["main_path_counts"]
                                for o in outs)}}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
