#!/usr/bin/env python3
"""Time the port's simulator kernels of two checkouts in turns on one card.

    python3 scripts/torch_kernel_ab.py OLD_ROOT NEW_ROOT

Each turn starts a fresh process inside one checkout and runs that
checkout's own `chip_smoke.time_kernels` at the simulator's main-path
shapes (H = 972 hosts, 750 on; K = 64 candidates; S = 2880 steps), so each
side builds and times its own kernels and wrappers.  The turns run old,
new, new, old (A = OLD_ROOT, B = NEW_ROOT): two versions are compared only
within one run on one card, because host clocks and power limits differ
between machines.  Prints one JSON line per turn with, for each of the four
simulator kernels, the mean ms per call through the wrapper (CUDA events),
the device ms (profiler), and the plain version's ms; then the card's name
and power limit.  Needs a CUDA card; exits non-zero if a turn fails.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

KERNELS = ("fused_power_carbon", "fused_facility_power", "first_fit_place",
           "fused_facility_totals")
KEYS = ("ms", "device_ms", "plain_ms", "launch_floor_ms", "device_ms_k0")

CHILD = f"""
import json, sys
sys.argv = ["chip_smoke.py"]
import torch
import chip_smoke as cs
from repro_torch.core import config as C
from repro_torch.kernels import build
res = {{n: {{}} for n in build.KERNELS}}
cs.time_kernels(torch.device("cuda"), res,
                cs.main_config(cs.MAIN_STEPS, C.EmbodiedConfig()))
print(json.dumps({{n: {{k: res[n].get(k) for k in {KEYS!r}}}
                  for n in {KERNELS!r}}}))
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
    for i, side in enumerate("ABBA"):
        print(json.dumps({"turn": i, "side": side, "root": roots[side],
                          "kernels": turn(roots[side])}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
