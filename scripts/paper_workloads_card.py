#!/usr/bin/env python3
"""The paper's Fig 11 study (F5 / F6) over its three workloads on one card.

    python3 scripts/paper_workloads_card.py --workloads surf,marconi,borg
    python3 scripts/paper_workloads_card.py --workloads borg     # one a call

For each workload (`make_workload(name, scale=1.0, seed=0)` over its whole
horizon in steps of 0.25 h: SURF 11,904 steps, Marconi 2880, Borg 2976;
`slots_per_step` 256 / 64 / 4096, the smallest power of two at or above the
most arrivals in any step, Marconi the main cell's 64), in the
configurations of `benchmarks/bench_combinations.py` (every other subsystem
at its default; the carbon traces `make_region_traces(S, 0.25, 24,
seed=0)`, region 0 for single runs):

  * the HS search: `find_min_scale` at the SLA target 0.01 (lo 1, hi the
    host count) over the base configuration's first 672 steps (megakernel);
  * single runs on region 0: R1, the base configuration through both step
    executors; R2, HS+B+TS (megakernel); and each other combination
    (megakernel), the single run its grid's row 0 is held to;
  * the base grid and the 7 combinations of {HS, B, TS}, each one
    `sweep_grid` over `trace_axis` of the 24 regions (megakernel), composed
    as `bench_combinations.run` composes them: B a battery of
    KWH_PER_HOST kWh a host, TS temporal shifting, HS the search's host
    count as the `n_active_hosts` dyn value;
  * a profiled window (PROFILE_STEPS steps) of each grid's 24 rows: the
    device's idle share and the kernels' device ms at these shapes.

Each part prints a JSON line (wall, sim-yr/s, peak device memory, launch
counts, the grid's chunk count: kernel 3 launches once a chunk); each
combination a row: mean / median / p90 of `carbon_reduction_pct` against
the base grid, mean delay, peak power, SLA fraction, the `techniques`
label.  Gates (a failed one raises, so the script exits non-zero): launch
counts exact on the card; each grid's row 0 equals its single run (counts
exact, totals rtol 1e-5); SURF's and Borg's R1, R2 and search equal the
reference's records (`tests/data/torch_paper_workloads_reference.json`,
made on the CPU by `scripts/reference_experiments.py --workloads`: counts
and `n_hs` exact, the SLA fraction at every evaluated scale exact, totals
rtol 1e-4); Marconi's search equals `chip_smoke.py`'s SCALING_KAT at 0.01
(960 hosts).  The lines also go to the git-ignored
`results/paper_workloads/<workload>.jsonl`.

`--device cpu` rehearses it without a card at REHEARSAL's size (a
hundredth of each workload, one day, 4 regions; no record gate).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as S  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.carbontraces import make_region_traces  # noqa: E402
from repro_torch.core import config as C  # noqa: E402
from repro_torch.core import (ScenarioGrid, carbon_reduction_pct,  # noqa: E402
                              find_min_scale, result_to_numpy, simulate,
                              summarize, sweep_grid, techniques, trace_axis,
                              with_scale)
from repro_torch.workloads import SPECS, make_workload  # noqa: E402

WORKLOADS = ("surf", "marconi", "borg")
DT_H = S.DT_H
# battery kWh a host (benchmarks/common.py KWH_PER_HOST)
KWH_PER_HOST = {"surf": 1.1, "marconi": 9.0, "borg": 2.2}
# the study's size (scale, days: None for the whole horizon, carbon
# regions) and the CPU rehearsal's
FULL = {"scale": 1.0, "days": None, "regions": S.PAPER_REGIONS}
REHEARSAL = {"scale": 0.01, "days": 1.0, "regions": 4}
SLA_TARGET = 0.01
# bench_combinations.COMBOS: itertools.combinations("HBT", r), r = 1..3
COMBOS = ("H", "B", "T", "HB", "HT", "BT", "HBT")
# the single runs held to the reference's records, by their record's name
RECORD_RUNS = {"base_megakernel": "base_megakernel",
               "base_stage-pipeline": "base_stage-pipeline",
               "HBT_megakernel": "hs_b_ts_megakernel"}
OUT_DIR = os.path.join(ROOT, "results", "paper_workloads")
PROFILE_STEPS = 32
WATCH = ("first_fit", "power_carbon_kernel", "host_sum",
         "facility_totals_kernel")


def combo_config(cfg, combo: str, kwh: float):
    c = cfg
    if "B" in combo:
        c = c.replace(battery=C.BatteryConfig(enabled=True, capacity_kwh=kwh))
    if "T" in combo:
        c = c.replace(shifting=C.ShiftingConfig(enabled=True))
    return c


def window_profile(fn, dev) -> dict:
    """`fn` (a run over PROFILE_STEPS steps) under the profiler after one
    unprofiled call: the device's idle share and the step kernels' device
    ms a launch."""
    if dev.type != "cuda":
        return {"profile": "not measured (no card)"}
    fn()
    row = S.profiled(fn, top_n=4, watch=WATCH)
    row["watched_ms_a_launch"] = {k["name"]: k["device_ms"] / k["count"]
                                  for k in row.pop("watched_kernels")}
    return row


def run_workload(name: str, size: dict, dev, records: dict, emit) -> None:
    """The study on one workload at `size` (FULL, or REHEARSAL on the CPU,
    where only the gates that need no record or card apply)."""
    t_wl = time.perf_counter()
    full, on = size == FULL, dev.type == "cuda"
    days = size["days"] or SPECS[name].horizon_days
    steps = int(round(days * 24 / DT_H))
    regions = size["regions"]
    t0 = time.perf_counter()
    tasks, hosts, _, meta = make_workload(
        name, scale=size["scale"], seed=0, dt_h=DT_H, horizon_days=days,
        device=dev)
    traces = torch.as_tensor(make_region_traces(steps, DT_H, regions,
                                                seed=0), device=dev)
    kwh = KWH_PER_HOST[name] * meta["n_hosts"]
    base = S.paper_config(name, steps, meta["embodied"]).replace(
        backend="megakernel")
    emit({"part": "setup", "n_tasks": int(meta["n_tasks"]),
          "n_hosts": int(meta["n_hosts"]), "n_steps": steps,
          "slots_per_step": S.PAPER_SLOTS[name], "battery_kwh": kwh,
          "regions": regions, "scale": size["scale"],
          "seconds": time.perf_counter() - t0})
    rec = records.get(name) if full else None
    if full and name != "marconi":
        size_now = {"n_tasks": meta["n_tasks"], "n_hosts": meta["n_hosts"],
                    "n_steps": steps, "slots_per_step": S.PAPER_SLOTS[name]}
        S.check(rec is not None and size_now == {k: rec[k] for k in size_now},
                f"{name}: {size_now} is not the records' size")

    # the HS search (carbon-independent: no technique reads the trace)
    cfg_s = base.replace(n_steps=min(S.SCALING_STEPS, steps))
    ci_s = traces[0, :cfg_s.n_steps]

    def sla(n: int) -> float:
        final, _ = simulate(tasks, with_scale(hosts, n), ci_s, cfg_s,
                            device=dev)
        return float(summarize(final, cfg_s).sla_violation_frac)
    (best, evaluated), info = S.measured(
        lambda: find_min_scale(sla, 1, meta["n_hosts"], SLA_TARGET), dev)
    n_hs = min(best, meta["n_hosts"])
    emit({"part": "search", "best": best, "n_hs": n_hs,
          "evaluated": {str(k): v for k, v in evaluated.items()},
          "wall_s": info["wall_s"],
          "max_memory_allocated": info["max_memory_allocated"]})
    if rec is not None:
        want = rec["search"]
        S.check((best, n_hs, {str(k): v for k, v in evaluated.items()})
                == (want["best"], want["n_hs"], want["evaluated"]),
                f"{name} search: {best} {evaluated} != the records' {want}")
    if name == "marconi" and full:
        S.check((best, evaluated) == S.SCALING_KAT[SLA_TARGET],
                f"marconi search: {best} {evaluated} != SCALING_KAT")

    # single runs on region 0
    singles = {}
    for key, backend, combo in (
            ("base_megakernel", "megakernel", ""),
            ("base_stage-pipeline", "stage-pipeline", ""),
            *((f"{c}_megakernel", "megakernel", c) for c in COMBOS)):
        cfg = combo_config(base, combo, kwh).replace(backend=backend)
        dyn = {"n_active_hosts": n_hs} if "H" in combo else None
        out, info = S.run_backend(tasks, hosts, traces[0], cfg, dyn, backend,
                                  dev)
        singles[key] = out
        if on:
            S.expect_launches(info, S.run_launches(backend, steps),
                              f"{name} {key}")
        for k in S.PAPER_TOTALS:
            S.check(bool(np.isfinite(out[k])), f"{name} {key}: {k} not "
                    "finite")
        line = {"part": "single", "run": key,
                "techniques": techniques(cfg, horizontal_scaling=bool(dyn)),
                **{k: info[k] for k in ("wall_s", "launches",
                                        "max_memory_allocated",
                                        "sim_years_per_s")},
                "n_done": float(out["n_done"]),
                "total_carbon_kg": float(out["total_carbon_kg"]),
                "sla_violation_frac": float(out["sla_violation_frac"])}
        if rec is not None and key in RECORD_RUNS:
            line["rel_diff_to_reference"] = S.paper_same(
                out, rec["runs"][RECORD_RUNS[key]], 1e-4,
                f"{name} {key} vs the records")
        emit(line)
    # the executors' gap beside the reference's own
    gap = {"card": S.paper_same(singles["base_stage-pipeline"],
                                singles["base_megakernel"], float("inf"),
                                f"{name} executors")}
    if rec is not None:
        gap["reference"] = S.paper_rel_diff(
            rec["runs"]["base_stage-pipeline"], rec["runs"]["base_megakernel"])
    emit({"part": "executor_gap", "rel_diff": gap})

    # the grids: base, then the 7 combinations over the regions, chunked
    # from the card's free memory (the default budget, 4 GiB, would cut
    # Borg's 24 rows into chunks: a step loop each)
    if on:
        # the caching allocator's free blocks are free for the grid too
        torch.cuda.empty_cache()
    budget = 0.8 * torch.cuda.mem_get_info(dev)[0] if on else None
    years = regions * steps * DT_H / C.HOURS_PER_YEAR
    grids = {}
    for combo in ("", *COMBOS):
        cfg = combo_config(base, combo, kwh)
        dyn = {"n_active_hosts": n_hs} if "H" in combo else None
        axes = [trace_axis(traces)]
        chunk = ScenarioGrid(axes, base_dyn=dyn)._auto_chunk_size(
            tasks, hosts, cfg, budget)
        n_chunks = -(-regions // chunk)
        res, info = S.measured(lambda: sweep_grid(
            tasks, hosts, cfg, axes, dyn=dyn, memory_budget_bytes=budget,
            device=dev), dev)
        out = result_to_numpy(res)
        grids[combo] = (res, out)
        label = techniques(cfg, horizontal_scaling="H" in combo) or "base"
        if on:
            S.expect_launches(info, S.run_launches("megakernel", steps,
                                                   n_chunks=n_chunks),
                              f"{name} grid {label}")
        key = f"{combo}_megakernel" if combo else "base_megakernel"
        rel = S.paper_same({k: v[0] for k, v in out.items()}, singles[key],
                           1e-5, f"{name} grid {label} row 0 vs its single "
                           "run")
        # where the time goes: the first PROFILE_STEPS steps of the grid
        cfg_p = cfg.replace(n_steps=min(PROFILE_STEPS, steps))
        axes_p = [trace_axis(traces[:, :cfg_p.n_steps])]
        prof = window_profile(lambda: sweep_grid(
            tasks, hosts, cfg_p, axes_p, dyn=dyn,
            memory_budget_bytes=budget, device=dev), dev)
        emit({"part": "grid", "combo": label, "rows": regions,
              "chunk_size": chunk, "n_chunks": n_chunks,
              "budget_bytes": budget, **info,
              "sim_years_per_s": years / info["wall_s"],
              "row0_max_rel_diff": max(rel.values()),
              "profile_steps": cfg_p.n_steps, "profile": prof})
    base_res = grids[""][0]
    rows = []
    for combo in COMBOS:
        res, out = grids[combo]
        red = carbon_reduction_pct(base_res, res).cpu().numpy()
        rows.append({
            "combo": techniques(combo_config(base, combo, kwh),
                                horizontal_scaling="H" in combo),
            "hs_hosts": n_hs,
            "mean_reduction_pct": float(np.mean(red)),
            "median_reduction_pct": float(np.median(red)),
            "p90_reduction_pct": float(np.quantile(red, 0.9)),
            "mean_delay_h": float(np.mean(out["mean_delay_h"])),
            "peak_power_kw": float(np.max(out["peak_power_kw"])),
            "sla_violation_frac": float(np.mean(out["sla_violation_frac"]))})
    emit({"part": "combinations", "rows": rows})
    by = {r["combo"]: r["mean_reduction_pct"] for r in rows}
    emit({"part": "summary", "n_hs": n_hs,
          "f5_ts_alone_pct": by["TS"],
          "f6_b_ts_vs_sum": [by["B+TS"], by["B"] + by["TS"]],
          "seconds": time.perf_counter() - t_wl})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal at REHEARSAL's size, without "
                         "the record gates")
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("paper_workloads_card: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    with open(S.PAPER_RECORDS) as f:
        records = json.load(f)["workloads"]
    size = FULL if dev.type == "cuda" else REHEARSAL
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
           if dev.type == "cuda" else "no card")
    for name in args.workloads.split(","):
        path = os.path.join(OUT_DIR, f"{name}.jsonl")
        with open(path, "w") as log:
            def emit(obj, name=name, log=log):
                line = json.dumps({"workload": name, "nvidia_smi": smi,
                                   **obj})
                print(line, flush=True)
                log.write(line + "\n")
                log.flush()
            run_workload(name, size, dev, records, emit)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
