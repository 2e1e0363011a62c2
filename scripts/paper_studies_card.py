#!/usr/bin/env python3
"""The paper's scaling, battery-region, trade-off and analytical-gap studies
(Figs 5, 6, 9/14/15 and §III) over its three workloads on one card.

    python3 scripts/paper_studies_card.py --workloads surf,marconi,borg
    python3 scripts/paper_studies_card.py --workloads borg --studies battery_regions

Each workload is `make_workload(name, scale=1.0, seed=0)` over its whole
horizon in steps of 0.25 h (SURF 11,904 steps, Marconi 2880, Borg 2976) at
the Fig 11 study's slots a step (`chip_smoke.PAPER_SLOTS`: 256 / 64 / 4096),
every other subsystem at its default, through the megakernel.  The studies
are composed as the reference's benches compose them, which this script
reads as specifications (it imports neither JAX nor the reference):

  * `scaling` (`benchmarks/bench_scaling.py:26-61`): on carbon
    `make_region_traces(S, 0.25, 1, seed=1)[0]`, without and with host
    failures and checkpointing (`mtbf_h` 400, `repair_h` 4), single runs at
    0.25 / 0.5 / 0.65 / 0.8 / 1.0 of the hosts, `find_min_scale` at SLA
    0.01 over the whole horizon (lo 1, hi the host count) and the run at
    the scale it found;
  * `battery_regions` (`bench_battery_regions.py:18-40`): the base and the
    battery configuration (KWH_PER_HOST kWh a host) each one `sweep_grid`
    over `trace_axis` of the 158 regions of `make_region_traces(S, 0.25,
    158, seed=0)`;
  * `tradeoffs` (`bench_tradeoffs.py:25-73`): pricing on (a demand charge
    of 12 a kW), carbon `make_region_traces(S, 0.25, 2, seed=7)[1]`; none,
    B, TS and B+TS each one `sweep_grid` over `price_axis` of the tariffs
    `make_price_traces(S, 0.25, 2, seed=7)`; the cost-carbon front: B with
    the `blended` policy and `price_window_h` 48 over `dyn_axis(
    dispatch_lambda=(0, 0.5, 1))` x `price_axis`;
  * `analytical_gap` (`bench_analytical_gap.py:18-49`, SURF and Borg): on
    the 32 regions of `make_region_traces(S, 0.25, 32, seed=11)`, the §III
    oracle (`analytical_shifting_savings(..., oracle=True)` over every task)
    beside the simulated savings of the TS grid's `op_carbon_kg` against
    the base grid's (two `sweep_grid`s over `trace_axis`; the bench runs
    each region alone, and a grid's rows equal those runs).

Each function returns the bench's rows under the bench's field names
(values unrounded; the bench rounds them to 3 decimals) with a few fields
of its own.  Each part prints a JSON line (wall, launches, peak memory;
each grid its chunk plan and a PROFILE_STEPS-step profile: the idle share
and kernels 1, 3, 4 and 7's device ms a launch), the lines also going to
the git-ignored `results/paper_studies/<workload>.jsonl`; then the rows and
the benches' own check() verdicts (F1-F5, §XI), as findings.

Gates (a failed one raises, so the script exits non-zero): launch counts
exact on the card; every headline value finite; each grid's row 0 (and a
`price_axis` grid's row 1) equal to its single run (counts exact, totals
rtol 1e-5); the front's lambda = 1 rows equal to the carbon policy's B rows
on the same tariff bit for bit; the scaling search consistent with itself
(the scale it returns meets 0.01, the largest evaluated scale below it
misses, the run at that scale meets 0.01 and repeats the search's run);
SURF's and Borg's named single runs equal to the reference's records
(`tests/data/torch_paper_studies_reference.json`, made on the CPU by
`scripts/reference_experiments.py --studies`: counts exact, totals rtol
1e-4, the oracle's mean on regions 0-3 within ANALYTICAL_RTOL / _ATOL).

`--kernel-shapes` first times kernels 1-4 and the per-host sums at SURF's
and Borg's shapes with KERNEL_ROWS scenario rows beside their plain
versions (`chip_smoke.time_paper_shapes`), one line.  `--device cpu`
rehearses the studies without a card at REHEARSAL's size (a hundredth of
each workload, one day, fewer regions; no record gate).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
from types import SimpleNamespace
from typing import NamedTuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import chip_smoke as S  # noqa: E402
import numpy as np  # noqa: E402
import paper_workloads_card as W  # noqa: E402
import torch  # noqa: E402

from repro_torch.carbontraces import make_region_traces  # noqa: E402
from repro_torch.core import config as C  # noqa: E402
from repro_torch.core import (ScenarioGrid, analytical,  # noqa: E402
                              carbon_reduction_pct, dyn_axis, find_min_scale,
                              price_axis, result_to_numpy, sweep_grid,
                              trace_axis, with_scale)
from repro_torch.workloads import SPECS, make_workload  # noqa: E402

WORKLOADS = ("surf", "marconi", "borg")
STUDIES = ("scaling", "battery_regions", "tradeoffs", "analytical_gap")
# the analytical gap's workloads (bench_analytical_gap.py:64)
GAP_WORKLOADS = ("surf", "borg")
DT_H = S.DT_H
# the study's size (scale, days: None for the whole horizon, a task cap,
# the battery study's and the analytical gap's regions) and the CPU
# rehearsal's
FULL = {"scale": 1.0, "days": None, "cap": None, "battery_regions": 158,
        "gap_regions": 32}
REHEARSAL = {"scale": 0.01, "days": 1.0, "cap": None, "battery_regions": 8,
             "gap_regions": 4}
SLA_TARGET = 0.01
# bench_scaling.py:37: the shares of hosts of the SLA curve
FRACS = (0.25, 0.5, 0.65, 0.8, 1.0)
# the studies' grid rows (the trade-off grids 2 and 6, the analytical gap
# 32, the battery regions 158) and the Fig 11 study's (1, 24):
# `--kernel-shapes`
KERNEL_ROWS = (1, 2, 6, 24, 32, 158)
OUT_DIR = os.path.join(ROOT, "results", "paper_studies")
PROFILE_STEPS = W.PROFILE_STEPS


class Workload(NamedTuple):
    """A workload's tables at a size, its study's base configuration and
    battery (kWh)."""
    name: str
    tasks: object
    hosts: object
    meta: dict
    steps: int
    base: C.SimConfig
    kwh: float


def load_workload(name: str, size: dict, dev) -> Workload:
    """`make_workload(name, size["scale"], seed=0)` over `size["days"]`
    (None: the whole horizon), at most `size["cap"]` tasks, on `dev`."""
    days = size["days"] or SPECS[name].horizon_days
    tasks, hosts, _, meta = make_workload(
        name, scale=size["scale"], seed=0, dt_h=DT_H, horizon_days=days,
        n_tasks_cap=size["cap"], device=dev)
    steps = int(round(days * 24 / DT_H))
    base = S.paper_config(name, steps, meta["embodied"]).replace(
        backend="megakernel")
    return Workload(name, tasks, hosts, meta, steps, base,
                    S.STUDY_KWH_PER_HOST[name] * meta["n_hosts"])


def on_card(dev) -> bool:
    return torch.device(dev).type == "cuda"


def _finite(out: dict, what: str) -> None:
    for k in S.PAPER_TOTALS:
        S.check(bool(np.all(np.isfinite(out[k]))), f"{what}: {k} not finite")


def single(wl: Workload, cfg, ci, dyn, dev, what: str,
           hosts=None) -> tuple[dict, dict]:
    """One megakernel run (summarised, as numpy) and its measured info;
    its launch counts exact on the card, its totals finite."""
    out, info = S.run_backend(wl.tasks, wl.hosts if hosts is None else hosts,
                              ci, cfg, dyn, "megakernel", dev)
    if on_card(dev):
        S.expect_launches(info, S.run_launches("megakernel", cfg.n_steps),
                          what)
    _finite(out, what)
    return out, info


def grid(wl: Workload, cfg, axes_of, dev, emit, label: str,
         ci_trace=None, dyn=None, singles=()) -> dict:
    """One `sweep_grid` of `axes_of(n_steps)`'s axes, chunked from the
    card's free memory; its launch counts exact on the card, its totals
    finite; the flattened rows `singles` ((index, ci, dyn), ...) each equal
    to its own single run (counts exact, totals rtol 1e-5); a
    PROFILE_STEPS-step profile on the card.  Returns the result as numpy
    (fields of the grid's shape)."""
    budget = None
    if on_card(dev):
        # the caching allocator's free blocks are free for the grid too
        torch.cuda.empty_cache()
        budget = 0.8 * torch.cuda.mem_get_info(dev)[0]
    axes = axes_of(cfg.n_steps)
    g = ScenarioGrid(axes, base_dyn=dyn)
    chunk = g._auto_chunk_size(wl.tasks, wl.hosts, cfg, budget)
    n_chunks = -(-g.shape[0] // chunk)
    res, info = S.measured(lambda: sweep_grid(
        wl.tasks, wl.hosts, cfg, axes, ci_trace, dyn=dyn,
        memory_budget_bytes=budget, device=dev), dev)
    out = result_to_numpy(res)
    what = f"{wl.name} {label} grid"
    if on_card(dev):
        S.expect_launches(info, S.run_launches("megakernel", cfg.n_steps,
                                               n_chunks=n_chunks), what)
    _finite(out, what)
    rel = {}
    for i, ci, sdyn in singles:
        one, _ = single(wl, cfg, ci, sdyn, dev, f"{what} row {i} single run")
        rel[i] = max(S.paper_same(S.flat_row(out, i), one, 1e-5,
                                  f"{what} row {i} vs its single run")
                     .values())
    p = min(PROFILE_STEPS, cfg.n_steps)
    cfg_p = cfg.replace(n_steps=p)
    axes_p = axes_of(p)
    ci_p = None if ci_trace is None else ci_trace[:p]
    prof = W.window_profile(lambda: sweep_grid(
        wl.tasks, wl.hosts, cfg_p, axes_p, ci_p, dyn=dyn,
        memory_budget_bytes=budget, device=dev), torch.device(dev))
    rows = int(np.prod(g.shape))
    emit({"part": "grid", "grid": label, "shape": list(g.shape),
          "rows": rows, "chunk_size": chunk, "n_chunks": n_chunks,
          "budget_bytes": budget, **info,
          "sim_years_per_s": rows * cfg.n_steps * DT_H / C.HOURS_PER_YEAR
          / info["wall_s"],
          "rows_max_rel_diff_to_single_runs": rel,
          "profile_steps": p, "profile": prof})
    return out


def _held(out: dict, record, what: str):
    """`out` against a record of the reference's (None: not held)."""
    if record is None:
        return None
    return max(S.paper_same(out, record, 1e-4, f"{what} vs the records")
               .values())


# --------------------------------------------------------------------------
# Fig 5 (F1 / F2): horizontal scaling against SLA and carbon
# --------------------------------------------------------------------------

def scaling_study(wl: Workload, dev, emit, records=None) -> list:
    """`bench_scaling.run`'s two rows of one workload (failures off, on).
    Runs are deterministic, so a scale the sweep or the search has run is
    not run again, except the reduction run, which must repeat it."""
    dev = torch.device(dev)
    trace = torch.as_tensor(make_region_traces(wl.steps, DT_H, 1, seed=1)[0],
                            device=dev)
    n_hosts = int(wl.meta["n_hosts"])
    rows = []
    for failures in (False, True):
        cfg = S.study_failures(wl.base, failures)
        runs: dict = {}

        def run(n: int, again: bool = False) -> dict:
            if n not in runs or again:
                out, info = single(wl, cfg, trace, None, dev,
                                   f"{wl.name} scaling {failures} n={n}",
                                   hosts=with_scale(wl.hosts, n))
                emit({"part": "scaling_run", "failures": failures,
                      "n_active_hosts": n, "repeat": n in runs,
                      "sla_violation_frac": float(out["sla_violation_frac"]),
                      "total_carbon_kg": float(out["total_carbon_kg"]),
                      **{k: info[k] for k in ("wall_s", "launches",
                                              "max_memory_allocated")}})
                if n in runs:
                    return out
                runs[n] = out
            return runs[n]

        def sla_and_carbon(n: int, again: bool = False) -> tuple:
            out = run(n, again)
            return (float(out["sla_violation_frac"]),
                    float(out["total_carbon_kg"]),
                    float(out["op_carbon_kg"]),
                    max(float(out["done_frac"]), 1e-3))

        t0 = time.perf_counter()
        sweep = {f: sla_and_carbon(max(int(n_hosts * f), 1)) for f in FRACS}
        best, evaluated = find_min_scale(lambda n: sla_and_carbon(n)[0],
                                         lo=1, hi=n_hosts, target=SLA_TARGET)
        reachable = best <= n_hosts
        full = sweep[1.0]
        red, red_sla = 0.0, None
        if reachable:
            again = sla_and_carbon(best, again=True)
            red_sla = again[0]
            red = 100.0 * (1 - again[1] / full[1])
            S.check(again == sla_and_carbon(best),
                    f"{wl.name} scaling {failures}: the run at {best} hosts "
                    "does not repeat the search's")
        # the search's consistency: the scale found meets the target, the
        # largest evaluated scale below it misses, the reduction run meets
        slas = {n: o["sla_violation_frac"] for n, o in runs.items()}
        below = [n for n in slas if n < best]
        if reachable:
            S.check(slas[best] <= SLA_TARGET and red_sla <= SLA_TARGET,
                    f"{wl.name} scaling {failures}: {best} hosts miss the "
                    f"SLA ({slas[best]}, {red_sla})")
        if below:
            S.check(slas[max(below)] > SLA_TARGET,
                    f"{wl.name} scaling {failures}: {max(below)} hosts, "
                    f"below the {best} found, meet the SLA")
        held = None
        if failures and records is not None:
            held = _held(runs[max(int(n_hosts * 0.5), 1)],
                         records["runs"]["scaling_failures_half"],
                         f"{wl.name} scaling, failures, half the hosts")
        row = {"bench": "scaling", "workload": wl.name, "failures": failures,
               "full_hosts": n_hosts,
               "min_scale_hosts": int(best) if reachable else None,
               "metric": "carbon_reduction_at_min_scale_pct", "value": red,
               "sla_curve": {str(f): 100 * s[0] for f, s in sweep.items()},
               "op_carbon_curve": {str(f): s[2] for f, s in sweep.items()},
               "op_per_done_curve": {str(f): s[2] / s[3]
                                     for f, s in sweep.items()},
               "search_evaluated": {str(n): float(v)
                                    for n, v in evaluated.items()},
               "min_scale_sla": red_sla, "runs": len(runs),
               "rel_diff_to_reference": held,
               "seconds": time.perf_counter() - t0}
        emit({"part": "scaling", **row})
        rows.append(row)
    return rows


def scaling_verdicts(rows: list) -> list:
    """`bench_scaling.check` (F1 / F2) of one workload's rows."""
    by = {r["failures"]: r for r in rows}
    nf, wf, wl = by[False], by[True], rows[0]["workload"]
    out = [f"F1 {wl}: down-scaling saves {nf['value']:.3f}% total carbon "
           f"({'OK' if nf['value'] > 0 else 'FAIL'})"]
    if nf["min_scale_hosts"] and wf["min_scale_hosts"]:
        ok = wf["min_scale_hosts"] >= nf["min_scale_hosts"]
        out.append(f"F1 {wl}: failures raise min scale "
                   f"{nf['min_scale_hosts']}->{wf['min_scale_hosts']} "
                   f"({'OK' if ok else 'FAIL'})")
    sla = {float(k): v for k, v in nf["sla_curve"].items()}
    opc = {float(k): v for k, v in nf["op_per_done_curve"].items()}
    delta = abs(opc[0.25] - opc[1.0]) / opc[1.0]
    ok = sla[0.25] > 20.0 and delta < 0.6
    out.append(f"F2 {wl}: under-provision SLA {sla[0.25]:.3f}% vs "
               f"op-carbon/work delta {delta:.0%} "
               f"({'OK' if ok else 'WEAK'})")
    return out


# --------------------------------------------------------------------------
# Fig 6 (F3): batteries across carbon regions
# --------------------------------------------------------------------------

def battery_regions_study(wl: Workload, n_regions: int, dev, emit) -> dict:
    """`bench_battery_regions.run`'s row of one workload."""
    dev = torch.device(dev)
    traces = torch.as_tensor(make_region_traces(wl.steps, DT_H, n_regions,
                                                seed=0), device=dev)
    axes_of = lambda n: [trace_axis(traces[:, :n])]  # noqa: E731
    singles = ((0, traces[0], None),)
    t0 = time.perf_counter()
    base = grid(wl, wl.base, axes_of, dev, emit, "battery_regions base",
                singles=singles)
    treated = grid(wl, wl.base.replace(battery=C.BatteryConfig(
        enabled=True, capacity_kwh=wl.kwh)), axes_of, dev, emit,
        "battery_regions B", singles=singles)
    red = carbon_reduction_pct(*(SimpleNamespace(
        total_carbon_kg=torch.as_tensor(g["total_carbon_kg"]))
        for g in (base, treated))).numpy()
    row = {"bench": "battery_regions", "workload": wl.name,
           "regions": n_regions, "metric": "mean_reduction_pct",
           "value": float(red.mean()),
           "frac_ge_5pct": float((red >= 5).mean()),
           "frac_negative": float((red < 0).mean()),
           "best_pct": float(red.max()), "worst_pct": float(red.min()),
           "seconds": time.perf_counter() - t0}
    emit({"part": "battery_regions", **row})
    return row


def battery_verdicts(row: dict) -> list:
    """`bench_battery_regions.check` (F3)."""
    ok = (row["frac_ge_5pct"] > 0.05 and row["frac_negative"] > 0.05
          and -2.0 < row["value"] < 15.0)
    return [f"F3 {row['workload']}: mean {row['value']:.3f}%, >=5% in "
            f"{row['frac_ge_5pct']:.0%}, negative in "
            f"{row['frac_negative']:.0%} of regions "
            f"({'OK' if ok else 'WEAK'})"]


# --------------------------------------------------------------------------
# Figs 9 / 14 / 15 (F4, F5, §XI): the trade-offs with pricing on
# --------------------------------------------------------------------------

def tradeoffs_study(wl: Workload, dev, emit, records=None) -> list:
    """`bench_tradeoffs.run`'s rows of one workload: the four combinations
    over the two tariffs, then the lambda x tariff front."""
    dev = torch.device(dev)
    cfgs = S.study_configs(wl.base, wl.kwh)
    trace, prices = S.study_tariff_traces(wl.steps, dev)
    tariffs = lambda n: [price_axis(prices[:, :n])]  # noqa: E731
    t0 = time.perf_counter()
    rows, grids = [], {}
    for name in ("none", "B", "TS", "B+TS"):
        c = cfgs[name]
        res = grid(wl, c, tariffs, dev, emit, f"tradeoffs {name}", trace,
                   singles=[(p, trace, {"price_trace": prices[p]})
                            for p in (0, 1)])
        grids[name] = res
        cell = lambda f, p=0: float(res[f][p])  # noqa: E731
        row = {"bench": "tradeoffs", "workload": wl.name, "combo": name,
               "metric": "peak_power_kw", "value": cell("peak_power_kw"),
               "mean_delay_h": cell("mean_delay_h"),
               "energy_mwh": float(res["dc_energy_kwh"][0] / 1000.0),
               "grid_energy_mwh": float(res["grid_energy_kwh"][0] / 1000.0),
               "energy_cost": cell("energy_cost"),
               "demand_cost": cell("demand_cost"),
               "total_cost": cell("total_cost"),
               "total_cost_alt_tariff": cell("total_cost", 1),
               "n_done": cell("n_done")}
        if name == "B+TS" and records is not None:
            row["rel_diff_to_reference"] = _held(
                S.flat_row(res, 1), records["runs"]["tradeoffs_bts_tariff1"],
                f"{wl.name} tradeoffs B+TS tariff 1")
        rows.append(row)
    # the cost-carbon front: lambda x tariff in one grid (blended dispatch)
    lam = np.asarray(S.STUDY_LAMBDAS, np.float32)
    front_axes = lambda n: [dyn_axis(dispatch_lambda=lam),  # noqa: E731
                            price_axis(prices[:, :n])]
    singles = [(i * 2 + p, trace, {"dispatch_lambda": lam[i],
                                   "price_trace": prices[p]})
               for i, p in ((0, 0), (0, 1), (1, 0))]
    front = grid(wl, cfgs["front"], front_axes, dev, emit, "tradeoffs front",
                 trace, singles=singles)
    held = None
    if records is not None:
        held = _held(S.flat_row(front, 2),
                     records["runs"]["front_blended_lambda0.5_tariff0"],
                     f"{wl.name} front lambda 0.5 tariff 0")
    # lambda = 1 is the carbon policy, bit for bit (the reference's
    # guarantee), whatever the tariff
    for p in (0, 1):
        for k in S.STUDY_EXACT:
            a, b = front[k][len(S.STUDY_LAMBDAS) - 1, p], grids["B"][k][p]
            S.check(np.array_equal(a, b), f"{wl.name} front lambda 1 tariff "
                    f"{p}: {k} {a} != the carbon policy's {b}")
    for i, lv in enumerate(S.STUDY_LAMBDAS):
        rows.append({"bench": "tradeoffs", "workload": wl.name,
                     "combo": f"B(lambda={lv})", "metric": "total_cost",
                     "value": float(front["total_cost"][i, 0]),
                     "total_carbon_kg": float(front["total_carbon_kg"][i, 0]),
                     "peak_power_kw": float(front["peak_power_kw"][i, 0]),
                     "n_done": float(front["n_done"][i, 0])})
    rows[-2]["rel_diff_to_reference"] = held
    emit({"part": "tradeoffs", "rows": rows,
          "front_lambda1_is_carbon_policy": True,
          "seconds": time.perf_counter() - t0})
    return rows


def tradeoffs_verdicts(rows: list) -> list:
    """`bench_tradeoffs.check` (F4, F5, §XI) of one workload's rows."""
    by = {r["combo"]: r for r in rows}
    wl = rows[0]["workload"]
    spike = by["B"]["value"] / max(by["none"]["value"], 1e-9)
    out = [f"F4 {wl}: battery peak-power spike x{spike:.1f} "
           f"({'OK' if spike > 1.3 else 'WEAK'})"]
    d_ts = by["TS"]["mean_delay_h"] - by["none"]["mean_delay_h"]
    d_b = abs(by["B"]["mean_delay_h"] - by["none"]["mean_delay_h"])
    out.append(f"F5 {wl}: TS adds {d_ts:.2f}h delay, B adds {d_b:.2f}h "
               f"({'OK' if d_ts > 0.5 and d_b < 0.1 else 'WEAK'})")
    de = abs(by["TS"]["energy_mwh"] - by["none"]["energy_mwh"])
    out.append(f"F5 {wl}: TS energy delta {de:.2f} MWh (idle-draw effect)")
    dc_up = by["B"]["demand_cost"] - by["none"]["demand_cost"]
    out.append(f"§XI {wl}: battery demand-charge delta {dc_up:+.1f} "
               f"({'OK' if dc_up > 0 else 'WEAK'}: spikes are billed)")
    lams = S.STUDY_LAMBDAS
    c0, c1 = by[f"B(lambda={lams[0]})"], by[f"B(lambda={lams[-1]})"]
    out.append(f"§XI {wl}: Pareto ends cost {c0['value']:.1f} vs "
               f"{c1['value']:.1f}, carbon {c0['total_carbon_kg']:.1f} vs "
               f"{c1['total_carbon_kg']:.1f} "
               f"({'OK' if c0['value'] <= c1['value'] * 1.02 else 'WEAK'}: "
               "price dispatch should not cost more)")
    return out


# --------------------------------------------------------------------------
# §III (F5): the analytical strawman against full simulation
# --------------------------------------------------------------------------

def analytical_gap_study(wl: Workload, n_regions: int, dev, emit,
                         records=None) -> dict:
    """`bench_analytical_gap.run`'s row of one workload, the simulated
    savings from two grids over the regions."""
    dev = torch.device(dev)
    traces = torch.as_tensor(make_region_traces(wl.steps, DT_H, n_regions,
                                                seed=11), device=dev)
    arr, dur = wl.tasks.arrival, wl.tasks.duration
    valid = torch.isfinite(arr)
    t0 = time.perf_counter()
    oracle, info = S.measured(lambda: [float(
        analytical.analytical_shifting_savings(
            arr[valid], dur[valid], traces[r], DT_H, oracle=True,
            device=dev)[0]) for r in range(n_regions)], dev)
    emit({"part": "analytical_oracle", "regions": n_regions,
          "n_tasks": int(valid.sum()), **info})
    for m in oracle:
        S.check(math.isfinite(m), f"{wl.name} oracle savings {m}")
    if records is not None:
        want = records["oracle_mean_pct"]
        S._close(torch.tensor(oracle[:len(want)], dtype=torch.float64),
                 torch.tensor(want, dtype=torch.float64), S.ANALYTICAL_RTOL,
                 S.ANALYTICAL_ATOL, f"{wl.name} oracle means vs the records")
    axes_of = lambda n: [trace_axis(traces[:, :n])]  # noqa: E731
    singles = ((0, traces[0], None),)
    base = grid(wl, wl.base, axes_of, dev, emit, "analytical_gap base",
                singles=singles)
    ts_cfg = wl.base.replace(shifting=C.ShiftingConfig(enabled=True))
    ts = grid(wl, ts_cfg, axes_of, dev, emit, "analytical_gap TS",
              singles=singles)
    sim = [100.0 * (1 - float(ts["op_carbon_kg"][r])
                    / float(base["op_carbon_kg"][r]))
           for r in range(n_regions)]
    row = {"bench": "analytical_gap", "workload": wl.name,
           "metric": "oracle_mean_savings_pct",
           "value": float(np.mean(oracle)),
           "sim_mean_savings_pct": float(np.mean(sim)),
           "gap_x": float(np.mean(oracle) / max(np.mean(sim), 0.1)),
           "regions": n_regions, "seconds": time.perf_counter() - t0}
    emit({"part": "analytical_gap", **row})
    return row


def gap_verdicts(row: dict) -> list:
    """`bench_analytical_gap.check` (F5 / §III)."""
    ok = row["value"] > row["sim_mean_savings_pct"] + 1.0
    return [f"F5/§III {row['workload']}: analytical oracle claims "
            f"{row['value']:.3f}% vs simulated "
            f"{row['sim_mean_savings_pct']:.3f}% ({row['gap_x']:.3f}x "
            f"optimistic) ({'OK' if ok else 'WEAK'})"]


# --------------------------------------------------------------------------

def run_workload(name: str, studies: tuple, size: dict, dev, records: dict,
                 emit) -> None:
    """The chosen studies, in their order, on one workload at `size` (FULL
    on the card, where SURF and Borg are held to the records; REHEARSAL on
    the CPU)."""
    t0 = time.perf_counter()
    wl = load_workload(name, size, dev)
    rec = records.get(name, {}).get("full") if size == FULL else None
    emit({"part": "setup", "n_tasks": int(wl.meta["n_tasks"]),
          "n_hosts": int(wl.meta["n_hosts"]), "n_steps": wl.steps,
          "slots_per_step": S.PAPER_SLOTS[name], "battery_kwh": wl.kwh,
          "scale": size["scale"], "seconds": time.perf_counter() - t0})
    if size == FULL and name in records:
        now = {"n_tasks": wl.meta["n_tasks"], "n_hosts": wl.meta["n_hosts"],
               "n_steps": wl.steps, "slots_per_step": S.PAPER_SLOTS[name]}
        S.check(now == {k: rec[k] for k in now},
                f"{name}: {now} is not the records' size")
    verdicts = []
    for study in studies:
        if study == "scaling":
            verdicts += scaling_verdicts(scaling_study(wl, dev, emit, rec))
        elif study == "battery_regions":
            verdicts += battery_verdicts(battery_regions_study(
                wl, size["battery_regions"], dev, emit))
        elif study == "tradeoffs":
            verdicts += tradeoffs_verdicts(tradeoffs_study(wl, dev, emit,
                                                           rec))
        elif name in GAP_WORKLOADS:
            verdicts += gap_verdicts(analytical_gap_study(
                wl, size["gap_regions"], dev, emit, rec))
    emit({"part": "summary", "studies": list(studies), "verdicts": verdicts,
          "seconds": time.perf_counter() - t0})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workloads", default=",".join(WORKLOADS))
    ap.add_argument("--studies", default=",".join(STUDIES))
    ap.add_argument("--kernel-shapes", action="store_true",
                    help="first time kernels 1-4 and the per-host sums at "
                         "SURF's and Borg's shapes at KERNEL_ROWS rows "
                         "beside their plain versions (card only)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal at REHEARSAL's size, without "
                         "the record gates")
    args = ap.parse_args()
    studies = tuple(args.studies.split(","))
    S.check(set(studies) <= set(STUDIES), f"unknown study in {studies}")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("paper_studies_card: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    size = FULL if dev.type == "cuda" else REHEARSAL
    records = {}
    if size == FULL:
        with open(S.STUDY_RECORDS) as f:
            records = json.load(f)["workloads"]
    os.makedirs(OUT_DIR, exist_ok=True)
    smi = (subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
           if dev.type == "cuda" else "no card")
    if args.kernel_shapes and dev.type == "cuda":
        t0 = time.perf_counter()
        res = {n: {} for n in ("fused_power_carbon", "fused_facility_power",
                               "first_fit_place", "fused_facility_totals",
                               "per_host_sum")}
        S.time_paper_shapes(dev, res, rows=KERNEL_ROWS, plain=True)
        print(json.dumps({"part": "kernel_shapes", "nvidia_smi": smi,
                          "rows": KERNEL_ROWS,
                          "results": {k: v["paper_shapes"]
                                      for k, v in res.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)
    for name in args.workloads.split(","):
        path = os.path.join(OUT_DIR, f"{name}.jsonl")
        with open(path, "a") as log:
            def emit(obj, name=name, log=log):
                line = json.dumps({"workload": name, "nvidia_smi": smi,
                                   **obj})
                print(line, flush=True)
                log.write(line + "\n")
                log.flush()
            run_workload(name, studies, size, dev, records, emit)
    print(json.dumps({"ok": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
