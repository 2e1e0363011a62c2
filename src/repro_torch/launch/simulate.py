"""STEAM simulation runner: sustainability-technique sweeps from the CLI.

    PYTHONPATH=src python -m repro_torch.launch.simulate --workload surf \
        --techniques B,TS --regions 16 --days 14 [--scale 0.1] [--device cpu]

The paper's experiment runner: pick a workload (the synthetic Surf, Marconi
and Borg generators), a set of techniques and a number of carbon regions;
the regions run as one scenario grid (one step loop for all of them) on
`--device` (default the card), once with the techniques and once without,
and one JSON object reports carbon, energy and SLA metrics.  `--tasks-cap`
(default 4096) shrinks the datacenter with the workload: a full-scale run
passes a cap above the workload's task count (Marconi: 192,817).
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from repro_torch.carbontraces.synthetic import make_region_traces
from repro_torch.core import (BatteryConfig, FailureConfig, ShiftingConfig,
                              SimConfig, carbon_reduction_pct, sweep_regions,
                              with_scale)
from repro_torch.workloads.synthetic import SPECS, make_workload


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", choices=list(SPECS), default="surf")
    ap.add_argument("--techniques", default="",
                    help="comma list of B,TS (HS via --active-hosts)")
    ap.add_argument("--active-hosts", type=int, default=None,
                    help="horizontal scaling: power off all but N hosts")
    ap.add_argument("--scale", type=float, default=0.05,
                    help="shrink the datacenter and workload")
    ap.add_argument("--regions", type=int, default=8)
    ap.add_argument("--days", type=float, default=14.0)
    ap.add_argument("--dt", type=float, default=0.25)
    ap.add_argument("--battery-kwh", type=float, default=None,
                    help="default: 1.1 kWh/host (the paper's Surf optimum "
                         "315 kWh / 277 hosts, scale-invariant)")
    ap.add_argument("--failures", action="store_true")
    ap.add_argument("--tasks-cap", type=int, default=4096)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the simulation runs (cuda or cpu)")
    args = ap.parse_args(argv)

    tasks, hosts, spec, meta = make_workload(
        args.workload, scale=args.scale, seed=args.seed,
        n_tasks_cap=args.tasks_cap, dt_h=args.dt, horizon_days=args.days,
        device=args.device)
    if args.active_hosts is not None:
        hosts = with_scale(hosts, args.active_hosts)

    techs = set(filter(None, args.techniques.upper().split(",")))
    n_steps = int(args.days * 24 / args.dt)
    batt_kwh = (args.battery_kwh if args.battery_kwh is not None
                else 1.1 * meta["n_hosts"])
    cfg = SimConfig(
        dt_h=args.dt, n_steps=n_steps,
        battery=BatteryConfig(enabled="B" in techs,
                              capacity_kwh=batt_kwh),
        shifting=ShiftingConfig(enabled="TS" in techs),
        failures=FailureConfig(enabled=args.failures),
        embodied=meta["embodied"],
    )
    traces = make_region_traces(n_steps, args.dt, args.regions, args.seed)

    res = sweep_regions(tasks, hosts, traces, cfg, device=args.device)
    base_cfg = cfg.replace(battery=BatteryConfig(enabled=False),
                           shifting=ShiftingConfig(enabled=False))
    base = sweep_regions(tasks, hosts, traces, base_cfg, device=args.device)
    red = carbon_reduction_pct(base, res).cpu().numpy()
    host = lambda x: x.cpu().numpy()  # noqa: E731

    out = {
        "workload": args.workload, "techniques": args.techniques or "none",
        "regions": args.regions, "days": args.days,
        "n_tasks": int(meta["n_tasks"]), "n_hosts": int(meta["n_hosts"]),
        "mean_total_carbon_kg": round(float(np.mean(
            host(res.total_carbon_kg))), 2),
        "mean_reduction_pct": round(float(np.mean(red)), 3),
        "regions_with_negative_reduction": int(np.sum(red < 0)),
        "mean_sla_violation_pct": round(
            100 * float(np.mean(host(res.sla_violation_frac))), 3),
        "mean_task_delay_h": round(float(np.mean(host(res.mean_delay_h))),
                                   3),
        "peak_power_kw": round(float(np.max(host(res.peak_power_kw))), 2),
    }
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
