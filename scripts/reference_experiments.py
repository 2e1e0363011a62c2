#!/usr/bin/env python3
"""The reference package's answers for `chip_smoke.py`'s experiments phase.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_experiments.py

Runs the JAX reference (`src/repro/`) on the CPU at full-scale Marconi
(`make_workload("marconi", scale=1.0, seed=0)`: 192,817 tasks, 972 hosts,
2880 steps of 0.25 h) and prints, one JSON line each:

  * `aggregate`: the smoke test's main configuration (`chip_smoke.py`
    `main_config`: every technique, 750 active hosts, the same traces) with
    `scheduler.mode="aggregate"`, through both step executors: the outcome
    counts the smoke test holds the port's aggregate runs to exactly;
  * `sla_curve`: the SLA-violation fraction of the default configuration
    (no techniques, carbon region 0, megakernel) at 972, 750 and 600
    active hosts;
  * `scaling`: `find_min_scale` over that configuration (lo 1, hi 972) at
    the targets 0.01 and 0.80, with every scale it evaluated.

Each full-scale run takes 15-30 s on a few CPU cores; the whole script a
few minutes.  The port's phase 4b ("experiments") must reproduce these
numbers on the card.
"""
from __future__ import annotations

import json
import time

import numpy as np

from repro.carbontraces.synthetic import make_region_traces
from repro.core import (SimConfig, find_min_scale, simulate, summarize,
                        with_scale)
from repro.core import config as C
from repro.workloads.synthetic import make_workload

DT_H = 0.25
STEPS = 2880
ACTIVE = 750
COUNTS = ("n_done", "n_started", "n_decided", "n_tasks")


def facility_traces(s: int):
    """`chip_smoke.facility_traces` in numpy: carbon region 0 and the
    weather / price / PV sinusoids."""
    t = np.arange(s) * DT_H
    ci = make_region_traces(s, DT_H, 8, seed=0)[0]
    price = (0.1 * (1 + 0.5 * np.sin(2 * np.pi * t / 24))).astype(np.float32)
    wb = (14.0 + 6.0 * np.sin(2 * np.pi * t / 24)).astype(np.float32)
    cf = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0, 1.0).astype(
        np.float32)
    return ci, wb, price, cf


def main_config(embodied, n_hosts: int) -> SimConfig:
    """`chip_smoke.main_config` (9 kWh a host of battery)."""
    return SimConfig(
        dt_h=DT_H, n_steps=STEPS, embodied=embodied,
        cooling=C.CoolingConfig(enabled=True, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=True, billing_window_h=24.0),
        renewables=C.RenewableConfig(enabled=True, pv_capacity_kw=500.0),
        battery=C.BatteryConfig(enabled=True, capacity_kwh=9.0 * n_hosts),
        shifting=C.ShiftingConfig(enabled=True))


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def main() -> None:
    tasks, hosts, _, meta = make_workload("marconi", scale=1.0, seed=0,
                                          dt_h=DT_H, horizon_days=30.0)
    ci, wb, price, cf = facility_traces(STEPS)
    cfg = main_config(meta["embodied"], meta["n_hosts"]).replace(
        scheduler=C.SchedulerConfig(mode="aggregate"))
    dyn = {"n_active_hosts": ACTIVE, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        t0 = time.perf_counter()
        res = summarize(simulate(tasks, hosts, ci, c, dyn=dyn)[0], c)
        emit({"aggregate": backend, "seconds": time.perf_counter() - t0,
              **{k: float(getattr(res, k)) for k in COUNTS},
              "sla_violation_frac": float(res.sla_violation_frac),
              "total_carbon_kg": float(res.total_carbon_kg)})

    plain = SimConfig(dt_h=DT_H, n_steps=STEPS, embodied=meta["embodied"],
                      backend="megakernel")

    def sla(n: int) -> float:
        final, _ = simulate(tasks, with_scale(hosts, n), ci, plain)
        return float(summarize(final, plain).sla_violation_frac)

    emit({"sla_curve": {n: sla(n) for n in (972, 750, 600)}})
    for target in (0.01, 0.80):
        t0 = time.perf_counter()
        best, evaluated = find_min_scale(sla, 1, 972, target)
        emit({"scaling": target, "best": best,
              "evaluated": {str(k): v for k, v in evaluated.items()},
              "seconds": time.perf_counter() - t0})


if __name__ == "__main__":
    main()
