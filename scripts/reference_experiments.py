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
    (no techniques, carbon region 0, megakernel) over its first
    SCALING_STEPS steps (7 days) at 972, 750 and 600 active hosts;
  * `scaling`: `find_min_scale` over that configuration (lo 1, hi 972) at
    the targets 0.01 and 0.80, with every scale it evaluated;
  * `fleet_greedy`: the smoke test's fleet (`chip_smoke.py` phase 4d): the
    main configuration over the 8 synthetic regions (carbon and weather of
    seed 0, the main path's price and PV traces shared), 750 active hosts
    a region, greedy placement at `capacity_frac=1.5`, through both step
    executors: the tasks placed in each region, each region's outcome
    counts and the fleet's totals;
  * `fleet_policies`: the same fleet under `round_robin` and `spill`
    placement (megakernel): placement and per-region counts;
  * `fleet_spill`: the greedy fleet at full width with host failures,
    checkpointing, the closed resilience loop and the cross-region spill
    (`spill_interrupted`, 4 spills a step, seeds 1-8 one a region; stage
    pipeline), and the same fleet without the spill: per-region counts,
    interrupts and spills.

Each full-scale run takes 15-30 s on a few CPU cores (a full-width fleet a
few minutes); the whole script about half an hour.  The port's phases 4b
("experiments") and 4d ("fleet") must reproduce these numbers on the card.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_experiments.py --train

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_experiments.py --scaling

prints only the `sla_curve` and `scaling` lines (a few minutes).

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_experiments.py --train

prints instead the reference's carbon-aware training reports that
`chip_smoke.py`'s phase 7c (d) and (e) hold the port to (a few minutes):

  * `carbon_aware`: `train/carbon_aware.py` in the three setups of
    `TRAIN_SETUPS` (the reference's two test setups on reduced qwen2, and
    `examples/carbon_aware_training.py`'s widened reduced qwen2 over 200
    steps of 2 minutes): steps, pauses, failures, restores, the hours and
    the carbon sums;
  * `train_cli`: `python -m repro.launch.train --arch qwen2-1.5b --reduced
    --steps 20 --carbon-aware --failures 0.02`'s JSON line.

The schedule does not depend on the model's numbers, so the port's
reports must equal these whatever weights it trains.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_experiments.py --workloads

writes instead `tests/data/torch_paper_workloads_reference.json`: the
reference's answers for the paper's other two workloads at full scale
(`make_workload("surf" | "borg", scale=1.0, seed=0)`, each over its whole
horizon in steps of 0.25 h, `slots_per_step` 256 / 4096: the smallest power
of two at or above the most arrivals in any step), in the configurations of
the Fig 11 study (`benchmarks/bench_combinations.py`; carbon region 0 of
`make_region_traces(S, 0.25, 24, seed=0)`, every other subsystem at its
default):

  * `search`: `find_min_scale` at the SLA target 0.01 (lo 1, hi the host
    count) over the base configuration's first SEARCH_STEPS steps
    (megakernel), with every scale it evaluated;
  * `base_stage-pipeline`, `base_megakernel` (R1): the base configuration
    through both step executors;
  * `hs_b_ts_megakernel` (R2): the battery (KWH_PER_HOST kWh a host),
    temporal shifting and the search's host count (megakernel);

each run's SimResult fields, `n_tasks`, `n_hosts`, `n_steps`, the slots and
its CPU seconds.  `--workloads surf` (or `borg`) runs one workload and
keeps the other's records.  A full run takes about 40 minutes on 8 CPU
cores (Borg's search alone 13): `chip_smoke.py`'s phase 4g and
`scripts/paper_workloads_card.py` hold the port to it.

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/reference_experiments.py --studies surf

writes instead `tests/data/torch_paper_studies_reference.json`: the
reference's answers for the named single runs of the paper's scaling,
trade-off and analytical-gap studies (`benchmarks/bench_scaling.py`,
`bench_tradeoffs.py`, `bench_analytical_gap.py`, composed as they compose
them) on SURF or Borg (`make_workload(name, scale=1.0, seed=0)` at the
Fig 11 study's slots a step, megakernel), at two sizes: the whole horizon
(`full`) and STUDIES_SMOKE_DAYS days at full width (`smoke`):

  * `scaling_failures_half`: Fig 5's run at half the hosts (`max(int(H *
    0.5), 1)` active) with host failures and checkpointing (`mtbf_h` 400,
    `repair_h` 4) on carbon `make_region_traces(S, 0.25, 1, seed=1)[0]`;
  * `tradeoffs_bts_tariff1`: Fig 9's B+TS with pricing on (a demand
    charge of 12 a kW) on carbon `make_region_traces(S, 0.25, 2,
    seed=7)[1]` and tariff 1 of `make_price_traces(S, 0.25, 2, seed=7)`;
  * `front_blended_lambda0.5_tariff0`: the cost-carbon front's battery
    (the `blended` policy, `price_window_h` 48) at `dispatch_lambda` 0.5
    on tariff 0;
  * `oracle_mean_pct`: the §III analytical oracle's mean savings over
    every task on regions 0-3 of `make_region_traces(S, 0.25, 32,
    seed=11)`;

each run's SimResult fields and its CPU seconds.  One workload a call
(SURF ~12 minutes, Borg ~30 on 8 CPU cores); the other's records are kept.
`scripts/paper_studies_card.py` and `chip_smoke.py`'s phase 4h hold the
port to them.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import time

import numpy as np

from repro.carbontraces.synthetic import make_region_traces
from repro.core import (FleetSpec, SimConfig, find_min_scale, simulate,
                        simulate_fleet, summarize, with_scale)
from repro.core import config as C
from repro.core.fleet import fleet_place
from repro.weathertraces.synthetic import make_weather_traces
from repro.workloads.synthetic import SPECS, make_workload

DT_H = 0.25
STEPS = 2880
# the scaling search's and SLA curve's horizon: 7 days (chip_smoke.py's
# SCALING_STEPS; a search is a dozen serial full-scale runs)
SCALING_STEPS = 672
ACTIVE = 750
COUNTS = ("n_done", "n_started", "n_decided", "n_tasks")
REGIONS = 8
# the fleet's PDU clamp while a PDU is down (kW a region): about 0.8 of a
# region's mean IT draw in the greedy fleet
FLEET_PDU_CAP_KW = 240.0
FLEET_TOTALS = ("total_carbon_kg", "op_carbon_kg", "emb_carbon_kg",
                "grid_energy_kwh", "dc_energy_kwh", "it_energy_kwh",
                "cooling_energy_kwh", "water_l", "energy_cost", "demand_cost",
                "total_cost", "pv_energy_kwh", "grid_export_kwh",
                "peak_power_kw", "batt_discharged_kwh", "sla_violation_frac",
                "done_frac")


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


def fleet_spec(policy: str = "greedy") -> FleetSpec:
    """`chip_smoke.fleet_spec`: the 8 synthetic regions' carbon and
    weather (seed 0), 750 active hosts a region, `capacity_frac=1.5`."""
    return FleetSpec(ci_traces=make_region_traces(STEPS, DT_H, REGIONS,
                                                  seed=0),
                     wb_traces=make_weather_traces(STEPS, DT_H, REGIONS,
                                                   seed=0),
                     n_active_hosts=ACTIVE, capacity_frac=1.5, policy=policy)


def fleet_resilience(cfg: SimConfig, spill: bool) -> SimConfig:
    """`chip_smoke.fleet_resilience`: phase 4a's failures, checkpointing
    and closed loop (seed 1, heat-correlated failures x2, reactive
    placement) with the fleet's PDU clamp, and the cross-region spill."""
    return cfg.replace(
        seed=1, failures=C.FailureConfig(enabled=True, checkpointing=True),
        resilience=C.ResilienceConfig(
            enabled=True, reactive_placement=True, heat_hazard_mult=2.0,
            pdu_cap_kw=FLEET_PDU_CAP_KW, spill_interrupted=spill,
            max_spills_per_step=4))


def placement(region: np.ndarray) -> dict:
    """Tasks placed in each region, and a digest of the region ids."""
    return {"placed": np.bincount(region[region >= 0],
                                  minlength=REGIONS).tolist(),
            "region_sha1": hashlib.sha1(
                np.asarray(region, np.int32).tobytes()).hexdigest()}


def fleet_numbers(res, extra=()) -> dict:
    """Per-region counts (and `extra` fields) and the fleet's totals."""
    per = {k: np.asarray(getattr(res.per_region, k)).tolist()
           for k in (*COUNTS, *extra)}
    return {"per_region": per,
            "total": {k: float(getattr(res.total, k)) for k in FLEET_TOTALS}}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def fleet_main(tasks, hosts, meta) -> None:
    """The `fleet_*` lines."""
    _, _, price, cf = facility_traces(STEPS)
    dyn = {"price_trace": price, "pv_cf_trace": cf}
    cfg = main_config(meta["embodied"], meta["n_hosts"])
    region = fleet_place(tasks, hosts, fleet_spec(), DT_H, n_steps=STEPS)
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        t0 = time.perf_counter()
        out = fleet_numbers(simulate_fleet(tasks, hosts, c, fleet_spec(),
                                           dyn=dyn, region=region))
        emit({"fleet_greedy": backend, "seconds": time.perf_counter() - t0,
              **placement(region), **out})
    c = cfg.replace(backend="megakernel")
    for policy in ("round_robin", "spill"):
        t0 = time.perf_counter()
        reg = fleet_place(tasks, hosts, fleet_spec(policy), DT_H,
                          n_steps=STEPS)
        out = fleet_numbers(simulate_fleet(tasks, hosts, c,
                                           fleet_spec(policy), dyn=dyn,
                                           region=reg))
        emit({"fleet_policies": policy, "seconds": time.perf_counter() - t0,
              **placement(reg), **out})
    spill_keys = ("n_interrupts", "n_spills", "lost_work_h", "throttled_h",
                  "derate_h")
    seeds = {"seed": np.arange(1, REGIONS + 1, dtype=np.int32)}
    for spill in (True, False):
        c = fleet_resilience(cfg, spill)
        t0 = time.perf_counter()
        out = fleet_numbers(simulate_fleet(
            tasks, hosts, c, fleet_spec(), dyn={**dyn, **seeds},
            region=region, width=tasks.n), spill_keys)
        emit({"fleet_spill": spill, "seconds": time.perf_counter() - t0,
              **out})


# the carbon-aware setups of chip_smoke.py's phase 7c (d): name -> (model
# (reduced qwen2, or the example's widening of it), batch, seq, lr, warm-up,
# total, steps, the trace, CarbonAwareConfig fields)
TRAIN_SETUPS = {
    "square_wave": dict(model="reduced", batch=2, seq=32, lr=1e-3, warmup=1,
                        total=50, steps=16, trace="square",
                        ca=dict(ckpt_every=5, step_time_s=3600.0,
                                shifting=True, failure_prob_per_step=0.0,
                                seed=0)),
    "failures": dict(model="reduced", batch=2, seq=32, lr=1e-3, warmup=1,
                     total=50, steps=10, trace="flat",
                     ca=dict(ckpt_every=3, step_time_s=2.0, shifting=False,
                             failure_prob_per_step=0.3, seed=5)),
    "example": dict(model="widened", batch=8, seq=128, lr=3e-4, warmup=20,
                    total=200, steps=200, trace="region4",
                    ca=dict(ckpt_every=50, step_time_s=120.0, power_kw=80.0,
                            idle_power_kw=2.0, shifting=True,
                            failure_prob_per_step=0.01, seed=0)),
}
TRAIN_CLI = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "20",
             "--carbon-aware", "--failures", "0.02"]


def train_trace(name: str) -> np.ndarray:
    if name == "square":
        return np.tile(np.r_[np.full(12, 100.0), np.full(12, 900.0)], 30)
    if name == "flat":
        return np.full(100, 100.0)
    return make_region_traces(24 * 30, dt_h=1.0, n_regions=1, seed=4)[0]


def train_main() -> None:
    """The `carbon_aware` and `train_cli` lines."""
    import contextlib
    import io
    import tempfile

    import jax
    import jax.numpy as jnp
    from repro.configs import reduced
    from repro.core.config import ShiftingConfig
    from repro.data.pipeline import DataConfig, TokenPipeline
    from repro.launch import train as cli
    from repro.models.registry import get_model
    from repro.train.carbon_aware import (CarbonAwareConfig,
                                          run_carbon_aware_training)
    from repro.train.optimizer import AdamWConfig
    from repro.train.step import TrainConfig, init_train_state
    for name, st in TRAIN_SETUPS.items():
        cfg = reduced("qwen2-1.5b")
        if st["model"] == "widened":
            cfg = cfg.replace(n_layers=4, d_model=256, n_heads=8,
                              n_kv_heads=2, head_dim=32, d_ff=768, vocab=4096)
        model = get_model(cfg)
        tcfg = TrainConfig(opt=AdamWConfig(lr=st["lr"],
                                           warmup_steps=st["warmup"],
                                           total_steps=st["total"]))
        state = init_train_state(model, jax.random.PRNGKey(0), tcfg)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=st["seq"],
                                        global_batch=st["batch"]))
        ca = dict(st["ca"])
        ca["shifting"] = ShiftingConfig(enabled=ca["shifting"])
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as d:
            _, rep = run_carbon_aware_training(
                model, tcfg, state,
                lambda s: {k: jnp.asarray(v)
                           for k, v in pipe.batch_at(s).items()},
                st["steps"], train_trace(st["trace"]),
                CarbonAwareConfig(ckpt_dir=d, **ca))
        emit({"carbon_aware": name, "seconds": time.perf_counter() - t0,
              **{k: getattr(rep, k) for k in (
                  "steps_done", "n_pauses", "n_failures", "n_restores",
                  "paused_hours", "busy_hours", "sim_hours", "op_carbon_kg",
                  "baseline_carbon_kg")},
              "first_losses": rep.losses[:3], "last_losses": rep.losses[-3:]})
    out = io.StringIO()
    with tempfile.TemporaryDirectory() as d, contextlib.redirect_stdout(out):
        cli.main(TRAIN_CLI + ["--ckpt-dir", d])
    emit({"train_cli": TRAIN_CLI,
          **json.loads(out.getvalue().strip().splitlines()[-1])})


# the Fig 11 study's workloads (benchmarks/bench_combinations.py): slots a
# step (the smallest power of two at or above the most arrivals in any step
# of 0.25 h at full scale), battery kWh a host (benchmarks/common.py)
PAPER_WORKLOADS = ("surf", "borg")
PAPER_SLOTS = {"surf": 256, "borg": 4096}
KWH_PER_HOST = {"surf": 1.1, "borg": 2.2}
STUDY_REGIONS = 24
SEARCH_STEPS = SCALING_STEPS
SLA_TARGET = 0.01
WORKLOADS_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "..", "tests", "data",
                                 "torch_paper_workloads_reference.json")


def result_fields(res) -> dict:
    """Every field of a SimResult as floats (the per-class ones as lists)."""
    out = {}
    for k, v in res._asdict().items():
        if v is None:
            continue
        a = np.asarray(v)
        out[k] = a.tolist() if a.ndim else float(a)
    return out


def workloads_main(argv: list) -> None:
    """The `--workloads` records (see the module docstring)."""
    import jax
    names = argv[argv.index("--workloads") + 1:][:1]
    names = (names[0].split(",") if names and not names[0].startswith("--")
             else list(PAPER_WORKLOADS))
    try:
        with open(WORKLOADS_FIXTURE) as f:
            record = json.load(f)
    except FileNotFoundError:
        record = {}
    record.update({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python3 "
                   "scripts/reference_experiments.py --workloads",
        "jax": jax.__version__, "scale": 1.0, "seed": 0, "dt_h": DT_H,
        "regions": STUDY_REGIONS, "region": 0, "search_steps": SEARCH_STEPS,
        "sla_target": SLA_TARGET})
    record.setdefault("workloads", {})
    for name in names:
        tasks, hosts, _, meta = make_workload(name, scale=1.0, seed=0,
                                              dt_h=DT_H)
        steps = int(round(SPECS[name].horizon_days * 24 / DT_H))
        ci = make_region_traces(steps, DT_H, STUDY_REGIONS, seed=0)[0]
        slots = PAPER_SLOTS[name]
        kwh = KWH_PER_HOST[name] * meta["n_hosts"]
        base = SimConfig(dt_h=DT_H, n_steps=steps, embodied=meta["embodied"],
                         scheduler=C.SchedulerConfig(slots_per_step=slots))
        rec = {"n_tasks": int(meta["n_tasks"]),
               "n_hosts": int(meta["n_hosts"]), "n_steps": steps,
               "slots_per_step": slots, "battery_kwh": kwh, "runs": {}}
        search_cfg = base.replace(n_steps=SEARCH_STEPS, backend="megakernel")

        def sla(n: int) -> float:
            final, _ = simulate(tasks, with_scale(hosts, n),
                                ci[:SEARCH_STEPS], search_cfg)
            return float(summarize(final, search_cfg).sla_violation_frac)
        t0, w0 = time.process_time(), time.perf_counter()
        best, evaluated = find_min_scale(sla, 1, meta["n_hosts"], SLA_TARGET)
        rec["search"] = {"best": best, "n_hs": min(best, meta["n_hosts"]),
                         "evaluated": {str(k): v
                                       for k, v in evaluated.items()},
                         "cpu_seconds": time.process_time() - t0,
                         "seconds": time.perf_counter() - w0}
        emit({"workload": name, "search": rec["search"]})
        runs = (("base_megakernel", base.replace(backend="megakernel"), {}),
                ("base_stage-pipeline", base.replace(
                    backend="stage-pipeline"), {}),
                ("hs_b_ts_megakernel", base.replace(
                    backend="megakernel",
                    battery=C.BatteryConfig(enabled=True, capacity_kwh=kwh),
                    shifting=C.ShiftingConfig(enabled=True)),
                 {"n_active_hosts": rec["search"]["n_hs"]}))
        for key, cfg, dyn in runs:
            t0, w0 = time.process_time(), time.perf_counter()
            res = summarize(simulate(tasks, hosts, ci, cfg, dyn=dyn)[0], cfg)
            rec["runs"][key] = {"backend": cfg.backend, "dyn": dyn,
                                "techniques": C.techniques(
                                    cfg, horizontal_scaling=bool(dyn)),
                                "cpu_seconds": time.process_time() - t0,
                                "seconds": time.perf_counter() - w0,
                                **result_fields(res)}
            emit({"workload": name, "run": key,
                  "cpu_seconds": rec["runs"][key]["cpu_seconds"],
                  "n_done": rec["runs"][key]["n_done"],
                  "total_carbon_kg": rec["runs"][key]["total_carbon_kg"]})
        record["workloads"][name] = rec
        with open(WORKLOADS_FIXTURE, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")


# the studies' records (scripts/paper_studies_card.py): the smoke's size in
# days (full width), the half-scale failure run's share of hosts and its
# failure model (bench_scaling.py:34-36), the trade-off study's demand
# charge, the front's lambda and price window (bench_tradeoffs.py:470-504),
# the analytical gap's regions (bench_analytical_gap.py:63) and those
# recorded
STUDIES_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "..", "tests", "data",
                               "torch_paper_studies_reference.json")
STUDIES_SMOKE_DAYS = 2.0
STUDY_FAILURES = {"mtbf_h": 400.0, "repair_h": 4.0, "checkpointing": True}
DEMAND_CHARGE_PER_KW = 12.0
FRONT_LAMBDA = 0.5
FRONT_PRICE_WINDOW_H = 48.0
GAP_REGIONS = 32
ORACLE_REGIONS = 4


def study_runs(name: str, days) -> dict:
    """The records of one workload at one size (`days` None: the whole
    horizon)."""
    from repro.core.analytical import analytical_shifting_savings
    from repro.pricetraces.synthetic import make_price_traces
    tasks, hosts, _, meta = make_workload(name, scale=1.0, seed=0, dt_h=DT_H,
                                          horizon_days=days)
    days = days or SPECS[name].horizon_days
    steps = int(round(days * 24 / DT_H))
    kwh = KWH_PER_HOST[name] * meta["n_hosts"]
    base = SimConfig(dt_h=DT_H, n_steps=steps, embodied=meta["embodied"],
                     backend="megakernel",
                     scheduler=C.SchedulerConfig(
                         slots_per_step=PAPER_SLOTS[name]))
    rec = {"days": days, "n_tasks": int(meta["n_tasks"]),
           "n_hosts": int(meta["n_hosts"]), "n_steps": steps,
           "slots_per_step": PAPER_SLOTS[name], "battery_kwh": kwh,
           "runs": {}}
    half = max(int(meta["n_hosts"] * 0.5), 1)
    priced = base.replace(pricing=C.PricingConfig(
        enabled=True, demand_charge_per_kw=DEMAND_CHARGE_PER_KW))
    ci7 = make_region_traces(steps, DT_H, 2, seed=7)[1]
    prices = make_price_traces(steps, DT_H, 2, seed=7)
    runs = (("scaling_failures_half",
             base.replace(failures=C.FailureConfig(enabled=True,
                                                   **STUDY_FAILURES)),
             with_scale(hosts, half),
             make_region_traces(steps, DT_H, 1, seed=1)[0], None,
             {"n_active_hosts": half}),
            ("tradeoffs_bts_tariff1",
             priced.replace(battery=C.BatteryConfig(enabled=True,
                                                    capacity_kwh=kwh),
                            shifting=C.ShiftingConfig(enabled=True)),
             hosts, ci7, {"price_trace": prices[1]}, {"tariff": 1}),
            ("front_blended_lambda0.5_tariff0",
             priced.replace(battery=C.BatteryConfig(
                 enabled=True, capacity_kwh=kwh, policy="blended",
                 price_window_h=FRONT_PRICE_WINDOW_H)),
             hosts, ci7, {"dispatch_lambda": np.float32(FRONT_LAMBDA),
                          "price_trace": prices[0]},
             {"dispatch_lambda": FRONT_LAMBDA, "tariff": 0}))
    for key, cfg, h, ci, dyn, what in runs:
        t0, w0 = time.process_time(), time.perf_counter()
        res = summarize(simulate(tasks, h, ci, cfg, dyn=dyn)[0], cfg)
        rec["runs"][key] = {**what, "cpu_seconds": time.process_time() - t0,
                            "seconds": time.perf_counter() - w0,
                            **result_fields(res)}
        emit({"workload": name, "days": days, "run": key,
              "cpu_seconds": rec["runs"][key]["cpu_seconds"],
              "n_done": rec["runs"][key]["n_done"],
              "total_carbon_kg": rec["runs"][key]["total_carbon_kg"]})
    arr, dur = np.asarray(tasks.arrival), np.asarray(tasks.duration)
    valid = np.isfinite(arr)
    traces = make_region_traces(steps, DT_H, GAP_REGIONS, seed=11)
    t0 = time.process_time()
    rec["oracle_mean_pct"] = [
        float(analytical_shifting_savings(arr[valid], dur[valid], traces[r],
                                          DT_H, oracle=True)[0])
        for r in range(ORACLE_REGIONS)]
    rec["oracle_cpu_seconds"] = time.process_time() - t0
    emit({"workload": name, "days": days,
          "oracle_mean_pct": rec["oracle_mean_pct"]})
    return rec


def studies_main(argv: list) -> None:
    """The `--studies` records (see the module docstring)."""
    import jax
    names = argv[argv.index("--studies") + 1:][:1]
    names = (names[0].split(",") if names and not names[0].startswith("--")
             else list(PAPER_WORKLOADS))
    try:
        with open(STUDIES_FIXTURE) as f:
            record = json.load(f)
    except FileNotFoundError:
        record = {}
    record.update({
        "command": "PYTHONPATH=src JAX_PLATFORMS=cpu python3 "
                   "scripts/reference_experiments.py --studies <workload>",
        "jax": jax.__version__, "scale": 1.0, "seed": 0, "dt_h": DT_H,
        "smoke_days": STUDIES_SMOKE_DAYS, "failures": STUDY_FAILURES,
        "demand_charge_per_kw": DEMAND_CHARGE_PER_KW,
        "front_lambda": FRONT_LAMBDA,
        "front_price_window_h": FRONT_PRICE_WINDOW_H,
        "gap_regions": GAP_REGIONS, "oracle_regions": ORACLE_REGIONS})
    record.setdefault("workloads", {})
    for name in names:
        record["workloads"][name] = {}
        for size, days in (("smoke", STUDIES_SMOKE_DAYS), ("full", None)):
            record["workloads"][name][size] = study_runs(name, days)
            with open(STUDIES_FIXTURE, "w") as f:
                json.dump(record, f, indent=1, sort_keys=True)
                f.write("\n")


def main() -> None:
    if "--studies" in sys.argv[1:]:
        studies_main(sys.argv[1:])
        return
    if "--workloads" in sys.argv[1:]:
        workloads_main(sys.argv[1:])
        return
    if "--train" in sys.argv[1:]:
        train_main()
        return
    tasks, hosts, _, meta = make_workload("marconi", scale=1.0, seed=0,
                                          dt_h=DT_H, horizon_days=30.0)
    if "--fleet" in sys.argv[1:]:
        fleet_main(tasks, hosts, meta)
        return
    ci, wb, price, cf = facility_traces(STEPS)
    cfg = main_config(meta["embodied"], meta["n_hosts"]).replace(
        scheduler=C.SchedulerConfig(mode="aggregate"))
    dyn = {"n_active_hosts": ACTIVE, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    scaling_only = "--scaling" in sys.argv[1:]
    for backend in () if scaling_only else ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        t0 = time.perf_counter()
        res = summarize(simulate(tasks, hosts, ci, c, dyn=dyn)[0], c)
        emit({"aggregate": backend, "seconds": time.perf_counter() - t0,
              **{k: float(getattr(res, k)) for k in COUNTS},
              "sla_violation_frac": float(res.sla_violation_frac),
              "total_carbon_kg": float(res.total_carbon_kg)})

    plain = SimConfig(dt_h=DT_H, n_steps=SCALING_STEPS,
                      embodied=meta["embodied"], backend="megakernel")

    def sla(n: int) -> float:
        final, _ = simulate(tasks, with_scale(hosts, n), ci[:SCALING_STEPS],
                            plain)
        return float(summarize(final, plain).sla_violation_frac)

    emit({"sla_curve": {n: sla(n) for n in (972, 750, 600)}})
    for target in (0.01, 0.80):
        t0 = time.perf_counter()
        best, evaluated = find_min_scale(sla, 1, 972, target)
        emit({"scaling": target, "best": best,
              "evaluated": {str(k): v for k, v in evaluated.items()},
              "seconds": time.perf_counter() - t0})
    if not scaling_only:
        fleet_main(tasks, hosts, meta)


if __name__ == "__main__":
    main()
