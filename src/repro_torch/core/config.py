"""Static configuration for the STEAM engine (PyTorch port).

A copy of the reference package's `core/config.py`: frozen, hashable
dataclasses of scalars and strings.  Technique composition switches code
paths on these fields in Python, before any tensor work, so a step never
branches on device data.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np

HOURS_PER_YEAR = 8766.0


def inv_f32(c) -> np.float32:
    """The f32 reciprocal of a host constant, rounded once in f32 (C's
    `1.0f / c`).  Under `jit` the reference's `x / c`, with `c` known at
    compile time, is XLA's `x * (1 / c)`; `x * inv_f32(c)` gives its bits on
    every device (PyTorch's CUDA `tensor / scalar` takes the same
    product)."""
    return np.float32(1.0) / np.float32(c)


@dataclass(frozen=True)
class PowerModelConfig:
    """Utilization -> power for one component class (paper §IV-A).

    model: 'linear' | 'sqrt' | 'square' | 'cubic'.  Paper §V-C1 uses sqrt for
    CPUs and linear for GPUs, following Brewer et al. (SC'24).
    """
    idle_w: float = 100.0
    max_w: float = 300.0
    model: str = "sqrt"


@dataclass(frozen=True)
class BatteryConfig:
    enabled: bool = False
    capacity_kwh: float = 300.0
    # Paper §V-B1: charging speed scales linearly with capacity, 3 kW/kWh
    # (Tesla Model 3 DC charging); discharge is limited by the same C-rate.
    charge_rate_kw_per_kwh: float = 3.0
    round_trip_efficiency: float = 0.9
    embodied_kg_per_kwh: float = 100.0   # paper §V-C2, range 30-500
    lifetime_years: float = 10.0
    # threshold = rolling mean of the past week's carbon intensity
    threshold_window_h: float = 168.0
    # wait until carbon intensity stops decreasing before charging
    wait_for_trough: bool = True
    # dispatch policy (core/battery.dispatch_decision):
    #   'carbon'  : the paper's carbon-greedy threshold policy (default)
    #   'price'   : arbitrage against the forward price quantiles
    #   'blended' : carbon-vs-cost objective weighted by `dispatch_lambda`
    # 'price'/'blended' need the pricing subsystem (cfg.pricing.enabled);
    # `dispatch_lambda` may be a traced dyn value (grid axis) — 1 is pure
    # carbon (bitwise the 'carbon' policy), 0 pure price arbitrage.
    policy: str = "carbon"
    dispatch_lambda: float = 1.0
    # forward window + quantile levels for the price-arbitrage signals
    # (precomputed like the shifting threshold, core/pricing.py)
    price_window_h: float = 168.0
    price_charge_quantile: float = 0.25
    price_discharge_quantile: float = 0.75

    @property
    def charge_rate_kw(self) -> float:
        return self.capacity_kwh * self.charge_rate_kw_per_kwh


@dataclass(frozen=True)
class ShiftingConfig:
    enabled: bool = False
    # task starts allowed while ci <= quantile(next week's forecast)
    forecast_window_h: float = 168.0
    quantile: float = 0.35
    max_delay_h: float = 24.0
    # optional task-stopper: pause RUNNING tasks in high-carbon periods
    stop_running: bool = False


@dataclass(frozen=True)
class FailureConfig:
    enabled: bool = False
    # stochastic model: per-host failure probability per hour, repair time
    mtbf_h: float = 1000.0          # mean time between failures per host
    repair_h: float = 2.0           # mean repair duration
    checkpoint_interval_h: float = 1.0  # paper §VI-A2 (Cloud Uptime Archive rate)
    checkpointing: bool = True


@dataclass(frozen=True)
class ResilienceConfig:
    """Closed-loop resilience (core/resilience.py).

    Disabled by default: the engine then carries no throttle state, samples
    no facility failure processes, and reproduces the open-loop pipeline
    bit-for-bit.  Enabled, three loops close:

      * facility failure injection — memoryless chiller-derate and PDU-cap
        processes (MTBF/repair, like FailureConfig's host model) sampled
        from the run seed as exogenous per-step series.  While the chiller
        is derated, `chiller_derate` scales the achievable COP and the
        economizer availability (core/thermal.py); while a PDU is derated,
        rack power is clamped to `pdu_cap_kw` (dyn-sweepable).
      * thermal throttling feedback — an inlet-temperature proxy from
        wet-bulb + IT load (divided by the chiller derate: degraded cooling
        raises inlet temperature).  When it exceeds `throttle_inlet_c`
        (dyn-sweepable), host speed/utilization is capped at
        `throttle_factor` on the NEXT tick — the one-step delay keeps the
        recurrence causal, which is what lets the megakernel's facility
        half stay vectorized over the horizon.
      * failure-reactive placement — the scheduler prefers hosts that are
        up and longest since their last repair (`reactive_placement`), and
        `core/fleet.simulate_fleet` can spill interrupted tasks across
        regions each step (`spill_interrupted`).

    `heat_hazard_mult` couples the loops into CORRELATED failures: while
    the chiller is derated, the host failure hazard is multiplied by
    `1 + heat_hazard_mult * (1 - derate)` (heat kills hosts).  The dyn key
    `failure_hazard_scale` scales BOTH the host and facility hazards
    (0 = a healthy datacenter, inside one compiled grid).
    """
    enabled: bool = False
    # facility failure processes (memoryless MTBF + deterministic repair)
    chiller_mtbf_h: float = 500.0
    chiller_repair_h: float = 12.0
    chiller_derate: float = 0.5     # COP / economizer availability when derated
    pdu_mtbf_h: float = 1000.0
    pdu_repair_h: float = 4.0
    pdu_cap_kw: float = float("inf")  # rack-power clamp while PDU-derated
    # thermal throttling feedback (RackMind's inlet-trip rule, one-step delay)
    throttle_inlet_c: float = 32.0
    throttle_factor: float = 0.5    # host speed/utilization cap while tripped
    inlet_approach_c: float = 8.0   # inlet proxy: wet_bulb + approach + load
    inlet_load_c_per_kw: float = 0.02  # degC of inlet rise per kW of IT load
    # correlated failures: extra host hazard while the chiller is derated
    heat_hazard_mult: float = 0.0
    # failure-reactive placement (core/scheduler.py host re-ranking)
    reactive_placement: bool = True
    # fleet-level per-step cross-region spill of interrupted tasks
    # (core/fleet.simulate_fleet; needs `enabled` too)
    spill_interrupted: bool = False
    max_spills_per_step: int = 4


@dataclass(frozen=True)
class EmbodiedConfig:
    host_kg: float = 1022.0         # Surf default (Table II)
    host_lifetime_years: float = 5.0


@dataclass(frozen=True)
class CoolingConfig:
    """Weather-driven thermal/cooling model (core/thermal.py).

    Disabled by default: the engine then hands IT power straight to the grid
    (PUE == 1), reproducing the pre-cooling pipeline exactly.  Enabled, a
    `stage_cooling` between power and battery converts IT power to *facility*
    power from the wet-bulb temperature trace (weathertraces/), so battery
    peak-shaving and carbon accounting see the cooling overhead.
    """
    enabled: bool = False
    setpoint_c: float = 24.0         # chilled-supply setpoint (cold side)
    economizer_range_c: float = 6.0  # wet-bulb this far below setpoint => free
    tower_approach_c: float = 4.0    # condenser water = wet-bulb + approach
    condenser_lift_c: float = 8.0    # extra lift through the condenser loop
    carnot_efficiency: float = 0.45  # fraction of the Carnot COP achieved
    max_cop: float = 8.0
    fan_pump_overhead: float = 0.05  # CRAH fans + pumps, fraction of IT power
    evap_l_per_kwh_heat: float = 1.5 # tower evaporation incl. blowdown
    # district-heating reuse: this fraction of the chiller-path heat is
    # reclaimed before the tower (heat exchangers to a heat network), so it
    # neither evaporates water nor is wasted — `SimResult.heat_reuse_kwh`
    # tracks it and `sustainability_extras` credits the displaced heating.
    # 0.0 (default) reproduces the no-reuse pipeline bit-for-bit.
    heat_reuse_fraction: float = 0.0


@dataclass(frozen=True)
class PricingConfig:
    """Electricity-price model (core/pricing.py).

    Disabled by default: the engine then accumulates no cost and
    `metrics.sustainability_extras` falls back to the legacy flat tariff
    (exactly like the flat-WUE fallback when cooling is off).  Enabled, a
    `stage_pricing` after the battery accumulates the energy charge from the
    per-step price trace (pricetraces/, or a flat trace at
    `flat_price_per_kwh` when none is given) plus a billing-window demand
    charge on the peak metered grid draw — the quantity the battery can
    shave, which is what makes peak shaving *worth money* here.

    With on-site generation (cfg.renewables, core/renewables.py) the bill
    gains an export leg: exported surplus (`EnergyFlow.grid_export_kw`)
    earns `export_price_fraction` of the spot price per kWh — a
    time-of-use export tariff (feed-in below retail, the common net-billing
    arrangement; 1.0 is classic 1:1 net metering).  Import charges always
    meter the gross import, never an import-export net.
    """
    enabled: bool = False
    flat_price_per_kwh: float = 0.12   # legacy tariff; trace default
    # demand charge: price per kW of peak grid draw, billed once per window
    demand_charge_per_kw: float = 10.0
    billing_window_h: float = 168.0
    # export tariff: fraction of the spot price paid for exported kWh
    export_price_fraction: float = 0.5


@dataclass(frozen=True)
class RenewableConfig:
    """On-site renewable generation (core/renewables.py).

    Disabled by default: the engine's energy-flow ledger then carries zero
    PV and the pipeline reproduces the supply-free behaviour bit-for-bit.
    Enabled, a `stage_renewables` between cooling and battery supplies
    `pv_capacity_kw * capacity_factor(t)` (renewabletraces/synthetic.py,
    dyn key `pv_cf_trace`) to the ledger; generation first serves the
    facility load, surplus preferentially charges the battery
    (core/battery.surplus_aware_dispatch), and the remainder is exported to
    the grid when `export_allowed` (earning the pricing subsystem's export
    tariff) or curtailed when not.  Carbon accounting then meters the NET
    grid import — the supply/demand structure Treehouse argues carbon-aware
    infrastructure must expose.
    """
    enabled: bool = False
    pv_capacity_kw: float = 0.0   # nameplate AC capacity; dyn-sweepable
    # may the site sell surplus back to the grid?  False = island curtailment
    export_allowed: bool = True


@dataclass(frozen=True)
class ProbeConfig:
    """Per-step probe bus (core/telemetry.py).

    Disabled by default: `SimState.probes`/`SimResult.probes` stay None
    and the step function is unchanged (bitwise-identical outputs).
    Enabled, a probe stage samples the settled EnergyFlow ledger,
    battery SoC, the running billing-window peak and the scheduler
    queue depth every `stride` steps into a preallocated ring buffer
    carried through the scan — time-resolved visibility at
    O(n_steps/stride) memory instead of `collect_series`' full horizon.
    `max_samples` caps the ring (0 = keep every strided sample); a
    capped ring wraps, keeping the LAST samples.  Both step executors
    export identical probes (differentially tested).
    """
    enabled: bool = False
    stride: int = 1
    max_samples: int = 0


@dataclass(frozen=True)
class SchedulerConfig:
    # 'first_fit'  : exact bounded first-fit placement (K slots/step)
    # 'aggregate'  : capacity-only admission (analytical-model-like placement)
    mode: str = "first_fit"
    slots_per_step: int = 64
    # > 1 turns on priority-aware candidate selection (first_fit only):
    # tasks with higher `TaskTable.priority` fill the K slots first, FIFO
    # within a class (state.N_JOB_CLASSES covers the typed job classes).
    # 1 (default) is the plain FIFO prefix, bit-for-bit the untyped path.
    priority_levels: int = 1


@dataclass(frozen=True)
class SimConfig:
    dt_h: float = 0.25
    n_steps: int = 1000
    seed: int = 0
    cpu_power: PowerModelConfig = PowerModelConfig(idle_w=100.0, max_w=300.0, model="sqrt")
    gpu_power: PowerModelConfig = PowerModelConfig(idle_w=40.0, max_w=300.0, model="linear")
    # power drawn by a provisioned-but-idle host beyond component idle (PSU
    # overhead etc.) is folded into cpu idle_w; non-active hosts draw zero.
    battery: BatteryConfig = BatteryConfig()
    shifting: ShiftingConfig = ShiftingConfig()
    failures: FailureConfig = FailureConfig()
    cooling: CoolingConfig = CoolingConfig()
    pricing: PricingConfig = PricingConfig()
    renewables: RenewableConfig = RenewableConfig()
    embodied: EmbodiedConfig = EmbodiedConfig()
    scheduler: SchedulerConfig = SchedulerConfig()
    probes: ProbeConfig = ProbeConfig()
    resilience: ResilienceConfig = ResilienceConfig()
    sla_grace_h: float = 24.0       # task meets SLA if done within 24h of expected
    # SLA grace applied to tasks re-typed interactive by the
    # `interactive_frac` dyn key (state.with_interactive_frac); tasks built
    # with an explicit `sla_grace` column keep their own value
    interactive_grace_h: float = 0.25
    collect_series: bool = False    # emit per-step (power, ci, running) series
    # kept for parity with the reference's config and read by nothing: in
    # this port the tables' device picks the kernels (CUDA) or their plain
    # versions (CPU), see kernels/ops.py
    use_pallas: bool = False
    # step executor (core/engine.py "Step executors"):
    #   'stage-pipeline' : every stage every step (default)
    #   'megakernel'     : demand loop + the facility half over the whole
    #                      horizon at once (one fused kernel on the card) —
    #                      numerically equivalent within float tolerance
    backend: str = "stage-pipeline"
    # storage of the exogenous traces the fused facility kernel reads
    # (core/quant.py): 'f32' exact, 'bf16' half the bytes (rel err <= 2^-8),
    # 'int8' a quarter (abs err <= trace_range/510).  Read by the megakernel
    # backend's facility half.
    trace_store: str = "f32"

    def replace(self, **kw) -> "SimConfig":
        return dataclasses.replace(self, **kw)


def techniques(cfg: SimConfig, horizontal_scaling: bool = False,
               spatial: bool = False) -> str:
    """Short label of enabled techniques, e.g. 'HS+B+TS' or 'SS+B'.

    HS is expressed via the host table's active mask (or the `n_active_hosts`
    dyn value) and SS (spatial shifting) via the fleet's placement policy
    (core/fleet.py), so neither is knowable from the config alone — callers
    pass `horizontal_scaling=True` / `spatial=True` to get the canonical
    label instead of string-appending it themselves.
    """
    parts = []
    if spatial:
        parts.append("SS")
    if horizontal_scaling:
        parts.append("HS")
    if cfg.renewables.enabled:
        parts.append("PV")
    if cfg.battery.enabled:
        parts.append("B")
    if cfg.shifting.enabled:
        parts.append("TS")
    return "+".join(parts) if parts else "none"
