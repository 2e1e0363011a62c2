"""The simulation core of the PyTorch port (see `repro_torch`)."""
from .battery import (battery_flow_step, dispatch_decision,
                      precompute_battery_signals, surplus_aware_dispatch)
from .config import (BatteryConfig, CoolingConfig, EmbodiedConfig,
                     FailureConfig, PowerModelConfig, PricingConfig,
                     ProbeConfig, RenewableConfig, ResilienceConfig,
                     SchedulerConfig, ShiftingConfig, SimConfig, techniques)
from .engine import (BACKENDS, EnergyFlow, StepInputs, build_step_fn,
                     build_step_inputs, default_pipeline,
                     facility_totals_from_flows, init_energy_flow, simulate)
from .fleet import FleetResult, FleetSpec, fleet_place, simulate_fleet
from .grid import (Axis, ScenarioGrid, dyn_axis, fleet_axis, price_axis,
                   region_axis, renewable_axis, seed_axis, sweep_grid,
                   tasktrace_axis, trace_axis, weather_axis)
from .metrics import (SimResult, carbon_reduction_pct, fleet_totals,
                      result_to_numpy, summarize)
from .pricing import (export_revenue_step, flat_energy_cost,
                      precompute_price_signals, pricing_step,
                      settle_demand_charge)
from .renewables import net_load_split, pv_power_kw, split_surplus
from .resilience import (cross_region_spill, facility_failure_series,
                         host_rank, inlet_proxy_c, next_throttle)
from .quant import (STORES, QuantizedTrace, dequantize_trace,
                    maybe_dequantize, quantize_trace)
from .scaling import find_min_scale, with_scale
from .shifting import forward_window_quantile, forward_window_quantiles
from .spatial import (spatial_assign, spatial_assign_online,
                      spatial_assign_reference, split_by_region)
from .state import (DONE, INVALID, JOB_BATCH, JOB_CLASS_NAMES,
                    JOB_INTERACTIVE, JOB_TRAINING, N_JOB_CLASSES, PENDING,
                    RUNNING, BatteryState, HostTable, MetricsAcc, SimState,
                    TaskTable, active_host_mask, init_sim_state,
                    make_host_table, make_task_table, pad_task_table,
                    retime_task_table, stack_task_tables, tables_from_numpy,
                    with_interactive_frac)
from .thermal import (chiller_cop, cooling_step, dynamic_pue,
                      economizer_fraction, reclaimable_heat_kw)
from .sweep import (lower_sweep, sharded_sweep, sweep_battery_sizes,
                    sweep_regions, sweep_regions_x_battery, sweep_step_fn)

__all__ = [
    "battery_flow_step", "dispatch_decision", "precompute_battery_signals",
    "surplus_aware_dispatch", "BatteryConfig", "CoolingConfig",
    "EmbodiedConfig", "FailureConfig", "PowerModelConfig", "PricingConfig",
    "ProbeConfig", "RenewableConfig", "ResilienceConfig", "SchedulerConfig",
    "ShiftingConfig", "SimConfig", "techniques", "BACKENDS", "EnergyFlow",
    "StepInputs", "build_step_fn", "build_step_inputs", "default_pipeline",
    "facility_totals_from_flows", "init_energy_flow", "simulate",
    "FleetResult", "FleetSpec", "fleet_place", "simulate_fleet", "Axis",
    "ScenarioGrid", "dyn_axis", "fleet_axis",
    "price_axis", "region_axis", "renewable_axis", "seed_axis", "sweep_grid",
    "tasktrace_axis", "trace_axis", "weather_axis",
    "SimResult", "carbon_reduction_pct", "fleet_totals", "result_to_numpy",
    "summarize", "spatial_assign", "spatial_assign_online",
    "spatial_assign_reference", "split_by_region",
    "export_revenue_step", "flat_energy_cost", "precompute_price_signals",
    "pricing_step", "settle_demand_charge", "net_load_split", "pv_power_kw",
    "split_surplus", "chiller_cop", "cooling_step", "dynamic_pue",
    "economizer_fraction", "reclaimable_heat_kw",
    "cross_region_spill", "facility_failure_series", "host_rank",
    "inlet_proxy_c", "next_throttle", "STORES", "QuantizedTrace",
    "dequantize_trace", "maybe_dequantize", "quantize_trace",
    "find_min_scale", "with_scale", "forward_window_quantile",
    "forward_window_quantiles",
    "DONE", "INVALID", "JOB_BATCH", "JOB_CLASS_NAMES", "JOB_INTERACTIVE",
    "JOB_TRAINING", "N_JOB_CLASSES", "PENDING", "RUNNING", "BatteryState",
    "HostTable", "MetricsAcc", "SimState", "TaskTable", "active_host_mask",
    "init_sim_state", "make_host_table", "make_task_table", "pad_task_table",
    "retime_task_table", "stack_task_tables", "tables_from_numpy",
    "with_interactive_frac",
    "lower_sweep",
    "sharded_sweep", "sweep_battery_sizes", "sweep_regions",
    "sweep_regions_x_battery", "sweep_step_fn",
]
