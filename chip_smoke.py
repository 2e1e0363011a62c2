#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py                # on a machine with an H100
    python3 chip_smoke.py --device cpu   # rehearsal at a tiny size, no card

Phases, each printing one JSON line:

  1. device   -- the card's name and power limit (nvidia-smi, torch).
  2. build    -- the seven hand-written kernels built from
                 src/repro_torch/kernels/csrc/ (one nvcc per source, all at
                 once) into src/repro_torch/kernels/_build/; seconds, the
                 ptxas register / shared-memory / spill lines, and the
                 registers, stack, spill and static shared bytes of
                 first-fit's warp variant and of the facility kernel (both
                 must keep their arrays in registers: no stack, no spills),
                 and of the two power kernels.
  3. kernels  -- each kernel against its plain PyTorch version
                 (kernels/ref.py) on the card, at the main paths' shapes and
                 around them, at the tolerances of the CPU tests; kernel 3's
                 chiller-derate route against its plain chain in each trace
                 store; kernel 3's series route (B = 1 and 64, each store,
                 healthy and derated) against the plain chain on the CPU:
                 SoC and decisions bit-equal, flows within rtol 1e-4 / atol
                 1e-3, totals bit-equal to the totals route's; threefry's
                 known answers, and its uniforms, the
                 failure probabilities and a full-scale run's [2880, 1, 972]
                 failure draws bit for bit against the CPU's; the per-host
                 sum kernel (the port's own, in place of segment_sum) on
                 the task table's columns at Marconi's shapes, [T] and
                 [64, T] rows, [64, T] status with [1, T] values, long
                 same-host chains: two launches the same bits, and the
                 plain version's on the CPU (`scatter_add_` in task
                 order).
  4. main     -- a full-scale Marconi run (192,817 tasks, 972 hosts, 30 days
                 at 15 minutes = 2880 steps) with every technique on, through
                 both step executors; launch counts are reset just before
                 and read just after each run and must be exact (the per-host
                 sums twice a step).
  4e. telemetry -- the main run with the probe bus (stride 4, K = 720)
                 through both executors in a session:
                 launch counts the main run's (the megakernel's kernel 3 on
                 its series route, `fused_facility_series`), every
                 SimResult field bit-equal to the main run's (runs repeat
                 bit for bit: the per-host sums add in task order), the
                 executors' probes within rtol 1e-5 / atol 1e-4, one
                 "simulate" run record a run (platform, peak memory, the
                 compile / execute split) and its Chrome trace parsed back;
                 the session's host cost a step (192-step probed runs with
                 the session off and on, in turns, their probes
                 bit-equal);
                 stride-1 probes over 192 steps equal to the stage
                 pipeline's collect_series; a 16-cell Fig 12 grid with
                 probes in two chunks (its record's chunk plan; cells (0, 0)
                 and (5, 1) against their own runs); after the grid phase,
                 `telemetry.profile` of 192 probed megakernel steps.
  4a. resilience -- the main run with host failures, checkpointing and
                 the closed resilience loop (reactive placement, heat-
                 correlated failures, a PDU clamp at 0.8 of the open-loop
                 run's mean IT draw, seed 1), through both executors and as a
                 seed x failure_hazard_scale grid of 4 cells: launch counts
                 exact (kernel 1 and first-fit every step, kernel 2 never,
                 kernel 3's derate route once a megakernel run), the loop
                 acted (interrupts, lost work, derated and throttled hours),
                 the executors equal (`compare_resilience`), the grid's cell
                 the single run, its healthy cells free of failures; after
                 the grid phase, a 32-step profile of each executor; after
                 the small phase, the same at a small scale on the card and
                 on the CPU.
  4b. experiments -- the experiment tooling at full scale, each part a
                 line with its wall time, peak memory and launch counts:
                 (a) the main configuration with scheduler mode 'aggregate'
                 through both executors (first-fit never launches; the
                 counts are the reference's, AGG_COUNTS); (b) the §III
                 analytical model over every task on the card against the
                 CPU, beside the simulated shifting savings (megakernel,
                 no other technique); (c) a task-trace grid of 8 arrival
                 sets (launch counts a single run's, the executors
                 equal); (d) `find_min_scale` at the targets 0.01 and 0.80
                 over the default configuration, each pair the
                 reference's (SCALING_KAT); (e) the CLI on 8 regions.
                 After the grid phase, a small task-trace grid (with and
                 without priority levels) on the card and on the CPU.
  4d. fleet  -- the multi-datacenter fleet at full scale: Marconi placed
                 over the 8 synthetic regions (carbon and weather of seed 0,
                 750 active hosts a region, the main path's price and PV
                 traces shared), each part a line with its wall time, peak
                 memory and launch counts (exactly one run's): (a) greedy
                 placement at `capacity_frac=1.5` through both executors
                 (placement, per-region counts and totals the reference's,
                 FLEET_REF_*; the executors equal); (b) `round_robin` and
                 the online `spill` router (megakernel; placement and
                 counts the reference's, the router's host seconds); (c) a
                 fleet grid of 4 host plans x 2 batteries x 8 regions = 64
                 rows through both executors (cells (0, 0) and (3, 1) equal
                 to their own `simulate_fleet`); (d) the greedy fleet at
                 full width under phase 4a's failures and loop with the
                 cross-region spill (seeds 1-8, stage pipeline) and without
                 it (counts, interrupts and spills the reference's).  After
                 the grid phase, 32-step profiles of (c) (megakernel) and
                 (d); after the small phase, a small greedy fleet, spill
                 fleet and fleet grid on the card and on the CPU.
  4c. grid   -- the scenario grid of paper Fig 12 at the main phase's
                 configuration: 8 carbon regions x battery capacities, as
                 B = 1, 16 and 64 cells in one step loop, through both
                 executors: wall time, aggregate simulated years a second,
                 peak memory, a 32-step profile (host ms a step, device
                 idle share), launch counts equal to one run's; cell 0
                 equal to the main run, every cell of an 8 x 2
                 megakernel grid over the first 180 steps equal to its own
                 run, B = 64's repeated
                 cells equal to B = 16's, the backends equal cell by cell;
                 then a small 16-cell grid on the card and on the CPU.
  5. small    -- the same configuration at a small scale on the card and on
                 the CPU (the plain versions, which the CPU tests hold to the
                 reference package): counts exact, the rest within 1e-4.
  6. serve    -- zamba2-7b as configured (81 layers, d 3584, f32 params,
                 bf16 compute, random weights from a seed): the
                 decode-vs-prefill contract over 2 x 512 tokens in f32 on
                 its first 13 layers (CONTRACT_LAYERS says why), a
                 warm-up and two timed prefills of 2 x 4096 tokens with
                 exactly 81 SSD and 13 flash launches, a profile of one
                 prefill, and 32 greedy decode tokens; then mamba2-2.7b's
                 prefill of 2 x 4096 tokens with exactly 64 SSD launches
                 and a profile of it.
  7. small models -- reduced zamba2 and mamba2 on the card and on the CPU:
                 prefill logits and 16 decode steps within 1e-4.
  7b. dense  -- qwen2-1.5b as configured (28 layers, d 1536, 12 heads / 2
                 KV of 128, f32 params, bf16 compute, random weights from a
                 seed): the decode-vs-prefill contract over 2 x 512 tokens
                 in f32 on its first 2 layers (DENSE_CONTRACT_LAYERS says
                 why), a warm-up and two timed prefills
                 of 2 x 4096 tokens with exactly 28 flash launches, a
                 profile of one (flash, GEMM and the rest of the busy
                 time), 32 greedy decode tokens, peak memory; paligemma-3b
                 as configured: prefills of 2 x (256 patch embeddings of
                 1152 + 3840 tokens) with exactly 18 flash launches (D 256,
                 MQA); then qwen2, stablelm, gemma2, gemma3 and paligemma
                 reduced on the card and on the CPU (the same weights):
                 logits and 16 decode steps within 1e-4, flash launches 2,
                 2, 0, 1, 2.  Each part prints its wall time.
  7c. train  -- training, which launches no kernel (the kernels have no
                 backward; the losses take the plain paths, as the
                 reference trains on its jnp code), each part a line with
                 its wall time: (a) qwen2-1.5b as configured (28 layers, d
                 1536, f32 params, bf16 compute, remat "nothing", random
                 weights from a seed), batch 2 x 4096 from the port's
                 pipeline, AdamW (lr 3e-4, warm-up 2, 10 steps): the
                 gradient of `Model.init`'s weights recorded (the
                 reference's fan-in rule makes it explode through 28
                 layers), then with the attention projections at their
                 input's fan-in (`input_fan_in`) a warm-up
                 step and 4 timed steps on one batch, launch counts all 0,
                 every loss and gradient norm finite, the last loss below
                 the first step's (at the initial weights) by 1e-3 (the
                 reference's smoke criterion), the optimizer's step
                 5; step ms, tokens/s, model-FLOP utilisation, peak memory;
                 then 1 step under the profiler, device time a step split
                 into GEMM / attention glue / optimizer / the rest; (b) its
                 first 2 layers at full width in f32, the same weights and
                 a 2 x 256 batch on the card and on the CPU: the loss, the
                 gradient norm and every gradient leaf within rtol 1e-4 /
                 atol 1e-4 x the leaf's largest magnitude; (c) the seven
                 served configs reduced, card against CPU one step at a
                 time over three steps (loss within 1e-4), stablelm with
                 int8 compression, qwen2's 2 microbatches against 1 (the
                 loss within 1e-6, the gradient norm 1e-4), the ops guard
                 on the card; (d) the carbon-aware
                 trainer in the reference's two setups and the example's
                 (200 steps), counts equal to the reference's CPU answers
                 (scripts/reference_experiments.py --train), carbon within
                 rtol 1e-6, falling losses, a checkpoint saved and restored
                 bit for bit; (e) `python -m repro_torch.launch.train
                 --arch qwen2-1.5b --reduced --steps 20 --carbon-aware
                 --failures 0.02`, its JSON the reference CLI's.  Files go
                 under the git-ignored results/train_smoke/.  Part (c)
                 also trains reduced qwen3-moe, deepseek-v2 and whisper.
  7d. moe    -- qwen3-moe-235b-a22b and deepseek-v2-236b at their published
                 widths, depth cut to what the card holds (MOE_LAYERS: 10
                 of 94 layers, 1 dense + 6 MoE of 60; bf16 params and
                 compute, random weights from a seed): the decode-vs-prefill
                 contract over 2 x 512 tokens in f32 on the first 2 layers
                 at the capacity factor n_experts / top_k (`contract_config`
                 says why), a warm-up and two timed prefills of 2 x 4096
                 tokens with one flash launch a layer, the same prefill
                 twice through the sort dispatch (bit for bit), a profile
                 of one prefill split into flash / GEMM outside and inside
                 the `moe` range / the `moe` range's other kernels / the
                 rest, 32 greedy decode tokens, peak memory; then both
                 reduced configs on the card and on the CPU (the same
                 weights): logits and 16 decode steps within 1e-4, flash
                 launches 2 and 3, each through both dispatch modes.
  7e. whisper -- whisper-base as configured (6 + 6 layers, d 512, f32
                 params, bf16 compute): batch 8 x (1500 frame embeddings,
                 448 tokens); the f32 contract on its first 2 decoder
                 layers over 448 tokens (WHISPER_CONTRACT_LAYERS says why),
                 the cross-attention cache built from the encoder output;
                 timed prefills with exactly 18 flash
                 launches (encoder, decoder, cross-attention), 32 greedy
                 tokens; then the reduced config on the card and on the CPU
                 (6 flash launches).  Each part of 7d / 7e prints its wall
                 time and peak memory.
  8. timing   -- each kernel beside its plain version (CUDA events) at the
                 main paths' shapes, its device time (profiler), its bound,
                 and for flash attention (zamba2's, qwen2's, paligemma's,
                 qwen3-moe's, deepseek-v2's padded MLA and whisper's
                 encoder and cross-attention shapes) one call of PyTorch's
                 scaled_dot_product_attention as a yardstick; the per-host
                 sums at B = 1 and 64 beside their plain version and one
                 `index_add_`, and the device time of a whole
                 `scheduler.host_utilization` call at both B; first-fit's
                 latency bound (the least dependent chain of its K
                 placements), the model kernels' bounds at their
                 tensor-core rates, the facility kernel's latency bound
                 (its SoC chain), and the launch floor: the device time of
                 an empty kernel on the power kernels' and first-fit's
                 grids, launched through the same ctypes path.

Then the `kernels` summary line (kernel 3's derate route as its own row,
`fused_facility_totals_derate`, and its series route,
`fused_facility_series`), the nvidia-smi line, and as the last line
`{"ok": true, "device": {...}}`.  Any failure raises: no phase is caught,
and the script exits non-zero without the last line.  Without `--device
cpu` it needs a card and fails without one.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import hashlib
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.carbontraces import (make_region_traces,  # noqa: E402
                                      trace_stats)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import config as C  # noqa: E402
from repro_torch.core import (STORES, EnergyFlow, FleetSpec,  # noqa: E402
                              ScenarioGrid, battery, dyn_axis,
                              facility_failure_series,
                              failures, find_min_scale, fleet_axis, pricing,
                              region_axis, result_to_numpy, seed_axis,
                              simulate, simulate_fleet, split_by_region,
                              summarize, sweep_grid, tasktrace_axis,
                              threefry, trace_axis, with_scale)
from repro_torch.core import analytical  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.core.fleet import fleet_place  # noqa: E402
from repro_torch.core.state import (PENDING, RUNNING,  # noqa: E402
                                    cell_tables)
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels import first_fit as ff_k  # noqa: E402
from repro_torch.kernels import flash_attn as fa_k  # noqa: E402
from repro_torch.kernels import fused_step as fs_k  # noqa: E402
from repro_torch.kernels import host_sum as hs_k  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import power_carbon as pc_k  # noqa: E402
from repro_torch.kernels import ssd_chunk as ssd_k  # noqa: E402
from repro_torch.launch import simulate as cli  # noqa: E402
from repro_torch.models import get_model, whisper  # noqa: E402
from repro_torch.models.layers import (dtype_of, flatten,  # noqa: E402
                                       layer, layer_window, tree_map)
from repro_torch.tasktraces import make_arrival_sets  # noqa: E402
from repro_torch.data.pipeline import (DataConfig,  # noqa: E402
                                       TokenPipeline, to_device)
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train.carbon_aware import (  # noqa: E402
    CarbonAwareConfig, run_carbon_aware_training)
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         OptState, global_norm)
from repro_torch.train.step import (TrainConfig, TrainState,  # noqa: E402
                                    init_train_state, make_train_step,
                                    new_train_state, trainable,
                                    value_and_grad)
from repro_torch.weathertraces import make_weather_traces  # noqa: E402
from repro_torch.workloads import make_workload  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 (non-tensor) op/s
# and bf16 and TF32 tensor-core op/s (dense)
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
PEAK_BF16_OPS_S = 989e12
PEAK_TF32_OPS_S = 495e12
# the least latency of one dependent arithmetic instruction (the CUDA C++
# Programming Guide's "about 4 clock cycles", compute capability 7.x on)
# and the H100 SXM's highest SM clock (NVIDIA data sheet: 1980 MHz)
DEP_CYCLES = 4
MAX_SM_HZ = 1.98e9
# kernel 3's SoC recurrence: the fewest dependent instructions from one
# step's `soc` to the next that the function needs (fused_step.py:145-151
# in f32, each division by the constant step the product with its f32
# reciprocal, as XLA compiles it): FADD (cap - soc); FMUL (the reciprocal);
# one FMNMX, the charge min(q, lim): the rate, the charge cap and the
# decision combine into `lim` off the chain (a minimum is exact in any
# order), and max(q, 0) is q once the clamp keeps soc <= cap; FMUL
# (efficiency); FADD (- dk); FMUL (step); FADD (soc +); two FMNMX (the
# clamp).  The discharge (the second product, min(q_soc, min(rate, net)),
# the select) joins at the FADD after 4, so it is shorter.  The kernel
# keeps max(q, 0) on every step (10 instructions).
SOC_CHAIN_LEVELS = 9
DT_H = 0.25
MAIN_STEPS = 2880            # 30 days at 15 minutes
# the window of the phases' profiles (the first steps of the full-scale
# run); the profiler's own host time grows with it, and the smoke runs
# within its time limit
PROFILE_STEPS = 32
# the horizon of the grid phase's check of each cell against its own run
# (the full-scale workload): sixteen single runs of the whole 2880 steps
# took two of the smoke's twenty minutes; 720 steps took 28.4 s of a ~970 s
# smoke on a slow host once phases 7d / 7e joined, so 360 (3.75 days)
SINGLES_STEPS = 360
MARCONI_ACTIVE = 750         # the published Marconi optimum (of 972 hosts)
KWH_PER_HOST = 9.0           # Marconi battery sizing (benchmarks/common.py)
CURVES = ("linear", "sqrt", "square", "cubic")


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------

def time_ms(fn, budget_s: float = 0.5) -> float:
    """Mean ms per call of `fn` over back-to-back calls, CUDA events around
    the run, after warm-up: what one call costs the caller's stream."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    reps = int(min(max(budget_s / max(time.perf_counter() - t0, 1e-6), 3),
                   500))
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_ms(fn, kernel_name: str, reps: int = 50):
    """Mean device time per launch of the kernel whose name contains
    `kernel_name`, from the profiler's CUDA activity (no host gaps).  A
    profile that recorded none of its launches (it happens to very short
    kernels now and then) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us, calls = 0.0, 0
        for e in prof.key_averages():
            if kernel_name in e.key:
                total_us += getattr(e, "device_time_total",
                                    getattr(e, "cuda_time_total", 0.0))
                calls += e.count
        if calls:
            return total_us / calls / 1000.0
    return None


def call_device_ms(fn, reps: int = 20):
    """Mean device time of everything one call of `fn` launches: the
    profiler's CUDA activity summed over `reps` calls (no host gaps).  A
    profile that recorded no kernel is taken again, up to three times;
    None if none did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def bound(nbytes: float, nops: float,
          peak_ops: float = PEAK_F32_OPS_S) -> tuple[float, str]:
    """Least time on the card (ms): bytes over HBM rate or operations over
    the peak rate of their type (f32 unless said), whichever is larger."""
    tb, to = nbytes / PEAK_BYTES_S, nops / peak_ops
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def host_sum_bytes(status, host, cols, h: int) -> int:
    """Bytes the per-host sums must move on these inputs: the status of
    every (row, task), the host of each RUNNING one, each value and weight
    column at the running tasks with a host only (a column shared by the
    rows once a distinct such task), and the sums, two [B, h] f32, written
    once."""
    st, ho = (x.reshape(-1, x.shape[-1]) for x in (status, host))
    run = st == RUNNING
    use = run & (ho >= 0)
    n_use, n_any = int(use.sum()), int(use.any(0).sum())
    return (4 * st.numel() + 4 * int(run.sum()) + 2 * 4 * st.shape[0] * h
            + sum(4 * (n_use if x.dim() == 2 and x.shape[0] > 1 else n_any)
                  for x in cols))


# --------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------

def _host_inputs(gen, b, h, dev):
    u = lambda: torch.rand((b, h), generator=gen, device=dev)  # noqa: E731
    ngpu = torch.randint(0, 5, (b, h), generator=gen, device=dev).float()
    on = (u() < 0.8).float()
    # utilizations slightly outside [0, 1] exercise the clamp
    return u() * 1.1 - 0.05, u() * 1.1 - 0.05, ngpu, on


def _err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def _close(got, want, rtol, atol, what) -> float:
    ok = torch.allclose(got.double(), want.double(), rtol=rtol, atol=atol)
    check(ok, f"{what}: max abs err {_err(got, want):.3e}")
    return _err(got, want)


def check_power_kernels(dev, results: dict) -> None:
    """Kernels 1 and 2 at H in {7, 972, 1000, 1024, 1025, 2048, 4096, 5000}
    (one host a thread up to 1024, further passes of the block beyond),
    every curve pair, one and four scenario rows, kernel 1 with a carbon
    tail and without (`ci` None, the megakernel's call); per-host rtol 1e-5
    atol 1e-6, sums rtol 1e-4."""
    gen = torch.Generator(device=dev).manual_seed(1)
    errs1, errs2 = [], []
    cool = C.CoolingConfig(enabled=True)
    for h in (7, 972, 1000, 1024, 1025, 2048, 4096, 5000):
        for b in (1, 4):
            cu, gu, ng, on = _host_inputs(gen, b, h, dev)
            ci = torch.rand(b, generator=gen, device=dev) * 500 + 50
            wb = torch.rand(b, generator=gen, device=dev) * 30 + 5
            sp = torch.rand(b, generator=gen, device=dev) * 10 + 18
            for cc in CURVES:
                for gc in CURVES:
                    cpu = C.PowerModelConfig(80.0, 250.0, cc)
                    gpu = C.PowerModelConfig(40.0, 300.0, gc)
                    got = pc_k.fused_power_carbon(cu, gu, ng, on, ci, 0.25,
                                                  cpu, gpu)
                    want = ref.fused_power_carbon(cu, gu, ng, on, ci, 0.25,
                                                  cpu, gpu)
                    what = f"fused_power_carbon h={h} b={b} {cc}/{gc}"
                    errs1.append(_close(got[0], want[0], 1e-5, 1e-6, what))
                    for g, w in zip(got[1:], want[1:]):
                        errs1.append(_close(g, w, 1e-4, 0.0, what + " sums"))
                    # the megakernel's call (ops.host_power): no carbon tail
                    got = pc_k.fused_power_carbon(cu, gu, ng, on, None, 0.25,
                                                  cpu, gpu)
                    want = ref.fused_power_carbon(cu, gu, ng, on, None, 0.25,
                                                  cpu, gpu)
                    errs1.append(_close(got[0], want[0], 1e-5, 1e-6,
                                        what + " ci=None"))
                    errs1.append(_close(got[1], want[1], 1e-4, 0.0,
                                        what + " ci=None sum"))
                    check(bool((got[2] == 0).all()),
                          f"{what} ci=None: carbon not 0")
                    got = pc_k.fused_facility_power(cu, gu, ng, on, wb, sp,
                                                    cpu, gpu, cool)
                    want = ref.fused_facility_power(cu, gu, ng, on, wb, sp,
                                                    cpu, gpu, cool)
                    what = f"fused_facility_power h={h} b={b} {cc}/{gc}"
                    errs2.append(_close(got[0], want[0], 1e-5, 1e-6, what))
                    for g, w in zip(got[1:], want[1:]):
                        errs2.append(_close(g, w, 1e-4, 1e-6, what + " tail"))
    torch.cuda.synchronize()
    results["fused_power_carbon"] = {"max_abs_err": max(errs1),
                                     "cases": len(errs1)}
    results["fused_facility_power"] = {"max_abs_err": max(errs2),
                                       "cases": len(errs2)}


def _ff_inputs(gen, k, h, dev, live=None, all_down=False):
    cc = torch.randint(1, 8, (k,), generator=gen, device=dev).float()
    cg = torch.randint(0, 2, (k,), generator=gen, device=dev).float()
    fc = torch.randint(0, 16, (h,), generator=gen, device=dev).float()
    fg = torch.randint(0, 4, (h,), generator=gen, device=dev).float()
    if live is not None:  # the scheduler's inert tail and unusable hosts
        cc[live:] = float("inf")
        cg[live:] = float("inf")
        down = torch.rand(h, generator=gen, device=dev) < 0.2
        fc[down] = -float("inf")
        fg[down] = -float("inf")
        cg[:max(live // 4, 1)] = 0.0  # zero-footprint GPU demand
    if all_down:
        fc.fill_(-float("inf"))
        fg.fill_(-float("inf"))
    return cc, cg, fc, fg


def _ff_same(got, want, what: str) -> float:
    """Assignments equal and free vectors bit-equal (so their inf patterns
    match); returns the free vectors' max abs error over finite entries."""
    check(torch.equal(got[0], want[0]), f"{what}: assignments differ")
    err = 0.0
    for g, w in zip(got[1:], want[1:]):
        check(torch.equal(g.view(torch.int32), w.view(torch.int32)),
              f"{what}: free vectors not bit-equal")
        fin = torch.isfinite(w)
        if bool(fin.any()):
            err = max(err, _err(g[fin], w[fin]))
    return err


def check_first_fit(dev, results: dict) -> None:
    """Kernel 4 on both variants, bit for bit against its plain version: H
    on both sides of every boundary of the warp variant (32 hosts a lane,
    1024 a warp) and on the block variant up to 20000; K in {4, 16, 64,
    100} (100: a last partial group of 32 demands); every slot live, or the
    scheduler's inert tail with -inf (down) hosts and zero GPU demands, or
    every host down; and B = 3 and 5 rows of different data in one
    launch."""
    gen = torch.Generator(device=dev).manual_seed(2)
    errs, variants = [], set()
    for h in (1, 3, 31, 32, 64, 300, 972, 1024, 1025, 2048, 20000):
        variants.add(ff_k.variant(h))
        for k in (4, 16, 64, 100):
            for live, down in ((None, False), (k // 2, False),
                               (k // 2, True)):
                args = _ff_inputs(gen, k, h, dev, live, down)
                got = ff_k.first_fit_place(*args)
                errs.append(_ff_same(got, ref.first_fit_place(*args),
                                     f"first_fit_place k={k} h={h} "
                                     f"live={live} all_down={down}"))
                if down:
                    check(bool((got[0] == -1).all()),
                          f"first_fit_place h={h}: placed on a down host")
    check(variants == {"warp", "block"}, f"variants run: {variants}")
    for h in (972, 2048):
        for b in (3, 5):
            rows = [_ff_inputs(gen, 64, h, dev, 40) for _ in range(b)]
            args = [torch.stack(x) for x in zip(*rows)]
            got = ff_k.first_fit_place(*args)
            for i in range(b):
                errs.append(_ff_same(
                    [g[i] for g in got],
                    ref.first_fit_place(*(a[i] for a in args)),
                    f"first_fit_place batched b={b} h={h} row {i}"))
    torch.cuda.synchronize()
    results["first_fit_place"] = {"max_abs_err": max(errs),
                                  "cases": len(errs),
                                  "variants": sorted(variants)}


def facility_traces(s: int, dev):
    """The main path's exogenous traces: region 0 of the synthetic carbon
    traces and the weather / price / PV sinusoids of the simulator bench."""
    t = np.arange(s) * DT_H
    ci = make_region_traces(s, DT_H, 8, seed=0)[0]
    price = (0.1 * (1 + 0.5 * np.sin(2 * np.pi * t / 24))).astype(np.float32)
    wb = (14.0 + 6.0 * np.sin(2 * np.pi * t / 24)).astype(np.float32)
    cf = np.clip(np.sin(2 * np.pi * (t - 6.0) / 24.0), 0.0, 1.0).astype(
        np.float32)
    to = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    return to(ci), to(wb), to(price), to(cf)


def main_config(n_steps: int, embodied, n_hosts: int = 972,
                **kw) -> C.SimConfig:
    return C.SimConfig(
        dt_h=DT_H, n_steps=n_steps, embodied=embodied,
        cooling=C.CoolingConfig(enabled=True, heat_reuse_fraction=0.3),
        pricing=C.PricingConfig(enabled=True, billing_window_h=24.0),
        renewables=C.RenewableConfig(enabled=True, pv_capacity_kw=500.0),
        battery=C.BatteryConfig(enabled=True,
                                capacity_kwh=KWH_PER_HOST * n_hosts, **kw),
        shifting=C.ShiftingConfig(enabled=True))


def facility_args(cfg, it_kw, traces):
    ci, wb, price, cf = traces
    bt, rising = battery.precompute_battery_signals(ci, cfg.dt_h, cfg.battery)
    if cfg.battery.enabled and cfg.battery.policy != "carbon":
        plo, phi = pricing.precompute_price_signals(price, cfg.dt_h,
                                                    cfg.battery)
    else:
        plo = phi = torch.zeros_like(ci)
    return (it_kw, ci, wb, price, plo, phi, cf, bt, rising)


def _totals_close(got, want, rtol, atol, what) -> tuple[float, float]:
    """(max abs, max rel) error over the totals, each within tolerance."""
    check(set(got) == set(want), f"{what}: keys differ")
    errs, rels = [], []
    for key in want:
        g, w = got[key].double(), want[key].double()
        errs.append(_close(g, w, rtol, atol, f"{what} {key}"))
        rels.append(errs[-1] / max(float(w.abs()), 1e-6))
    return max(errs), max(rels)


# kernel 3's [4, S] cases: a horizon inside one tile (1, 255), the main
# path's (2880: three tiles, the last partial) and a year at 15 minutes
# (35,040: 35 tiles)
ROW_STEPS = (1, 255, MAIN_STEPS, 35040)
# per scenario row: battery capacity (kWh), rate (kW), initial SoC, dispatch
# lambda (blended policy: 0 is the price policy, 1 the carbon one) and PV
# capacity (kW).  Row 0's battery fills or empties in one 15-minute step,
# so it is driven both to its capacity and to 0.
ROW_PARAMS = {"batt_capacity_kwh": (60.0, 2000.0, 8748.0, 30000.0),
              "batt_rate_kw": (240.0, 500.0, 2187.0, 100.0),
              "soc0": (0.0, 2000.0, 4374.0, 30000.0),
              "dispatch_lambda": (0.0, 0.3, 0.7, 1.0),
              "pv_capacity_kw": (0.0, 200.0, 500.0, 2000.0)}


def facility_rows_case(dev, gen, s: int, errs: list) -> dict:
    """Kernel 3 on [4, S] rows that differ in every per-row parameter (the
    scenario grid's layout), every technique on, against the plain version
    row by row (rtol 1e-4, atol 1e-3); where the horizon is long enough,
    checks that a row's battery reached its capacity and 0."""
    from repro_torch.core.engine import facility_totals_from_flows
    b = len(ROW_PARAMS["soc0"])
    cfg = main_config(s, C.EmbodiedConfig(), policy="blended")
    traces = facility_traces(s, dev)
    it_kw = 700.0 + 300.0 * torch.rand((b, s), generator=gen, device=dev)
    args = facility_args(cfg, it_kw, traces)
    per_row = {k: torch.tensor(v, device=dev) for k, v in ROW_PARAMS.items()}
    got = fs_k.fused_facility_totals(*args, cfg, **per_row)
    # past the main path's horizon the plain chain runs on the CPU, where
    # its eager loop over a year's steps (an op a launch on the card) takes
    # a fraction of the card's time
    pdev = torch.device("cpu") if s > MAIN_STEPS else dev
    args = [a.to(pdev) for a in args]
    full = empty = False
    for r in range(b):
        kw = {k: v[r] for k, v in ROW_PARAMS.items()}
        flows = ref.fused_facility_chain(args[0][r], *args[1:], cfg.dt_h, cfg,
                                         **kw)
        want = facility_totals_from_flows(flows, args[1], args[3], cfg)
        errs.append(_totals_close({k: v[r].to(pdev) for k, v in got.items()},
                                  want, 1e-4, 1e-3,
                                  f"fused_facility_totals [{b}, {s}] row {r}"))
        soc = flows["soc"]
        full |= bool((soc == kw["batt_capacity_kwh"]).any())
        empty |= bool(((soc[1:] == 0.0) & (soc[:-1] > 0.0)).any())
    if s >= 255:
        check(full and empty, f"[{b}, {s}]: no battery reached both its "
              f"capacity ({full}) and 0 ({empty})")
    return {"rows": b, "reached_capacity": full, "reached_zero": empty}


# rows at the edges of kernel 3's SoC chain (capacity kWh, rate kW, initial
# SoC): an initial SoC above the capacity (the charge's clamp at 0); a rate
# of 2^-100 kW from an empty battery, whose SoC stays in (0, 2^-100); the
# same from 40 x 2^-100 kWh; and the main path's battery
ROUTE_ROWS = {"batt_capacity_kwh": (60.0, 2.0 ** -60, 2.0 ** -60, 8748.0),
              "batt_rate_kw": (240.0, 2.0 ** -100, 2.0 ** -100, 2187.0),
              "soc0": (90.0, 0.0, 40 * 2.0 ** -100, 4374.0)}


def facility_routes_case(dev, dt: float, errs: list) -> list:
    """Kernel 3 on [4, 2880] ROUTE_ROWS (the chain's edge rows) with
    cooling and PV off (the chain's inputs are then exact) against a
    sequential walk, the plain version on the CPU (the step's reciprocal
    products, as the kernel's): SoC, last decision, grid peak, last
    window's peak and the demand charge (windows billed in order) equal in
    f32, the other totals at rtol 1e-4, atol 1e-3.  Returns the rows' final
    SoC."""
    from repro_torch.core.engine import facility_totals_from_flows
    s, ws, f = MAIN_STEPS, 96, np.float32
    cfg = C.SimConfig(
        dt_h=dt, n_steps=s, cooling=C.CoolingConfig(enabled=False),
        renewables=C.RenewableConfig(enabled=False),
        pricing=C.PricingConfig(enabled=True, billing_window_h=ws * dt),
        battery=C.BatteryConfig(enabled=True, policy="carbon"))
    cpu = torch.device("cpu")
    it_kw = 700.0 + 300.0 * torch.rand(
        (4, s), generator=torch.Generator().manual_seed(6))
    args = facility_args(cfg, it_kw, facility_traces(s, cpu))
    acc = fs_k.launch(*fs_k.prepare(
        *(a.to(dev) for a in args), cfg,
        **{k: torch.tensor(v, device=dev) for k, v in ROUTE_ROWS.items()}))
    acc = acc.cpu()
    got = fs_k.totals_from_rows(acc, cfg)
    dc = f(cfg.pricing.demand_charge_per_kw)
    for r in range(4):
        kw = {k: v[r] for k, v in ROUTE_ROWS.items()}
        what = f"fused_facility_totals route row {r}, step {dt} h"
        flows = ref.fused_facility_chain(it_kw[r], *args[1:], dt, cfg, **kw)
        want = facility_totals_from_flows(flows, args[1], args[3], cfg)
        grid = flows["grid_import_kw"].numpy()
        demand, peak = f(0), f(0)
        for w0 in range(0, s, ws):
            if w0:
                demand = f(demand + f(peak * dc))
            peak = max(f(0), grid[w0:w0 + ws].max())
        want["demand_cost"], want["window_peak_kw"] = demand, peak
        exact = ("soc_final", "was_charging", "peak_power", "window_peak_kw",
                 "demand_cost")
        for k in exact:
            check(got[k][r].item() == f(want[k]).item(),
                  f"{what}: {k} {got[k][r].item()} != {f(want[k]).item()}")
        errs.append(_totals_close(
            {k: v[r] for k, v in got.items() if k not in exact},
            {k: v for k, v in want.items() if k not in exact}, 1e-4, 1e-3,
            what))
    return [float(v) for v in got["soc_final"]]


def check_facility_kernel(dev, results: dict) -> None:
    """Kernel 3 at S = 2880: the 2^3 facility combos x {carbon, price,
    blended} with f32 traces (rtol 1e-4, atol 1e-3); [4, S] rows of
    different batteries, lambdas and PV for S in ROW_STEPS
    (`facility_rows_case`); the SoC chain's edge rows at steps of 0.1 and
    2^-21 h (`facility_routes_case`); and the bf16 / int8 stores: tight
    against the plain version on the same stored traces, and within 5e-3 /
    1e-2 relative of the f32 chain on the decision-free energy totals with
    the battery off."""
    s = MAIN_STEPS
    traces = facility_traces(s, dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    it_kw = 700.0 + 300.0 * torch.rand(s, generator=gen, device=dev)
    errs = []
    for cool in (False, True):
        for price in (False, True):
            for renew in (False, True):
                for policy in ("carbon", "price", "blended"):
                    cfg = main_config(s, C.EmbodiedConfig(), policy=policy,
                                      dispatch_lambda=0.5).replace(
                        cooling=C.CoolingConfig(enabled=cool,
                                                heat_reuse_fraction=0.3),
                        pricing=C.PricingConfig(enabled=price,
                                                billing_window_h=24.0),
                        renewables=C.RenewableConfig(enabled=renew,
                                                     pv_capacity_kw=500.0))
                    args = facility_args(cfg, it_kw, traces)
                    got = fs_k.fused_facility_totals(*args, cfg)
                    want = ref.fused_facility_totals(*args, cfg)
                    errs.append(_totals_close(
                        got, want, 1e-4, 1e-3,
                        f"fused_facility_totals {cool}/{price}/{renew}/"
                        f"{policy}"))
    rows = {n: facility_rows_case(dev, gen, n, errs) for n in ROW_STEPS}
    routes = {f"dt_{dt:g}": facility_routes_case(dev, dt, errs)
              for dt in (0.1, 2.0 ** -21)}
    cfg = main_config(s, C.EmbodiedConfig()).replace(
        battery=C.BatteryConfig(enabled=False))
    args = facility_args(cfg, it_kw, traces)
    base = ref.fused_facility_totals(*args, cfg)
    envelope = {}
    for store, rel in (("bf16", 5e-3), ("int8", 1e-2)):
        got = fs_k.fused_facility_totals(*args, cfg, trace_store=store)
        want = ref.fused_facility_totals(*args, cfg, trace_store=store)
        errs.append(_totals_close(got, want, 1e-4, 1e-3,
                                  f"fused_facility_totals {store}"))
        worst = 0.0
        for key in ("grid_energy", "it_energy", "dc_energy", "op_carbon",
                    "cooling_energy", "pv_energy", "energy_cost"):
            b = float(base[key])
            worst = max(worst, abs(float(got[key]) - b) / max(abs(b), 1e-6))
        check(worst <= rel, f"{store} store: rel err {worst:.2e} > {rel}")
        envelope[store] = worst
    torch.cuda.synchronize()
    results["fused_facility_totals"] = {
        "max_abs_err": max(e for e, _ in errs),
        "max_rel_err": max(r for _, r in errs), "cases": len(errs),
        "store_rel_err": envelope, "rows": rows,
        "soc_final_by_route_row": routes}


def _ssd_inputs(gen, shape, dev, decay=0.2):
    """xdt, da, b, c of the SSD kernel; shape (B, C, Q, H, P, G, N)."""
    bt, nc, q, h, p, g, n = shape
    rn = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    return (rn(bt, nc, q, h, p) * 0.3, -rn(bt, nc, h, q).abs() * decay,
            rn(bt, nc, q, g, n) * 0.3, rn(bt, nc, q, g, n) * 0.3)


def check_ssd_kernel(dev, results: dict) -> None:
    """Kernel 5 against its plain version: the reference tests' shapes
    (B and C per head, G = H, and per group), ragged tiles, and the main
    path's shapes at B = 1, S = 1024 (zamba2: H 112, P 64, G 2, N 64;
    mamba2: H 80, P 64, G 1, N 128; Q 256), there with a slow decay
    (|da| ~ 0.04) so every position sums all earlier ones of its chunk;
    slabs of R heads sharing a group's scores where R does not divide the
    group (66 rows of 7 heads a group: R 6, slabs of 6 and 1; zamba2's
    widths at B = 1, S = 4096: R 6, slabs of 6 and a last 2), a chunk
    longer than the four shared score tiles (Q 320), P and N off the
    16-byte rows (padded by the wrapper), and zamba2's whole prefill shape
    (B 2, S 4096, R 8).  rtol / atol 1e-4 throughout: the two sum the same
    f32 products (3xTF32 on the card) in another order, over at most Q x N
    terms."""
    gen = torch.Generator(device=dev).manual_seed(5)
    errs = []
    cases = [((1, 2, 16, 4, 8, 4, 8), 0.2), ((2, 4, 32, 8, 16, 8, 16), 0.2),
             ((1, 1, 64, 16, 32, 16, 32), 0.2), ((2, 4, 32, 8, 16, 2, 16), 0.2),
             ((2, 1, 48, 6, 80, 3, 40), 0.2),
             ((1, 4, 256, 112, 64, 2, 64), 0.05),
             ((1, 4, 256, 80, 64, 1, 128), 0.05),
             ((1, 66, 32, 14, 16, 2, 16), 0.2),
             ((1, 16, 256, 112, 64, 2, 64), 0.05),
             ((2, 1, 320, 6, 32, 2, 16), 0.05),
             ((1, 2, 40, 4, 6, 2, 10), 0.2),
             ((2, 16, 256, 112, 64, 2, 64), 0.2)]
    for shape, decay in cases:
        args = _ssd_inputs(gen, shape, dev, decay)
        got = ssd_k.ssd_intra_chunk(*args)
        want = ref.ssd_intra_chunk(*args)
        errs.append(_close(got, want, 1e-4, 1e-4, f"ssd_intra_chunk {shape}"))
        del args, got, want
    torch.cuda.synchronize()
    results["ssd_intra_chunk"] = {"max_abs_err": max(errs),
                                  "cases": len(errs)}


# the flash shapes of the MoE and encoder-decoder slice (b, sq, sk, h, kv,
# d, causal, dtype, rtol, atol): qwen3-moe's and deepseek-v2's prefill (MLA:
# q / k of nope 128 + rope 64, v of 128 padded to it) and whisper-base's
# encoder, cross-attention and decoder at batch 8
MLA_QK, MLA_V = 192, 128
FLASH_NEW_SHAPES = {
    "qwen3-moe-235b-a22b": (2, 4096, 4096, 64, 4, 128, True, torch.bfloat16,
                            2.0 ** -7, 1e-4),
    "deepseek-v2-236b (MLA, v padded)": (2, 4096, 4096, 128, 128, MLA_QK,
                                         True, torch.bfloat16, 2.0 ** -7,
                                         1e-4),
    "whisper-base encoder": (8, 1500, 1500, 8, 8, 64, False, torch.bfloat16,
                             2.0 ** -7, 1e-4),
    "whisper-base cross": (8, 448, 1500, 8, 8, 64, False, torch.bfloat16,
                           2.0 ** -7, 1e-4),
    "whisper-base decoder": (8, 448, 448, 8, 8, 64, True, torch.bfloat16,
                             2.0 ** -7, 1e-4)}


def _flash_plain(q, k, v, scale: float, causal: bool, max_heads: int = 32):
    """Flash's plain version over at most `max_heads` query heads at a time
    (with their KV heads; every head's attention is its own), so the f32
    scores of the 64- and 128-head shapes fit beside the inputs."""
    kvh, g = k.shape[2], q.shape[2] // k.shape[2]
    step = max(max_heads // g, 1)
    return torch.cat([ref.flash_attention(
        q[:, :, i * g:(i + step) * g], k[:, :, i:i + step],
        v[:, :, i:i + step], scale=scale, causal=causal)
        for i in range(0, kvh, step)], dim=2)


def check_flash_kernel(dev, results: dict) -> None:
    """Kernel 6 against its plain version: the reference tests' shapes in
    f32 (2e-5) and bf16 (2e-2); causal with Sq != Sk both ways, ragged
    lengths, GQA, D = 112 and 256; and zamba2's shape at B = 1, S = 1024
    (H = KV = 32, D = 112, causal), in f32 with 1e-4 (1024-long sums
    rescaled through 16 online-softmax steps) and in bf16 element by element
    within one bf16 ulp (2^-7 of the value; both sides round an f32 result
    once) plus that f32 1e-4, since late rows average hundreds of values
    and come out far below the 2e-2 of the small shapes.  bf16 runs on the
    tensor-core kernel, f32 on the CUDA-core one: bf16 also at D = 8, 64,
    128 and 256 (GQA, Sq != Sk, ragged), a head dim off the 16-byte rows
    (D 36, padded by the wrapper), and the whole prefill shapes (B 2, S
    4096) of zamba2 (H = KV = 32, D 112), qwen2-1.5b (H 12, KV 2, D 128)
    and paligemma-3b (H 8, KV 1, D 256) under the S = 1024 rule; then the
    MoE and encoder-decoder shapes under the same rule: qwen3-moe's prefill
    (B 2, S 4096, H 64, KV 4, D 128), deepseek-v2's MLA (H = KV = 128, q
    / k of 192 and v of 128 zero-padded to 192, as `moe.mla_attention`
    passes it: the padded columns come out exactly 0) and whisper-base's
    at batch 8 (D 64, 8 heads: the encoder's 1500 x 1500 and the
    cross-attention's 448 x 1500 without the causal mask, the decoder's
    448 causal).  The plain version runs a group of heads at a time
    (`_flash_plain`)."""
    gen = torch.Generator(device=dev).manual_seed(6)
    cases = [  # (b, sq, sk, h, kv, d, causal, dtype, rtol, atol)
        (2, 64, 64, 4, 2, 16, True, torch.float32, 2e-5, 2e-5),
        (1, 128, 128, 8, 8, 32, True, torch.float32, 2e-5, 2e-5),
        (2, 32, 96, 4, 1, 16, False, torch.float32, 2e-5, 2e-5),
        (1, 48, 48, 2, 2, 8, True, torch.float32, 2e-5, 2e-5),
        (1, 64, 64, 4, 2, 16, True, torch.bfloat16, 2e-2, 2e-2),
        (1, 48, 80, 4, 2, 16, True, torch.float32, 2e-5, 2e-5),
        (1, 100, 36, 4, 4, 16, True, torch.float32, 2e-5, 2e-5),
        (1, 130, 130, 4, 2, 112, True, torch.float32, 2e-5, 2e-5),
        (1, 70, 70, 2, 1, 256, False, torch.float32, 2e-5, 2e-5),
        (1, 1024, 1024, 32, 32, 112, True, torch.float32, 1e-4, 1e-4),
        (1, 1024, 1024, 32, 32, 112, True, torch.bfloat16, 2.0 ** -7, 1e-4),
        (2, 32, 96, 4, 1, 16, False, torch.bfloat16, 2e-2, 2e-2),
        (1, 48, 80, 4, 2, 16, True, torch.bfloat16, 2e-2, 2e-2),
        (1, 100, 36, 4, 4, 16, True, torch.bfloat16, 2e-2, 2e-2),
        (1, 48, 72, 4, 2, 8, True, torch.bfloat16, 2e-2, 2e-2),
        (2, 200, 130, 8, 2, 64, True, torch.bfloat16, 2e-2, 2e-2),
        (1, 130, 300, 4, 1, 128, False, torch.bfloat16, 2e-2, 2e-2),
        (1, 130, 130, 2, 2, 112, True, torch.bfloat16, 2e-2, 2e-2),
        (1, 90, 150, 4, 2, 256, True, torch.bfloat16, 2e-2, 2e-2),
        (1, 70, 70, 2, 1, 36, True, torch.bfloat16, 2e-2, 2e-2),
        (2, 4096, 4096, 32, 32, 112, True, torch.bfloat16, 2.0 ** -7, 1e-4),
        (2, 4096, 4096, 12, 2, 128, True, torch.bfloat16, 2.0 ** -7, 1e-4),
        (2, 4096, 4096, 8, 1, 256, True, torch.bfloat16, 2.0 ** -7, 1e-4),
        *FLASH_NEW_SHAPES.values()]
    errs = {torch.float32: [], torch.bfloat16: []}
    for b, sq, sk, h, kv, d, causal, dt, rtol, atol in cases:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(dt)
                   for s in ((b, sq, h, d), (b, sk, kv, d), (b, sk, kv, d)))
        if d == MLA_QK:                  # MLA: v of 128 padded with zeros
            v[..., MLA_V:] = 0
        scale = 1.0 / math.sqrt(d)
        got = fa_k.flash_attention(q, k, v, scale=scale, causal=causal)
        want = _flash_plain(q, k, v, scale, causal)
        check(got.dtype == dt, "flash_attention keeps q's type")
        errs[dt].append(_close(got, want, rtol, atol,
                               f"flash_attention {(b, sq, sk, h, kv, d)} "
                               f"causal={causal} {dt}"))
        if d == MLA_QK:
            check(not bool(got[..., MLA_V:].any()),
                  "flash_attention: MLA's padded columns not zero")
        del q, k, v, got, want
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    results["flash_attention"] = {
        "max_abs_err": max(errs[torch.float32] + errs[torch.bfloat16]),
        "max_abs_err_f32": max(errs[torch.float32]),
        "max_abs_err_bf16": max(errs[torch.bfloat16]),
        "cases": len(cases)}


def _host_sum_inputs(gen, b: int, t: int, h: int, dev, running=0.03,
                     hosts: int = MARCONI_ACTIVE, shared: bool = False):
    """The task table's columns as the scheduler hands them to the per-host
    sums ([T] rows for b = 0): status (RUNNING for a share `running` of the
    tasks), host among the first `hosts` or -1 (a running task that holds
    no host adds nothing), and cores, GPUs and their utilizations, [B, T],
    or one [1, T] row shared by the rows (`shared`, a grid's columns that
    no step writes).  Returns (status, host, cores, gpus, cpu_util,
    gpu_util)."""
    shape = (b, t) if b else (t,)
    vshape = (1, t) if shared and b else shape
    status = torch.where(torch.rand(shape, generator=gen, device=dev)
                         < running, RUNNING, PENDING).to(torch.int32)
    host = torch.randint(-1, min(hosts, h), shape, generator=gen,
                         device=dev).to(torch.int32)
    cores = torch.tensor([4.0, 8.0, 16.0, 32.0, 48.0], device=dev)[
        torch.randint(0, 5, vshape, generator=gen, device=dev)]
    gpus = torch.randint(0, 5, vshape, generator=gen, device=dev).float()
    utils = [torch.rand(vshape, generator=gen, device=dev) for _ in range(2)]
    return status, host, cores, gpus, *utils


def check_host_sum(dev, results: dict) -> None:
    """The per-host sum kernel against its plain version on the task
    table's columns: at Marconi's shapes (T = 192,817, H = 972, 3 %
    running, [T] and [64, T] rows, and [64, T] status and host with [1, T]
    value columns shared by the rows), at H = 4096, with every task
    running on 3 hosts (chains of ~6,700 adds; [B, T] and [1, T] values)
    and with no tasks (tests/test_torch_card.py adds 2.2 M tasks); each
    unweighted (`free_capacity`'s call) and weighted by utilization
    (`host_utilization`'s): two launches give the same bits, and the plain
    version on the CPU (`scatter_add_`, task order) the same bits too; the
    plain version on the card (atomic adds, any order) within the
    reference's tolerance between its executors (rtol 1e-5; its 1e-6
    margin between orders of tests/test_megakernel.py holds for 257
    values, and a host here sums up to 6,667).  The kernel leaves its
    ticket counters at 0."""
    gen = torch.Generator(device=dev).manual_seed(11)
    cases = ((0, 192817, 972, 0.03, MARCONI_ACTIVE, False),
             (64, 192817, 972, 0.03, MARCONI_ACTIVE, False),
             (64, 192817, 972, 0.03, MARCONI_ACTIVE, True),
             (4, 50000, 4096, 0.5, 4096, False),
             (2, 20000, 972, 1.0, 3, False),
             (2, 20000, 972, 1.0, 3, True),
             (1, 0, 17, 1.0, 17, False))
    err = 0.0
    for b, t, h, running, hosts, shared in cases:
        status, host, cores, gpus, cu, gu = _host_sum_inputs(
            gen, b, t, h, dev, running, hosts, shared)
        for weights in ((), (cu, gu)):
            args = (status, host, cores, gpus, h, *weights)
            what = (f"per_host_sum b={b} t={t} h={h} shared={shared} "
                    f"weighted={bool(weights)}")
            got = hs_k.per_host_sum(*args)
            again = hs_k.per_host_sum(*args)
            on_cpu = ref.per_host_sum(*(x.cpu() if torch.is_tensor(x) else x
                                        for x in args))
            plain = ref.per_host_sum(*args)
            for g, a, w, p in zip(got, again, on_cpu, plain):
                check(torch.equal(g, a), f"{what}: two launches differ")
                check(torch.equal(g.cpu(), w), f"{what}: not the CPU's bits, "
                      f"max abs err {_err(g.cpu(), w):.3e}")
                err = max(err, _close(g, p, 1e-5, 1e-5,
                                      f"{what} (card plain)"))
    torch.cuda.synchronize()
    check(not bool(hs_k._tickets[status.device].any()),
          "per_host_sum: ticket counters not left at 0")
    results["per_host_sum"] = {"max_abs_err": err, "cases": 2 * len(cases),
                               "bit_equal_to_cpu": True,
                               "repeats_bit_for_bit": True}


def host_sum_tables(gen, b: int, tasks, hosts, dev):
    """Marconi's tables laid out for a timed scheduler call, 3 % of tasks
    running on the first 750 of 972 hosts: B = 1 as `simulate` lays them
    out, B > 1 as a grid does ([B, T] status and host, the rest [1, T])."""
    tasks, hosts = cell_tables(tasks, hosts, b)
    status, host, *_ = _host_sum_inputs(gen, b, tasks.n, 972, dev)
    return tasks._replace(status=status, host=host), hosts


def time_host_sum(dev, results: dict) -> None:
    """The per-host sum kernel at Marconi's shapes as `host_utilization`
    calls it (status and host [B, T], cores, GPUs and utilizations [1, T],
    3 % running), B = 1 and the grid's B = 64: mean ms a call (CUDA
    events), device ms, beside its plain version on the card and one
    `index_add_` of both channels (bins and products made beforehand, into
    a preallocated buffer: the library yardstick, which the port never
    calls); and the device time and ms of one whole
    `scheduler.host_utilization` call.  Bound: `host_sum_bytes` (what the
    call must move on these inputs); the operations (a product and an add
    a running task and channel) are far below it.  The workspace: the
    kernel library's size at (B, T)."""
    from repro_torch.core import scheduler
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(12)
    t, h = 192817, 972
    marconi = make_workload("marconi", scale=1.0, seed=0, dt_h=DT_H,
                            horizon_days=30, device=dev)[:2]
    rows = {}
    for b in (1, 64):
        status, host, cores, gpus, cu, gu = _host_sum_inputs(
            gen, b, t, h, dev, shared=True)
        args = (status, host, cores, gpus, h, cu, gu)
        n_run = int(((status == RUNNING) & (host >= 0)).sum())
        b_ms, b_by = bound(host_sum_bytes(status, host, args[2:4] + args[5:],
                                          h), 4 * n_run)
        # the yardstick's inputs: bins (spare ones past h) and both
        # channels' products, one row after another
        run = (status == RUNNING) & (host >= 0)
        seg = (torch.where(run, host.long().clamp(0, h - 1),
                           torch.arange(h, h + t, device=dev))
               + torch.arange(b, device=dev)[:, None] * (h + t)).reshape(-1)
        stacked = torch.stack([torch.where(run, cores * cu, 0.0),
                               torch.where(run, gpus * gu, 0.0)]).reshape(
            2, -1)
        buf = torch.zeros((2, b * (h + t)), device=dev)
        tasks, hosts = host_sum_tables(gen, b, *marconi, dev)
        call = lambda: scheduler.host_utilization(  # noqa: E731
            tasks, hosts)
        rows[b] = {"ms": time_ms(lambda: hs_k.per_host_sum(*args)),
                   "plain_ms": time_ms(lambda: ref.per_host_sum(*args)),
                   "device_ms": device_ms(lambda: hs_k.per_host_sum(*args),
                                          "host_sum_kernel", reps=10),
                   "library_ms": time_ms(
                       lambda: buf.index_add_(1, seg, stacked)),
                   "library_device_ms": call_device_ms(
                       lambda: buf.index_add_(1, seg, stacked), reps=10),
                   "bound_ms": b_ms, "bound_by": b_by, "running": n_run,
                   "workspace_bytes": hs_k.workspace_bytes(b, t),
                   "host_utilization_ms": time_ms(call),
                   "host_utilization_device_ms": call_device_ms(call,
                                                                reps=10)}
        del seg, stacked, buf, tasks, hosts
    results["per_host_sum"].update(
        {**{k: rows[1][k] for k in ("ms", "plain_ms", "device_ms",
                                    "bound_ms", "bound_by", "library_ms")},
         "b64": rows[64], "device_ms_b64": rows[64]["device_ms"],
         "b1": rows[1],
         "blocks_per_sm": hs_k.blocks_per_sm(), "max_hosts": hs_k.MAX_HOSTS,
         "shape": {"t": t, "h": h, "channels": 2, "weighted": True},
         "seconds": time.perf_counter() - t0})
    torch.cuda.synchronize()


def time_kernels(dev, results: dict, main_cfg) -> None:
    """Each kernel and its plain version at the main path's shapes: H = 972
    hosts (750 on), K = 64 slots, S = 2880 steps."""
    gen = torch.Generator(device=dev).manual_seed(4)
    h, k, s = 972, 64, MAIN_STEPS
    cu, gu, ng, on = (x[0] for x in _host_inputs(gen, 1, h, dev))
    on[MARCONI_ACTIVE:] = 0.0
    ng.fill_(4.0)
    cpu, gpu = main_cfg.cpu_power, main_cfg.gpu_power
    wb = torch.full((), 20.0, device=dev)
    sp = torch.full((), main_cfg.cooling.setpoint_c, device=dev)

    def row(name, fn, plain, nbytes, nops, kname):
        b_ms, b_by = bound(nbytes, nops)
        results.setdefault(name, {}).update(
            ms=time_ms(fn), plain_ms=time_ms(plain), bound_ms=b_ms,
            bound_by=b_by, device_ms=device_ms(fn, kname), library_ms=None)

    # kernel 1 as the megakernel's demand step calls it (no carbon tail);
    # per host: 4 inputs read, 1 output written; ~16 f32 ops
    row("fused_power_carbon",
        lambda: pc_k.fused_power_carbon(cu, gu, ng, on, None, 0.0, cpu, gpu),
        lambda: ref.fused_power_carbon(cu, gu, ng, on, None, 0.0, cpu, gpu),
        20 * h + 12, 16 * h, "power_carbon_kernel")
    cool = main_cfg.cooling
    row("fused_facility_power",
        lambda: pc_k.fused_facility_power(cu, gu, ng, on, wb, sp, cpu, gpu,
                                          cool),
        lambda: ref.fused_facility_power(cu, gu, ng, on, wb, sp, cpu, gpu,
                                         cool),
        20 * h + 20, 16 * h + 20, "facility_power_kernel")
    # the launch floor of the three kernels redesigned for latency: an empty
    # kernel on each one's grid at these shapes, launched through the same
    # ctypes path and timed by the same device_ms
    floor = {}
    for name, (blocks, threads) in (
            ("fused_power_carbon", (1, pc_k.facility_block(h))),
            ("fused_facility_power", (1, pc_k.facility_block(h))),
            ("first_fit_place", ff_k.warp_grid(1))):
        ms = device_ms(lambda g=(blocks, threads): pc_k.empty_launch(
            *g, dev), "empty_kernel")
        results[name]["launch_floor_ms"] = ms
        floor[name] = {"blocks": blocks, "threads": threads,
                       "device_ms": ms}
    results["launch_floor"] = floor
    # kernel 4: all K slots live (the Marconi backlog fills them), 750
    # usable hosts; each live slot compares every host's two free values
    cc = torch.tensor([4, 8, 16, 32, 48], device=dev, dtype=torch.float32)[
        torch.randint(0, 5, (k,), generator=gen, device=dev)]
    cg = torch.randint(0, 5, (k,), generator=gen, device=dev).float()
    fc = torch.randint(0, 49, (h,), generator=gen, device=dev).float()
    fg = torch.randint(0, 5, (h,), generator=gen, device=dev).float()
    fc[MARCONI_ACTIVE:] = -float("inf")
    fg[MARCONI_ACTIVE:] = -float("inf")
    ff_name = ("first_fit_warp_kernel" if ff_k.variant(h) == "warp"
               else "first_fit_kernel")
    row("first_fit_place",
        lambda: ff_k.first_fit_place(cc, cg, fc, fg),
        lambda: ref.first_fit_place(cc, cg, fc, fg),
        8 * k + 8 * h + 4 * k + 8 * h, 2 * k * h, ff_name)
    # its fixed cost: the same launch with no candidates loads the free
    # vectors and writes them back; the rest of device_ms is the chain
    none = cc[:0]
    results["first_fit_place"]["device_ms_k0"] = device_ms(
        lambda: ff_k.first_fit_place(none, none, fc, fg), ff_name)
    # its latency bound, for any design: the K live placements are a chain
    # (each reads the free capacity the last one wrote).  Even with the H
    # hosts' free values in the registers of one warp, a placement needs a
    # subtraction (the last placement's update), a fused two-sided compare,
    # a min over the ceil(H / 32) hosts a lane holds (a tree of
    # ceil(log2) levels), one warp-wide min (`redux.sync`, one instruction)
    # and a select, each waiting on the one before
    levels = 1 + 1 + math.ceil(math.log2(math.ceil(h / 32))) + 1 + 1
    chain_cycles = k * levels * DEP_CYCLES
    results["first_fit_place"].update(
        latency_levels=k * levels, latency_cycles=chain_cycles,
        latency_bound_ms=chain_cycles / MAX_SM_HZ * 1e3)
    # kernel 3 on the main path's configuration and traces; per step ~33
    # bytes in (it, 4 f32 traces, threshold, rising, 2 price bands) and
    # ~100 f32 ops
    traces = facility_traces(s, dev)
    it_kw = 700.0 + 300.0 * torch.rand(s, generator=gen, device=dev)
    args = facility_args(main_cfg, it_kw, traces)
    prepared = fs_k.prepare(*args, main_cfg)
    row("fused_facility_totals",
        lambda: fs_k.launch(*prepared),
        lambda: ref.fused_facility_totals(*args, main_cfg),
        33 * s + 8 * 8 + 18 * 4, 100 * s, "facility_totals_kernel")
    # its latency bound: the S steps' SoC recurrence is a chain of
    # SOC_CHAIN_LEVELS dependent instructions a step
    results["fused_facility_totals"].update(
        latency_levels=s * SOC_CHAIN_LEVELS,
        latency_cycles=s * SOC_CHAIN_LEVELS * DEP_CYCLES,
        latency_bound_ms=s * SOC_CHAIN_LEVELS * DEP_CYCLES / MAX_SM_HZ * 1e3,
        launch_plan=fs_k.launch_plan(s))
    # and over a year at 15 minutes (35,040 steps, 35 tiles)
    year = 35040
    cfg_y = main_cfg.replace(n_steps=year)
    it_y = 700.0 + 300.0 * torch.rand(year, generator=gen, device=dev)
    prep_y = fs_k.prepare(*facility_args(cfg_y, it_y,
                                         facility_traces(year, dev)), cfg_y)
    results["fused_facility_totals"].update(
        device_ms_year=device_ms(lambda: fs_k.launch(*prep_y),
                                 "facility_totals_kernel", reps=10),
        latency_bound_ms_year=(year * SOC_CHAIN_LEVELS * DEP_CYCLES
                               / MAX_SM_HZ * 1e3))
    # kernel 3's derate route on the same inputs and the resilience phase's
    # chiller series: the same bytes (the derate bit rides the flag byte),
    # ~6 more f32 ops a step
    derate, _ = facility_failure_series(
        RES_SEED, s, DT_H, C.ResilienceConfig(enabled=True), device=dev)
    prep_d = fs_k.prepare(*args, main_cfg, chiller_derate=derate)
    row("fused_facility_totals_derate", lambda: fs_k.launch(*prep_d),
        lambda: ref.fused_facility_totals(*args, main_cfg,
                                          chiller_derate=derate),
        33 * s + 8 * 8 + 18 * 4, 106 * s, "facility_totals_kernel")
    results["fused_facility_totals_derate"].update(
        latency_bound_ms=s * SOC_CHAIN_LEVELS * DEP_CYCLES / MAX_SM_HZ * 1e3)
    # kernel 3's series route on the same inputs, beside the totals route
    # and the plain chain it replaces on the collect_series / probe path:
    # the same reads, and 45 bytes a step written (11 f32 series and the
    # decision byte)
    row("fused_facility_series", lambda: fs_k.launch_series(*prepared),
        lambda: ref.fused_facility_series(*args, main_cfg),
        33 * s + 8 * 8 + 45 * s + 19 * 4, 100 * s,
        "facility_totals_kernel<float, true>")
    results["fused_facility_series"].update(
        totals_route_device_ms=results["fused_facility_totals"]["device_ms"],
        latency_bound_ms=s * SOC_CHAIN_LEVELS * DEP_CYCLES / MAX_SM_HZ * 1e3,
        smem_bytes=fs_k.launch_plan(s, series=True)[2])
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phase 4 / 5: the main path
# --------------------------------------------------------------------------

HEADLINE = ("total_carbon_kg", "op_carbon_kg", "emb_carbon_kg",
            "grid_energy_kwh", "dc_energy_kwh", "it_energy_kwh",
            "cooling_energy_kwh", "water_l", "pue", "energy_cost",
            "demand_cost", "total_cost", "pv_energy_kwh", "grid_export_kwh",
            "peak_power_kw", "batt_discharged_kwh", "sla_violation_frac",
            "mean_delay_h", "done_frac", "n_done", "n_started", "n_decided",
            "n_tasks")
COUNTS = ("n_done", "n_started", "n_decided", "n_tasks", "class_n_violations",
          "class_n_decided", "class_n_started")
ENERGY_COST_CARBON = ("total_carbon_kg", "op_carbon_kg", "emb_carbon_kg",
                      "grid_energy_kwh", "dc_energy_kwh", "it_energy_kwh",
                      "cooling_energy_kwh", "energy_cost", "demand_cost",
                      "total_cost", "pv_energy_kwh", "grid_export_kwh")


def measured(fn, dev) -> tuple:
    """(fn(), {wall_s, launches, max_memory_allocated}) of one call: the
    launch counts and the peak memory are reset just before it and read
    just after, the wall ends in a synchronise."""
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, {"wall_s": wall, "launches": ops.launch_counts(),
                 "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                          if dev.type == "cuda" else None)}


def run_launches(backend: str, n_steps: int, cooling: bool = False,
                 runs: int = 1, n_chunks: int = 1,
                 series: bool = False) -> dict:
    """The launches of `runs` first-fit runs (or grid runs of `n_chunks`
    chunks): first-fit every step; the per-host sums twice a step (the
    scheduler's free capacity, the power stage's utilizations); the stage
    pipeline's power kernel every step (kernel 2 with the cooling tail,
    else kernel 1); the megakernel's kernel 1 every step and kernel 3 once
    a chunk (its series route where the run keeps series or probes)."""
    want = {"first_fit_place": n_steps, "per_host_sum": 2 * n_steps}
    if backend == "megakernel":
        want["fused_power_carbon"] = n_steps
        want["fused_facility_series" if series
             else "fused_facility_totals"] = n_chunks
    else:
        want["fused_facility_power" if cooling
             else "fused_power_carbon"] = n_steps
    return {k: v * runs for k, v in want.items()}


def expect_launches(info: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in info["launches"].items() if v}
    check(got == want, f"{what}: launches {got} != {want}")


def run_backend(tasks, hosts, ci, cfg, dyn, backend, dev):
    cfg = cfg.replace(backend=backend)
    res, info = measured(lambda: summarize(simulate(
        tasks, hosts, ci, cfg, dyn=dyn, device=dev)[0], cfg), dev)
    out = result_to_numpy(res)
    years = cfg.n_steps * cfg.dt_h / C.HOURS_PER_YEAR
    return out, {"backend": backend, **info,
                 "sim_years_per_s": years / info["wall_s"],
                 "headline": {k: out[k].tolist() for k in HEADLINE}}


def compare_backends(a: dict, b: dict, rtol: float, what: str,
                     atol: float = 1e-6, counts: tuple = COUNTS) -> None:
    for k in counts:
        check(np.array_equal(a[k], b[k]),
              f"{what}: count {k} differs: {a[k]} vs {b[k]}")
    for k in ENERGY_COST_CARBON:
        check(np.allclose(a[k], b[k], rtol=rtol, atol=atol),
              f"{what}: {k} differs: {a[k]} vs {b[k]}")


def profiled(fn, top_n: int = 8, watch: tuple = (),
             classes: tuple = ()) -> dict:
    """One call of `fn` under the profiler: wall time, summed device time
    (one stream, so it is the busy time), the idle share, the kernels that
    took the most device time, and every kernel whose name holds one of
    `watch`, wherever it ranks; with `classes` ((label, name parts), ...),
    the busy time by class, the first class whose part a kernel's name
    holds, "other" for the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the kernels themselves (device-side events); the host ops that
    # launched them carry the same time again
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(t for _, t, _ in events)
    top = sorted(events, key=lambda e: -e[1])
    by_class: dict = {}
    for k, t, _ in events:
        label = next((c for c, parts in classes
                      if any(p in k.lower() for p in parts)), "other")
        by_class[label] = by_class.get(label, 0.0) + t / 1e3
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_ms_by_class": by_class if classes else None,
            "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                             "count": n} for k, t, n in top[:top_n]],
            "watched_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                                 "count": n} for k, t, n in top
                                if any(w in k for w in watch)]}


def profile_window(tasks, hosts, cfg, dyn, ci, n_steps: int, dev) -> list:
    """Where the time goes: each backend for the first `n_steps` steps of
    the full-scale run under the profiler (after one unprofiled run)."""
    cfg = cfg.replace(n_steps=n_steps)
    dyn = {k: (v[:n_steps] if isinstance(v, torch.Tensor) else v)
           for k, v in dyn.items()}
    rows = []
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        run = lambda: summarize(simulate(  # noqa: E731
            tasks, hosts, ci[:n_steps], c, dyn=dyn, device=dev)[0], c)
        run()
        row = profiled(run, watch=("first_fit", "facility_power_kernel",
                                   "power_carbon_kernel", "host_sum"))
        rows.append({"backend": backend, "n_steps": n_steps,
                     "host_ms_per_step": row["wall_s"] / n_steps * 1e3,
                     **row})
    return rows


def main_path(dev, scale: float, n_steps: int, n_active: int,
              check_counts: bool):
    tasks, hosts, _, meta = make_workload("marconi", scale=scale, seed=0,
                                          dt_h=DT_H,
                                          horizon_days=n_steps * DT_H / 24,
                                          device=dev)
    cfg = main_config(n_steps, meta["embodied"], meta["n_hosts"])
    ci, wb, price, cf = facility_traces(n_steps, dev)
    dyn = {"n_active_hosts": n_active, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    results, infos = {}, []
    for backend in ("stage-pipeline", "megakernel"):
        res, info = run_backend(tasks, hosts, ci, cfg, dyn, backend, dev)
        results[backend] = res
        infos.append(info)
        if check_counts:
            expect_launches(info, run_launches(backend, n_steps, True),
                            backend)
        for k in HEADLINE:
            check(bool(np.all(np.isfinite(res[k]))), f"{backend}: {k} "
                  "not finite")
        check(float(res["n_done"]) > 0, f"{backend}: no task finished")
        check(1.0 < float(res["pue"]) < 2.0, f"{backend}: pue {res['pue']}")
    compare_backends(results["stage-pipeline"], results["megakernel"], 1e-4,
                     "backends")
    return meta, results, infos


# --------------------------------------------------------------------------
# phase 4e: telemetry and the probe bus
# --------------------------------------------------------------------------

# the probe bus of phase 4e: every 4th step (K = 720 samples at 2880 steps)
TEL_STRIDE = 4
# where phase 4e writes its run records, Chrome traces and profile (a
# git-ignored directory of the checkout)
TEL_DIR = os.path.join(ROOT, "results", "telemetry_smoke")


def _probe_close(a: dict, b: dict, what: str) -> float:
    """Probes (result_to_numpy's nested dicts) of two runs: steps equal,
    the values within rtol 1e-5 / atol 1e-4 (the reference's bound between
    its executors); returns the largest abs error."""
    check(np.array_equal(a["step"], b["step"]), f"{what}: probe steps")
    err = 0.0
    for f in telemetry.PROBE_VALUE_FIELDS:
        x, y = a[f], b[f]
        fin = np.isfinite(y)
        check(np.array_equal(np.isfinite(x), fin)
              and np.allclose(x[fin], y[fin], rtol=1e-5, atol=1e-4),
              f"{what}: probe {f}")
        if fin.any():
            err = max(err, float(np.abs(x[fin].astype(np.float64)
                                        - y[fin]).max()))
    return err


def _same_as_main(out: dict, main: dict, what: str) -> None:
    """Every SimResult field of `out` bit-equal to the main run's `main`:
    the per-host sums add each host's tasks in task order, so a run repeats
    on the card bit for bit."""
    for key, v in main.items():
        check(np.array_equal(out[key], v),
              f"{what}: {key} differs from the main run: {out[key]} vs {v}")


def _record_checks(rec, kind: str, dev, what: str) -> dict:
    """A run record of `kind` on `dev`: platform, peak memory (on a card),
    the compile / execute split; returns its summary."""
    card = dev.type == "cuda"
    check(rec.kind == kind and rec.platform == dev.type,
          f"{what}: record {rec.kind} on {rec.platform}")
    peak = rec.memory[0]["peak_bytes_in_use"]
    check((peak is not None and peak > 0) if card else peak is None,
          f"{what}: peak memory {peak}")
    check(rec.compile_time_s >= 0.0 and rec.execute_time_s > 0.0,
          f"{what}: compile {rec.compile_time_s} execute "
          f"{rec.execute_time_s}")
    check(rec.plain_kernels is (not card), f"{what}: plain_kernels "
          f"{rec.plain_kernels}")
    return {"kind": rec.kind, "platform": rec.platform,
            "compile_time_s": rec.compile_time_s,
            "execute_time_s": rec.execute_time_s, "compiles": rec.compiles,
            "peak_bytes": peak, "probes": rec.probes,
            "config_hash": rec.config_hash}


def telemetry_phase(dev, main: dict, scale: float, n_steps: int,
                    n_active: int, check_counts: bool) -> tuple:
    """Phase 4e: the main configuration with the probe bus on (stride
    TEL_STRIDE), through both executors in a session: launch counts the
    main run's (the megakernel's kernel 3 on its series route), every
    SimResult field bit-equal to the main run's `main` ({backend: fields};
    `_same_as_main`), the two executors' probes within rtol 1e-5 / atol
    1e-4, one "simulate" record a run and its Chrome trace parsed back;
    the session's host cost a step (192-step probed runs, off and on in
    turns, their probes bit-equal);
    the stage pipeline's stride-1 probes over 192 steps equal to its
    collect_series slices; a 16-cell Fig 12 grid with probes in two chunks
    (its record's chunk plan; cells (0, 0) and (5, 1) against their own
    runs).  Returns (lines, launch counts summed over the timed runs, the
    inputs of `telemetry_profile`)."""
    tasks, hosts, _, meta = make_workload("marconi", scale=scale, seed=0,
                                          dt_h=DT_H,
                                          horizon_days=n_steps * DT_H / 24,
                                          device=dev)
    probes_cfg = C.ProbeConfig(enabled=True, stride=TEL_STRIDE)
    cfg = main_config(n_steps, meta["embodied"], meta["n_hosts"]).replace(
        probes=probes_cfg)
    ci, wb, price, cf = facility_traces(n_steps, dev)
    dyn = {"n_active_hosts": n_active, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    lines, launches = [], dict.fromkeys(build.KERNELS, 0)
    k = telemetry.probe_capacity(n_steps, probes_cfg)
    probes = {}
    os.makedirs(TEL_DIR, exist_ok=True)
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        run = lambda: summarize(simulate(  # noqa: E731
            tasks, hosts, ci, c, dyn=dyn, device=dev)[0], c)
        want = run_launches(backend, n_steps, True,
                            series=backend == "megakernel")
        with telemetry.session(out_dir=TEL_DIR, export=False) as tel:
            res_on, on = measured(run, dev)
            recs = list(tel.records)
            path = tel.export_chrome_trace(
                os.path.join(TEL_DIR, f"trace_{backend}.json"))
        with open(path) as f:
            names = {e["name"] for e in json.load(f)["traceEvents"]}
        check("simulate" in names, f"{backend}: trace spans {names}")
        out_on = result_to_numpy(res_on)
        if check_counts:
            expect_launches(on, want, f"telemetry {backend}")
        for name, n in on["launches"].items():
            launches[name] += n
        _same_as_main(out_on, main[backend], f"telemetry {backend}")
        check(out_on["probes"]["step"].shape == (k,)
              and np.array_equal(out_on["probes"]["step"],
                                 np.arange(k) * TEL_STRIDE),
              f"{backend}: probe steps")
        check(len(recs) == 1, f"{backend}: {len(recs)} records")
        probes[backend] = out_on["probes"]
        lines.append({"phase": "telemetry", "part": "run",
                      "backend": backend, "probe_stride": TEL_STRIDE,
                      "probe_capacity": k,
                      "wall_s_session_on": on["wall_s"],
                      "launches": on["launches"],
                      "fields_bit_equal_to_main": True,
                      "max_memory_allocated": on["max_memory_allocated"],
                      "record": _record_checks(recs[0], "simulate", dev,
                                               backend),
                      "trace_events": len(names)})
    err = _probe_close(probes["stage-pipeline"], probes["megakernel"],
                       "executors' probes")
    mq = probes["megakernel"]["queue_depth"]
    lines.append({"phase": "telemetry", "part": "executors",
                  "probe_max_abs_err": err,
                  "queue_depth_max": float(mq.max()),
                  "soc_kwh_range": [float(probes["megakernel"]["soc_kwh"]
                                          .min()),
                                    float(probes["megakernel"]["soc_kwh"]
                                          .max())]})
    win = 192
    wdyn = {k2: (v[:win] if isinstance(v, torch.Tensor) else v)
            for k2, v in dyn.items()}
    # the session's host cost a step: 192-step probed runs with the session
    # off and on, in turns (off, on, on, off, off, on, on, off)
    probed = {}
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(n_steps=win, backend=backend)
        run = lambda: summarize(simulate(  # noqa: E731
            tasks, hosts, ci[:win], c, dyn=wdyn, device=dev)[0], c)
        run()
        walls = {False: [], True: []}
        for on in (False, True, True, False) * 2:
            with (telemetry.session(out_dir=TEL_DIR, export=False) if on
                  else contextlib.nullcontext()):
                res, info = measured(run, dev)
            walls[on].append(info["wall_s"])
            probed[on] = result_to_numpy(res)["probes"]
        # the session moves no probe bit: runs with and without it equal
        for f in ("step", *telemetry.PROBE_VALUE_FIELDS):
            check(np.array_equal(probed[True][f], probed[False][f],
                                 equal_nan=True),
                  f"{backend}: session on vs off: probe {f} differs")
        lines.append({"phase": "telemetry", "part": "session_cost",
                      "backend": backend, "n_steps": win,
                      "probes_bit_equal_on_vs_off": True,
                      "wall_s_session_off": walls[False],
                      "wall_s_session_on": walls[True],
                      "host_ms_per_step": (float(np.median(walls[True]))
                                           - float(np.median(walls[False])))
                      / win * 1e3})
    # the stage pipeline's stride-1 probes against its collect_series
    c = cfg.replace(n_steps=win, collect_series=True,
                    probes=C.ProbeConfig(enabled=True, stride=1))
    final, ys = simulate(tasks, hosts, ci[:win], c, dyn=wdyn, device=dev)
    p = summarize(final, c).probes
    check(torch.equal(p.step.cpu(), torch.arange(win, dtype=torch.int32)),
          "window: probe steps")
    for f in EnergyFlow._fields:
        check(torch.equal(getattr(p, f), getattr(ys["flow"], f)),
              f"window: probe {f} != its series")
    check(torch.equal(p.soc_kwh, ys["battery_charge"]), "window: soc")
    lines.append({"phase": "telemetry", "part": "window", "n_steps": win,
                  "probes_equal_series": True})
    # a 16-cell Fig 12 grid with probes in two chunks, in a session
    axes = grid_axes(8, 2, n_steps, cfg.battery.capacity_kwh)
    mega = cfg.replace(backend="megakernel")
    with telemetry.session(out_dir=TEL_DIR, export=False) as tel:
        res, info = measured(lambda: sweep_grid(
            tasks, hosts, mega, axes, dyn=dyn, chunk_size=4, device=dev),
            dev)
        recs = [r for r in tel.records if r.kind == "grid"]
        chunks = len(tel.span_durations("grid.chunk"))
    if check_counts:
        # a step loop a chunk
        expect_launches(info, run_launches("megakernel", n_steps, True,
                                           runs=2, series=True),
                        "telemetry grid")
    for name, n in info["launches"].items():
        launches[name] += n
    check(len(recs) == 1 and chunks == 2, f"grid: {len(recs)} records, "
          f"{chunks} chunk spans")
    rec = recs[0]
    check(rec.grid_shape == [8, 2] and rec.chunk["chunk_size"] == 4
          and rec.chunk["n_chunks"] == 2 and rec.chunk["auto"] is False
          and rec.chunk["predicted_bytes_per_lead"] > 0
          and rec.chunk["actual_payload_bytes"] > 0
          and rec.trace_dtypes == {"ci_trace": "float32"},
          f"grid record: {rec}")
    out = result_to_numpy(res)
    check(out["probes"]["step"].shape == (8, 2, k), "grid probe shape")
    cell_probes = lambda i, j: {f: v[i, j] for f, v in  # noqa: E731
                                out["probes"].items()}
    errs = [_probe_close(cell_probes(0, 0), probes["megakernel"],
                         "grid cell (0, 0) vs the main probed run")]
    rci = make_region_traces(n_steps, DT_H, GRID_REGIONS, seed=0)
    final, _ = simulate(tasks, hosts, rci[5], mega, device=dev, dyn={
        **dyn, "batt_capacity_kwh": np.float32(cfg.battery.capacity_kwh)
        * np.float32(GRID_CAP_FACTORS[1])})
    errs.append(_probe_close(
        cell_probes(5, 1), result_to_numpy(summarize(final, mega))["probes"],
        "grid cell (5, 1) vs its own run"))
    lines.append({"phase": "telemetry", "part": "grid", "shape": [8, 2],
                  "wall_s": info["wall_s"], "launches": info["launches"],
                  "max_memory_allocated": info["max_memory_allocated"],
                  "chunk": rec.chunk, "record": _record_checks(
                      rec, "grid", dev, "grid"),
                  "cell_probe_max_abs_err": max(errs)})
    return lines, launches, (tasks, hosts, cfg, dyn, ci)


def telemetry_profile(ctx, n_steps: int) -> dict:
    """`telemetry.profile` of the probed megakernel over its first
    `n_steps` steps: wall, the Chrome trace written and parsed back, and
    the stage scopes found in it (the run in a session)."""
    tasks, hosts, cfg, dyn, ci = ctx
    cfg = cfg.replace(n_steps=n_steps, backend="megakernel")
    dyn = {k: (v[:n_steps] if isinstance(v, torch.Tensor) else v)
           for k, v in dyn.items()}
    logdir = os.path.join(TEL_DIR, "profile")
    t0 = time.perf_counter()
    with telemetry.session(out_dir=TEL_DIR, export=False):
        out, logdir = telemetry.profile(
            lambda: summarize(simulate(tasks, hosts, ci[:n_steps], cfg,
                                       dyn=dyn, device=ci.device)[0], cfg),
            logdir=logdir)
    wall = time.perf_counter() - t0
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    scopes = sorted(n for n in names if n.startswith(("megakernel.",
                                                      "stage_")))
    check("megakernel.demand" in names and "megakernel.facility" in names,
          f"profile: stage scopes {scopes}")
    check(out.probes is not None, "profile: no probes")
    return {"phase": "telemetry", "part": "profile", "n_steps": n_steps,
            "wall_s": wall, "trace_bytes": os.path.getsize(path),
            "trace_events": len(events), "scopes": scopes}


# --------------------------------------------------------------------------
# phase 4c: the scenario grid (paper Fig 12: regions x battery sizes)
# --------------------------------------------------------------------------

GRID_REGIONS = 8
# the main phase's 8748 kWh battery first, then further sizes; a grid of C
# capacities takes the first C, so each grid's cells repeat the smaller
# grids' and its cell 0 is the main phase's run
GRID_CAP_FACTORS = (1.0, 0.5, 0.25, 0.125, 1.5, 2.0, 3.0, 4.0)
GRID_SHAPES = ((1, 1), (8, 2), (8, 8))


def grid_axes(n_regions: int, n_caps: int, n_steps: int, kwh: float):
    """The Fig 12 axes: the first `n_regions` of the 8 synthetic carbon
    regions (region 0 is the main phase's trace) x the first `n_caps`
    battery capacities."""
    ci = make_region_traces(n_steps, DT_H, GRID_REGIONS, seed=0)
    caps = np.float32(kwh) * np.float32(GRID_CAP_FACTORS[:n_caps])
    return [trace_axis(ci[:n_regions]), dyn_axis(batt_capacity_kwh=caps)]


def grid_run(tasks, hosts, cfg, dyn, axes, backend, dev) -> tuple:
    """One grid run: (numpy fields [R, C], info) with wall time, aggregate
    simulated years a second, launch counts and peak device memory."""
    cfg = cfg.replace(backend=backend)
    res, info = measured(lambda: sweep_grid(tasks, hosts, cfg, axes,
                                            dyn=dyn, device=dev), dev)
    out = result_to_numpy(res)
    b = int(np.prod(out["n_done"].shape))
    years = b * cfg.n_steps * cfg.dt_h / C.HOURS_PER_YEAR
    return out, {"backend": backend, "cells": b,
                 "shape": list(out["n_done"].shape), **info,
                 "sim_years_per_s": years / info["wall_s"]}


def cell(res: dict, idx) -> dict:
    return {k: v[idx] for k, v in res.items()}


def check_grid_launches(info: dict, n_steps: int, n_chunks: int) -> None:
    """A grid run launches each kernel as often as one run does: once a
    step (the facility kernel once a chunk), whatever the number of cells."""
    expect_launches(info, run_launches(info["backend"], n_steps, True,
                                       n_chunks=n_chunks),
                    f"grid {info['shape']} {info['backend']}")


def grid_phase(dev, main: dict, scale: float, n_steps: int, n_active: int,
               check_counts: bool, profile_steps: int = 0) -> tuple:
    """The Fig 12 grid at the main phase's configuration for each shape of
    GRID_SHAPES (B = 1, 16, 64) and each backend: every cell finite, cell
    0 (and the whole B = 1 grid) equal to the main phase's run `main`
    ({backend: fields}), every cell of an 8 x 2 megakernel grid over the
    first SINGLES_STEPS steps equal to its own `simulate`, the B = 64 cells
    that repeat B = 16's equal to them,
    and the backends equal cell by cell ("equal": `compare_backends`).
    The timed runs come first, then the checks' single runs, then the
    profiles: the main phase's single run (`profile_window`) and each grid
    (`grid_profile`), so no timed run follows a profiled one.  Returns
    (info rows, launch counts summed over the timed grid runs, the single
    run's profile rows, seconds of each part)."""
    tasks, hosts, _, meta = make_workload("marconi", scale=scale, seed=0,
                                          dt_h=DT_H,
                                          horizon_days=n_steps * DT_H / 24,
                                          device=dev)
    cfg = main_config(n_steps, meta["embodied"], meta["n_hosts"])
    _, wb, price, cf = facility_traces(n_steps, dev)
    dyn = {"n_active_hosts": n_active, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    kwh = cfg.battery.capacity_kwh
    rows, launches, res = [], dict.fromkeys(build.KERNELS, 0), {}
    t0 = time.perf_counter()
    for r, c in GRID_SHAPES:
        axes = grid_axes(r, c, n_steps, kwh)
        grid = ScenarioGrid(axes, base_dyn=dyn)
        n_chunks = -(-r // grid._auto_chunk_size(tasks, hosts, cfg, None))
        for backend in ("stage-pipeline", "megakernel"):
            out, info = grid_run(tasks, hosts, cfg, dyn, axes, backend, dev)
            info["n_chunks"] = n_chunks
            if check_counts:
                check_grid_launches(info, n_steps, n_chunks)
            for k, n in info["launches"].items():
                launches[k] += n
            for k in HEADLINE:
                check(bool(np.all(np.isfinite(out[k]))),
                      f"grid {info['shape']} {backend}: {k} not finite")
            compare_backends(cell(out, (0, 0)), main[backend], 1e-4,
                             f"grid {info['shape']} {backend} cell 0 vs the "
                             "main run")
            res[(r, c, backend)] = out
            rows.append(info)
        compare_backends(res[(r, c, "stage-pipeline")],
                         res[(r, c, "megakernel")], 1e-4,
                         f"grid {r}x{c}: backends")
    seconds = {"grid_runs": time.perf_counter() - t0}
    t0 = time.perf_counter()
    big = res[(8, 8, "megakernel")]
    for backend in ("stage-pipeline", "megakernel"):
        compare_backends(cell(res[(8, 8, backend)], np.s_[:, :2]),
                         res[(8, 2, backend)], 1e-4,
                         f"{backend}: B = 64 cells vs B = 16")
    # every cell of an 8 x 2 megakernel grid against its own run, over the
    # first SINGLES_STEPS steps
    s1 = min(n_steps, SINGLES_STEPS)
    mega = cfg.replace(n_steps=s1, backend="megakernel")
    dyn1 = {k: (v[:s1] if isinstance(v, torch.Tensor) else v)
            for k, v in dyn.items()}
    few = result_to_numpy(sweep_grid(tasks, hosts, mega,
                                     grid_axes(8, 2, s1, kwh), dyn=dyn1,
                                     device=dev))
    ci1 = make_region_traces(s1, DT_H, GRID_REGIONS, seed=0)
    for i, j in np.ndindex(*few["n_done"].shape):
        final, _ = simulate(tasks, hosts, ci1[i], mega, device=dev, dyn={
            **dyn1, "batt_capacity_kwh":
                np.float32(kwh) * np.float32(GRID_CAP_FACTORS[j])})
        compare_backends(cell(few, (i, j)),
                         result_to_numpy(summarize(final, mega)), 1e-4,
                         f"grid 8x2 ({s1} steps) cell ({i}, {j}) vs its own "
                         "simulate")
    ci = make_region_traces(n_steps, DT_H, GRID_REGIONS, seed=0)
    check(not np.array_equal(big["total_carbon_kg"][0],
                             big["total_carbon_kg"][1])
          and not np.array_equal(big["total_carbon_kg"][:, 0],
                                 big["total_carbon_kg"][:, 1]),
          "grid cells do not differ along both axes")
    seconds["singles"] = time.perf_counter() - t0
    profile = []
    if profile_steps:
        t0 = time.perf_counter()
        profile = profile_window(tasks, hosts, cfg, dyn,
                                 torch.as_tensor(ci[0], device=dev),
                                 profile_steps, dev)
        for info in rows:
            r, c = info["shape"]
            info["profile"] = grid_profile(tasks, hosts, cfg, dyn, r, c,
                                           info["backend"], profile_steps,
                                           dev)
        seconds["profiles"] = time.perf_counter() - t0
    return rows, launches, profile, seconds


def grid_profile(tasks, hosts, cfg, dyn, r: int, c: int, backend: str,
                 n_steps: int, dev) -> dict:
    """Where the time goes in a grid run: its first `n_steps` steps under
    the profiler (after one unprofiled run)."""
    cfg = cfg.replace(n_steps=n_steps, backend=backend)
    dyn = {k: (v[:n_steps] if isinstance(v, torch.Tensor) else v)
           for k, v in dyn.items()}
    axes = grid_axes(r, c, n_steps, cfg.battery.capacity_kwh)
    run = lambda: sweep_grid(tasks, hosts, cfg, axes, dyn=dyn,  # noqa: E731
                             device=dev)
    run()
    row = profiled(run, watch=("first_fit", "facility_power_kernel",
                               "power_carbon_kernel",
                               "facility_totals_kernel", "host_sum"))
    return {"n_steps": n_steps, "host_ms_per_step": row["wall_s"] / n_steps
            * 1e3, **row}


def small_grid_card_vs_cpu(dev) -> dict:
    """The 8 x 2 grid at a small scale (0.05, 192 steps, 38 active hosts)
    on `dev` (the card) and with the plain versions on the CPU, cell by
    cell."""
    out, seconds = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        tasks, hosts, _, meta = make_workload("marconi", scale=0.05, seed=0,
                                              dt_h=DT_H, horizon_days=2.0,
                                              device=d)
        cfg = main_config(192, meta["embodied"], meta["n_hosts"])
        _, wb, price, cf = facility_traces(192, d)
        dyn = {"n_active_hosts": 38, "price_trace": price,
               "wet_bulb_trace": wb, "pv_cf_trace": cf}
        axes = grid_axes(8, 2, 192, cfg.battery.capacity_kwh)
        for backend in ("stage-pipeline", "megakernel"):
            out[(side, backend)] = grid_run(tasks, hosts, cfg, dyn, axes,
                                            backend, d)[0]
        seconds[side] = time.perf_counter() - t0
    for backend in ("stage-pipeline", "megakernel"):
        compare_backends(out[("card", backend)], out[("cpu", backend)], 1e-4,
                         f"small grid card vs cpu ({backend})")
    return {"cells": int(out[("cpu", "megakernel")]["n_done"].size),
            "n_done": out[("card", "megakernel")]["n_done"].tolist(),
            "seconds": seconds}


def small_tasktrace_card_vs_cpu(dev) -> dict:
    """A task-trace grid at a small scale (0.05, 192 steps, 38 active
    hosts): 4 arrival sets x 2 carbon regions, then the same with priority
    levels and an interactive share (one admission order a cell), on `dev`
    (the card) and with the plain versions on the CPU, cell by cell."""
    out, seconds = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        tasks, hosts, _, meta = make_workload("marconi", scale=0.05, seed=0,
                                              dt_h=DT_H, horizon_days=2.0,
                                              device=d)
        cfg = main_config(192, meta["embodied"], meta["n_hosts"])
        _, wb, price, cf = facility_traces(192, d)
        dyn = {"n_active_hosts": 38, "price_trace": price,
               "wet_bulb_trace": wb, "pv_cf_trace": cf}
        ci = make_region_traces(192, DT_H, GRID_REGIONS, seed=0)[:2]
        axes = [tasktrace_axis(make_arrival_sets(tasks.n, 192, DT_H, 4,
                                                 seed=0)), trace_axis(ci)]
        prio = (cfg.replace(scheduler=C.SchedulerConfig(priority_levels=3)),
                axes + [dyn_axis(interactive_frac=np.float32([0.0, 0.3]))])
        for name, (c, ax) in (("plain", (cfg, axes)), ("priority", prio)):
            for backend in ("stage-pipeline", "megakernel"):
                out[(side, name, backend)] = result_to_numpy(sweep_grid(
                    tasks, hosts, c.replace(backend=backend), ax, dyn=dyn,
                    device=d))
        seconds[side] = time.perf_counter() - t0
    for name in ("plain", "priority"):
        for backend in ("stage-pipeline", "megakernel"):
            compare_backends(out[("card", name, backend)],
                             out[("cpu", name, backend)], 1e-4,
                             f"small task-trace grid ({name}) card vs cpu "
                             f"({backend})")
    done = out[("card", "plain", "megakernel")]["n_done"]
    check(len(set(done[:, 0].tolist())) > 1,
          "small task-trace grid: the arrival sets gave one outcome")
    return {"shape": list(done.shape), "n_done": done.tolist(),
            "priority_shape": list(
                out[("card", "priority", "megakernel")]["n_done"].shape),
            "seconds": seconds}


def time_kernels_at_rows(dev, main_cfg, b: int) -> dict:
    """Device ms of kernels 1-4 a launch at the grid's row shapes: [b, 972]
    hosts (750 on), [b, 64] candidates, [b, 2880] steps with a battery per
    row."""
    gen = torch.Generator(device=dev).manual_seed(5)
    h, k, s = 972, 64, MAIN_STEPS
    cu, gu, ng, on = _host_inputs(gen, b, h, dev)
    on[:, MARCONI_ACTIVE:] = 0.0
    ng.fill_(4.0)
    cpu, gpu = main_cfg.cpu_power, main_cfg.gpu_power
    wb = torch.full((b,), 20.0, device=dev)
    sp = torch.full((b,), main_cfg.cooling.setpoint_c, device=dev)
    cc = torch.tensor([4, 8, 16, 32, 48], device=dev, dtype=torch.float32)[
        torch.randint(0, 5, (b, k), generator=gen, device=dev)]
    cg = torch.randint(0, 5, (b, k), generator=gen, device=dev).float()
    fc = torch.randint(0, 49, (b, h), generator=gen, device=dev).float()
    fg = torch.randint(0, 5, (b, h), generator=gen, device=dev).float()
    fc[:, MARCONI_ACTIVE:] = -float("inf")
    fg[:, MARCONI_ACTIVE:] = -float("inf")
    it_kw = 700.0 + 300.0 * torch.rand((b, s), generator=gen, device=dev)
    args = facility_args(main_cfg, it_kw, facility_traces(s, dev))
    caps = torch.tensor(np.float32(main_cfg.battery.capacity_kwh)
                        * np.float32(GRID_CAP_FACTORS), device=dev)
    prepared = fs_k.prepare(*args, main_cfg,
                            batt_capacity_kwh=caps.repeat(b // 8 + 1)[:b])
    return {"rows": b, "device_ms": {
        "fused_power_carbon": device_ms(lambda: pc_k.fused_power_carbon(
            cu, gu, ng, on, None, 0.0, cpu, gpu), "power_carbon_kernel"),
        "fused_facility_power": device_ms(
            lambda: pc_k.fused_facility_power(cu, gu, ng, on, wb, sp, cpu,
                                              gpu, main_cfg.cooling),
            "facility_power_kernel"),
        "first_fit_place": device_ms(lambda: ff_k.first_fit_place(
            cc, cg, fc, fg), "first_fit_warp_kernel"),
        "fused_facility_totals": device_ms(lambda: fs_k.launch(*prepared),
                                           "facility_totals_kernel",
                                           reps=10),
        "fused_facility_series": device_ms(
            lambda: fs_k.launch_series(*prepared), "facility_totals_kernel",
            reps=10)}}


# --------------------------------------------------------------------------
# phase 4a: host failures, checkpointing and the closed resilience loop
# --------------------------------------------------------------------------

# the resilience phase's seed: within the 30 days its chiller is derated
# for 12 h and a PDU is down for 4 h (`facility_failure_series`), so both
# facility processes and kernel 3's derate route act on the main path
RES_SEED = 1
# the grid: seeds x failure_hazard_scale (0.0 is a healthy datacenter)
RES_GRID_SEEDS = (RES_SEED, 2)
RES_GRID_HAZARDS = (1.0, 0.0)
# the PDU clamp while a PDU is down: this share of the open-loop run's mean
# IT draw, below its peak, so the clamp engages
RES_PDU_SHARE = 0.8
# threefry-2x32-20 known answers (Random123 kat_vectors): key, counter, out
THREEFRY_KAT = (((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
                ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF),
                 (0x1cb996fc, 0xbb002be7)),
                ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
                 (0xc4923a9c, 0x483df7a0)))
RES_COUNTS = COUNTS + ("n_interrupts",)


def resilience_config(cfg: C.SimConfig, pdu_cap_kw: float) -> C.SimConfig:
    """The main configuration with host failures, checkpointing and the
    closed loop (reactive placement, heat-correlated host failures, a
    finite PDU clamp)."""
    return cfg.replace(
        seed=RES_SEED,
        failures=C.FailureConfig(enabled=True, checkpointing=True),
        resilience=C.ResilienceConfig(enabled=True, reactive_placement=True,
                                      heat_hazard_mult=2.0,
                                      pdu_cap_kw=pdu_cap_kw))


def check_threefry(dev) -> dict:
    """Threefry and the failure draws on the card, bit for bit: the three
    known-answer vectors; 4 x 192,817 uniforms against the CPU's; the
    main path's failure probabilities (the reference's exp, in f64 fused
    multiply-adds on the card) and its [2880, 1, 972] failure draws and
    keys against the CPU's; the exp over 2^20 inputs in [-87, 87]."""
    cpu = torch.device("cpu")
    for key, ctr, want in THREEFRY_KAT:
        got = threefry.threefry2x32(*(torch.tensor(v, device=dev)
                                      for v in (*key, *ctr)))
        check(tuple(int(x) for x in got) == want,
              f"threefry {key} {ctr}: {[hex(int(x)) for x in got]}")
    n = 192817
    seeds = [0, 3, 12345, -1]
    u = [threefry.uniform(threefry.prng_key(seeds, d), n) for d in (dev, cpu)]
    check(torch.equal(u[0].cpu(), u[1]), "threefry uniforms: card != CPU")
    x = torch.linspace(-87.0, 87.0, 1 << 20)
    check(torch.equal(failures.exp_f32(x.to(dev)).cpu(),
                      failures.exp_f32(x)), "exp_f32: card != CPU")
    rcfg = C.ResilienceConfig(enabled=True, heat_hazard_mult=2.0)
    derate, _ = facility_failure_series(RES_SEED, MAIN_STEPS, DT_H, rcfg,
                                        device=cpu)
    hazard = 1.0 + 2.0 * (1.0 - derate)
    p = [failures.failure_probability(hazard.to(d), DT_H, 1000.0)
         for d in (dev, cpu)]
    check(torch.equal(p[0].cpu(), p[1]), "failure probability: card != CPU")
    draws = [failures.draw_host_failures(RES_SEED, pi, 972, d)
             for pi, d in ((p[0], dev), (p[1], cpu))]
    for a, b, what in zip(draws[0], draws[1], ("keys", "draws")):
        check(torch.equal(a.cpu(), b), f"failure {what}: card != CPU")
    return {"known_answers": len(THREEFRY_KAT), "uniforms": 4 * n,
            "exp_inputs": x.numel(), "derated_steps": int((derate < 1).sum()),
            "draws": int(draws[0][1].numel()),
            "failures_drawn": int(draws[0][1].sum())}


def check_facility_derate(dev, results: dict) -> None:
    """Kernel 3's derate route at S = 2880 against the plain chain on the
    same series (the resilience phase's chiller: 48 derated steps): the
    main configuration in each trace store and each dispatch policy, and
    [4, S] rows with a seed a row (rtol 1e-4, atol 1e-3)."""
    s = MAIN_STEPS
    traces = facility_traces(s, dev)
    gen = torch.Generator(device=dev).manual_seed(7)
    rcfg = C.ResilienceConfig(enabled=True)
    derate, _ = facility_failure_series(RES_SEED, s, DT_H, rcfg, device=dev)
    check(bool((derate < 1).any()), "no derated step in the series")
    it_kw = 700.0 + 300.0 * torch.rand(s, generator=gen, device=dev)
    errs = []
    for store in STORES:
        for policy in ("carbon", "blended"):
            cfg = main_config(s, C.EmbodiedConfig(), policy=policy,
                              dispatch_lambda=0.5).replace(resilience=rcfg)
            args = facility_args(cfg, it_kw, traces)
            got = fs_k.fused_facility_totals(*args, cfg, trace_store=store,
                                             chiller_derate=derate)
            want = ref.fused_facility_totals(*args, cfg, trace_store=store,
                                             chiller_derate=derate)
            errs.append(_totals_close(got, want, 1e-4, 1e-3,
                                      f"derate route {store}/{policy}"))
            healthy = fs_k.fused_facility_totals(*args, cfg,
                                                 trace_store=store)
            check(float(got["cooling_energy"])
                  > float(healthy["cooling_energy"]),
                  f"derate route {store}/{policy}: no more cooling energy")
    seeds = np.array([RES_SEED, 2, 3, 4])
    rows, _ = facility_failure_series(seeds, s, DT_H, rcfg, device=dev)
    cfg = main_config(s, C.EmbodiedConfig()).replace(resilience=rcfg)
    it_rows = 700.0 + 300.0 * torch.rand((4, s), generator=gen, device=dev)
    args = facility_args(cfg, it_rows, traces)
    got = fs_k.fused_facility_totals(*args, cfg, chiller_derate=rows)
    for r in range(4):
        want = ref.fused_facility_totals(it_rows[r], *args[1:], cfg,
                                         chiller_derate=rows[r])
        errs.append(_totals_close({k: v[r] for k, v in got.items()}, want,
                                  1e-4, 1e-3, f"derate route row {r}"))
    torch.cuda.synchronize()
    results["fused_facility_totals_derate"] = {
        "max_abs_err": max(e for e, _ in errs),
        "max_rel_err": max(r for _, r in errs), "cases": len(errs),
        "derated_steps": int((derate < 1).sum()),
        "derated_steps_rows": [int(x) for x in (rows < 1).sum(1)]}


def check_facility_series(dev, results: dict) -> None:
    """Kernel 3's series route at S = 2880, B = 1 (the main configuration,
    an [S] input) and B = 64 (rows of different batteries and dispatch
    lambdas, blended policy), each trace store, healthy and derated (the
    resilience phase's chiller), against the plain chain on the CPU, whose
    divisions by a constant are the same products with the reciprocal as
    the kernel's: `soc` and `want_charge` bit-equal, the derate echo equal,
    every flow within kernel 3's rtol 1e-4 / atol 1e-3; with f32 traces,
    against the plain chain on the card within the same tolerance (and the
    steps whose SoC differs from it counted); and the totals lanes
    bit-equal to the totals route's on the same inputs.  Records the
    largest error of each field."""
    s = MAIN_STEPS
    traces = facility_traces(s, dev)
    gen = torch.Generator(device=dev).manual_seed(9)
    rcfg = C.ResilienceConfig(enabled=True)
    derate, _ = facility_failure_series(RES_SEED, s, DT_H, rcfg, device=dev)
    cpu = torch.device("cpu")
    err_cpu: dict = {}
    err_card: dict = {}
    soc_moved_card = 0
    cases = 0
    b64 = 64
    rows = {"batt_capacity_kwh": torch.linspace(60.0, 30000.0, b64,
                                                device=dev),
            "dispatch_lambda": torch.linspace(0.0, 1.0, b64, device=dev)}
    for b in (1, b64):
        if b == 1:
            cfg = main_config(s, C.EmbodiedConfig())
            it_kw = 700.0 + 300.0 * torch.rand(s, generator=gen, device=dev)
            kw = {}
        else:
            cfg = main_config(s, C.EmbodiedConfig(), policy="blended")
            it_kw = 700.0 + 300.0 * torch.rand((b, s), generator=gen,
                                               device=dev)
            kw = dict(rows)
        args = facility_args(cfg, it_kw, traces)
        for store in STORES:
            # the CPU chain reads the traces the kernel reads (dequantized
            # on the card)
            stored = {i: ref.stored_trace(args[i], store) for i in (1, 2, 3,
                                                                     6)}
            cpu_args = [stored.get(i, a).to(cpu) for i, a in
                        enumerate(args)]
            for der in (None, derate):
                what = f"series route b={b} {store} derate={der is not None}"
                c = cfg if der is None else cfg.replace(resilience=rcfg)
                extra = dict(kw, trace_store=store)
                if der is not None:
                    extra["chiller_derate"] = der
                flows, tot = fs_k.fused_facility_series(*args, c, **extra)
                route = fs_k.fused_facility_totals(*args, c, **extra)
                on_cpu, _ = ref.fused_facility_series(
                    *cpu_args, c, **{k: v.to(cpu) if isinstance(
                        v, torch.Tensor) else v for k, v in extra.items()
                        if k != "trace_store"})
                check(set(flows) == set(on_cpu), f"{what}: keys differ")
                got = {k: v.to(cpu) for k, v in flows.items()}
                for key in ("soc", "want_charge", "chiller_derate"):
                    want = on_cpu[key].expand_as(got[key])
                    check(torch.equal(got[key], want),
                          f"{what}: {key} not bit-equal to the CPU chain, "
                          f"max abs err "
                          f"{_err(got[key].float(), want.float())}")
                for key in fs_k.SERIES_FIELDS:
                    e = _close(got[key], on_cpu[key], 1e-4, 1e-3,
                               f"{what} {key} (CPU chain)")
                    err_cpu[key] = max(err_cpu.get(key, 0.0), e)
                if store == "f32":
                    on_card, _ = ref.fused_facility_series(*args, c, **extra)
                    soc_moved_card += int((flows["soc"] != on_card["soc"]
                                           .expand_as(flows["soc"])).sum())
                    for key in fs_k.SERIES_FIELDS:
                        e = _close(flows[key], on_card[key], 1e-4, 1e-3,
                                   f"{what} {key} (card chain)")
                        err_card[key] = max(err_card.get(key, 0.0), e)
                for key, v in route.items():
                    check(torch.equal(tot[key], v),
                          f"{what}: total {key} differs from the totals "
                          f"route: {tot[key]} vs {v}")
                cases += 1
    torch.cuda.synchronize()
    results["fused_facility_series"] = {
        "max_abs_err": max(err_cpu.values()), "cases": cases,
        "field_max_abs_err_vs_cpu_chain": err_cpu,
        "field_max_abs_err_vs_card_chain": err_card,
        "soc_steps_differing_from_card_chain": soc_moved_card,
        "soc_want_charge_bit_equal_to_cpu_chain": True,
        "totals_bit_equal_to_totals_route": True}


def _res_checks(res: dict, what: str, acted: bool) -> None:
    """Finite headline numbers, tasks done; with `acted`, the loop acted:
    interrupts, lost work, derated and throttled hours all above 0."""
    for k in HEADLINE:
        check(bool(np.all(np.isfinite(res[k]))), f"{what}: {k} not finite")
    check(float(np.min(res["n_done"])) > 0, f"{what}: no task finished")
    if acted:
        for k in ("n_interrupts", "derate_h", "throttled_h", "lost_work_h"):
            check(float(np.min(res[k])) > 0, f"{what}: {k} is 0: the loop "
                  "did not act")


def compare_resilience(a: dict, b: dict, what: str, open_a: dict,
                       open_b: dict) -> None:
    """Two executors' results `a` and `b` (the resilience path's, and the
    experiments phase's at the main run's active hosts): counts and
    `n_interrupts` exact; energy, cost and operational carbon within rtol
    1e-5, atol 1e-4.  Embodied carbon is load-independent: the stage
    pipeline sums it a step at a time in f32 and the megakernel takes the
    closed form, 1.5e-5 apart over 2880 steps with or without the loop, so
    each executor's equals its own open-loop run's (`open_a`, `open_b`) bit
    for bit instead, and the total is the sum of the two."""
    for k in RES_COUNTS:
        check(np.array_equal(a[k], b[k]),
              f"{what}: count {k} differs: {a[k]} vs {b[k]}")
    for k in ENERGY_COST_CARBON:
        if k not in ("emb_carbon_kg", "total_carbon_kg"):
            check(np.allclose(a[k], b[k], rtol=1e-5, atol=1e-4),
                  f"{what}: {k} differs: {a[k]} vs {b[k]}")
    for x, o, side in ((a, open_a, "first"), (b, open_b, "second")):
        check(bool(np.all(x["emb_carbon_kg"] == o["emb_carbon_kg"])),
              f"{what}: emb_carbon_kg of the {side} differs from its "
              f"open-loop run: {x['emb_carbon_kg']} vs {o['emb_carbon_kg']}")


def pdu_cap_kw(open_loop: dict, n_steps: int) -> float:
    """RES_PDU_SHARE of an open-loop run's mean IT draw (kW)."""
    return (RES_PDU_SHARE * float(open_loop["it_energy_kwh"])
            / (n_steps * DT_H))


def resilience_inputs(dev, scale: float, n_steps: int, n_active: int,
                      cap: float, hazard: float | None = None):
    """(tasks, hosts, cfg, ci, dyn) of the resilience path; `hazard` sets
    the dyn `failure_hazard_scale`."""
    tasks, hosts, _, meta = make_workload("marconi", scale=scale, seed=0,
                                          dt_h=DT_H,
                                          horizon_days=n_steps * DT_H / 24,
                                          device=dev)
    cfg = resilience_config(
        main_config(n_steps, meta["embodied"], meta["n_hosts"]), cap)
    ci, wb, price, cf = facility_traces(n_steps, dev)
    dyn = {"n_active_hosts": n_active, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    if hazard is not None:
        dyn["failure_hazard_scale"] = hazard
    return tasks, hosts, cfg, ci, dyn


def resilience_path(dev, scale: float, n_steps: int, n_active: int,
                    cap: float, open_loop: dict, check_counts: bool,
                    acted: bool, grid: bool = True,
                    hazard: float | None = None) -> dict:
    """The main configuration with failures and the closed loop (seed
    RES_SEED, a PDU clamp of `cap` kW) through both executors, then as a
    `sweep_grid` of RES_GRID_SEEDS x RES_GRID_HAZARDS: launch counts exact,
    with `acted` the loop acted (interrupts, derated and throttled hours,
    lost work), the executors equal (`compare_resilience`; `open_loop`
    holds each executor's open-loop result at the same scale), the grid's
    (RES_SEED, 1.0) cell the single run (rtol 1e-4), its hazard-0 cells
    free of failures.  `hazard` scales every failure rate of the single
    runs (a grid sweeps it)."""
    tasks, hosts, cfg, ci, dyn = resilience_inputs(dev, scale, n_steps,
                                                   n_active, cap, hazard)
    out = {"pdu_cap_kw": cap, "runs": [], "grid": [],
           "launches": dict.fromkeys(build.KERNELS, 0)}
    results = {}
    for backend in ("stage-pipeline", "megakernel"):
        res, info = run_backend(tasks, hosts, ci, cfg, dyn, backend, dev)
        # kernel 1 (the PDU clamp sits between the IT sum and the cooling
        # model: no kernel 2), kernel 3 on its derate route
        if check_counts:
            expect_launches(info, run_launches(backend, n_steps),
                            f"resilience {backend}")
        for k, n in info["launches"].items():
            out["launches"][k] += n
        _res_checks(res, f"resilience {backend}", acted)
        info["resilience"] = {k: float(res[k]) for k in (
            "n_interrupts", "lost_work_h", "derate_h", "throttled_h")}
        results[backend] = res
        out["runs"].append(info)
    compare_resilience(results["stage-pipeline"], results["megakernel"],
                       "resilience backends", open_loop["stage-pipeline"],
                       open_loop["megakernel"])
    a, b = results["stage-pipeline"], results["megakernel"]
    out["backend_rel_diff"] = {
        k: float(np.max(np.abs(a[k] - b[k]) / np.maximum(np.abs(b[k]), 1e-9)))
        for k in ENERGY_COST_CARBON}
    out["open_loop_vs_closed"] = {
        k: [float(open_loop["megakernel"][k]), float(b[k])]
        for k in ("total_carbon_kg", "op_carbon_kg", "it_energy_kwh",
                  "cooling_energy_kwh", "total_cost", "n_done",
                  "sla_violation_frac", "lost_work_h", "throttled_h")}
    if grid:
        axes = [seed_axis(np.array(RES_GRID_SEEDS)),
                dyn_axis(failure_hazard_scale=np.float32(RES_GRID_HAZARDS))]
        res_g = {}
        for backend in ("stage-pipeline", "megakernel"):
            c = cfg.replace(backend=backend)
            g, ginfo = measured(lambda: sweep_grid(
                tasks, hosts, c, axes, ci_trace=ci, dyn=dyn, device=dev), dev)
            g = result_to_numpy(g)
            wall, counts = ginfo["wall_s"], ginfo["launches"]
            if check_counts:
                expect_launches(ginfo, run_launches(backend, n_steps),
                                f"resilience grid {backend}")
            for k, n in counts.items():
                out["launches"][k] += n
            compare_backends(cell(g, (0, 0)), results[backend], 1e-4,
                             f"resilience grid {backend} cell (seed "
                             f"{RES_SEED}, 1.0) vs the single run",
                             counts=RES_COUNTS)
            check(bool((g["n_interrupts"][:, 1] == 0).all()
                       and (g["derate_h"][:, 1] == 0).all()),
                  f"resilience grid {backend}: hazard 0 failed something")
            check(not acted or float(g["n_interrupts"][1, 0]) > 0,
                  f"resilience grid {backend}: seed 2 had no interrupts")
            res_g[backend] = g
            years = g["n_done"].size * n_steps * DT_H / C.HOURS_PER_YEAR
            out["grid"].append({
                "backend": backend, "shape": list(g["n_done"].shape),
                "wall_s": wall, "sim_years_per_s": years / wall,
                "launches": counts,
                "n_interrupts": g["n_interrupts"].tolist(),
                "derate_h": g["derate_h"].tolist()})
        compare_resilience(res_g["stage-pipeline"], res_g["megakernel"],
                           "resilience grid backends",
                           open_loop["stage-pipeline"],
                           open_loop["megakernel"])
    out["results"] = results
    return out


# the small run's failure_hazard_scale: its two days see host and
# facility failures and the PDU clamp
SMALL_RES_HAZARD = 20.0


def small_resilience_card_vs_cpu(dev, small: dict) -> dict:
    """The resilience configuration at a small scale (0.05, 192 steps, 38
    active hosts, the PDU clamp from the CPU's open-loop run, every failure
    rate x SMALL_RES_HAZARD) on the card and on the CPU: both executors,
    the loop acted, counts and `n_interrupts` exact, the rest within rtol
    1e-4.  `small` holds the open-loop results on each side ({'cuda' |
    'cpu': {backend: fields}})."""
    out, info = {}, {}
    cap = pdu_cap_kw(small["cpu"]["megakernel"], 192)
    for d in (dev, torch.device("cpu")):
        r = resilience_path(d, 0.05, 192, 38, cap, small[d.type],
                            d.type == "cuda", False, grid=False,
                            hazard=SMALL_RES_HAZARD)
        for i in r["runs"]:
            check(i["resilience"]["n_interrupts"] > 0
                  and i["resilience"]["derate_h"] > 0,
                  f"small resilience run on {d.type}: the loop did not act")
        out[d.type] = r["results"]
        info[d.type] = [i["resilience"] for i in r["runs"]]
    for backend in ("stage-pipeline", "megakernel"):
        compare_backends(out["cuda"][backend], out["cpu"][backend], 1e-4,
                         f"resilience card vs cpu ({backend})",
                         counts=RES_COUNTS)
    return {"pdu_cap_kw": cap, **info}


# --------------------------------------------------------------------------
# phase 4b: the paper's experiment tooling (aggregate scheduling, the §III
# gap, a task-trace grid, the scaling search, the CLI)
# --------------------------------------------------------------------------

# the reference package's answers at full-scale Marconi on the CPU
# (scripts/reference_experiments.py): the main configuration with
# scheduler mode 'aggregate', 750 active hosts, both executors
AGG_COUNTS = {"n_done": 143947.0, "n_started": 145227.0,
              "n_decided": 185230.0, "n_tasks": 192817.0}
# `find_min_scale` over the default configuration (no techniques, carbon
# region 0, megakernel), lo 1, hi 972: at the paper's 1 % target no scale
# is enough (972 hosts violate 66.6 %); at 80 % the search bisects
SCALING_LO, SCALING_TARGETS = 1, (0.01, 0.80)
SCALING_KAT = {
    0.01: (973, {972: 0.6662365794181824}),
    0.80: (943, {486: 0.9558602571487427, 729: 0.9061059355735779,
                 851: 0.8608055114746094, 912: 0.832721471786499,
                 942: 0.8014576435089111, 957: 0.7222102284431458,
                 950: 0.755336582660675, 946: 0.7879339456558228,
                 944: 0.7944339513778687, 943: 0.7992441654205322})}
# the SLA-violation fraction of that configuration at three scales
SLA_CURVE_KAT = {972: 0.6662365794181824, 750: 0.9007720351219177,
                 600: 0.9365869164466858}
TASKTRACE_SETS = 8
ANALYTICAL_RTOL, ANALYTICAL_ATOL = 1e-5, 1e-4


def experiments_phase(dev, main: dict, scale: float, n_steps: int,
                      n_active: int, full: bool) -> tuple:
    """Phase 4b at `scale` on `dev`.  `main` holds the main phase's results
    ({backend: fields}) at the same scale.  On the card every run's launch
    counts are checked; `full` checks the reference's known answers too
    (full-scale Marconi).  Returns (one line per part, launch counts
    summed over the phase)."""
    on = dev.type == "cuda"
    tasks, hosts, _, meta = make_workload("marconi", scale=scale, seed=0,
                                          dt_h=DT_H,
                                          horizon_days=n_steps * DT_H / 24,
                                          device=dev)
    n_hosts = meta["n_hosts"]
    cfg = main_config(n_steps, meta["embodied"], n_hosts)
    ci, wb, price, cf = facility_traces(n_steps, dev)
    dyn = {"n_active_hosts": n_active, "price_trace": price,
           "wet_bulb_trace": wb, "pv_cf_trace": cf}
    lines, total = [], dict.fromkeys(build.KERNELS, 0)

    def add(part: str, info: dict, **kw):
        for k, n in info["launches"].items():
            total[k] += n
        lines.append({"phase": "experiments", "part": part, **info, **kw})

    # (a) aggregate scheduling through both executors: first-fit never
    # launches, the counts are the reference's
    agg_cfg = cfg.replace(scheduler=C.SchedulerConfig(mode="aggregate"))
    # its f32 cumsums of core needs are exact in any order, and its
    # half-integer midpoints too, while every task's cores sum below 2^23
    core_sum = float(tasks.cores.double().sum())
    check(core_sum < 2.0 ** 23, f"aggregate: the core needs sum to "
          f"{core_sum}, past f32's exact half-integers")
    agg = {}
    for backend in ("stage-pipeline", "megakernel"):
        c = agg_cfg.replace(backend=backend)
        out, info = measured(lambda: result_to_numpy(summarize(simulate(
            tasks, hosts, ci, c, dyn=dyn, device=dev)[0], c)), dev)
        want = run_launches(backend, n_steps, True)
        want.pop("first_fit_place")
        if on:
            expect_launches(info, want, f"aggregate {backend}")
        for k in HEADLINE:
            check(bool(np.all(np.isfinite(out[k]))),
                  f"aggregate {backend}: {k} not finite")
        if full:
            got = {k: float(out[k]) for k in AGG_COUNTS}
            check(got == AGG_COUNTS, f"aggregate {backend}: counts {got} "
                  f"!= the reference's {AGG_COUNTS}")
        agg[backend] = out
        add("aggregate", info, backend=backend, core_sum=core_sum,
            n_done=float(out["n_done"]),
            sla_violation_frac=float(out["sla_violation_frac"]),
            first_fit_n_done=float(main[backend]["n_done"]),
            first_fit_sla_violation_frac=float(
                main[backend]["sla_violation_frac"]))
    compare_resilience(agg["stage-pipeline"], agg["megakernel"],
                       "aggregate backends", main["stage-pipeline"],
                       main["megakernel"])

    # (b) the §III gap: the analytical model over every task against the
    # simulated shifting savings (no other technique, every host on)
    arrival, duration = tasks.arrival, tasks.duration
    valid = torch.isfinite(arrival)
    savings = analytical.analytical_shifting_savings
    (a_mean, a_tasks), info = measured(lambda: savings(
        arrival[valid], duration[valid], ci, DT_H, device=dev), dev)
    card_s = info["wall_s"]
    t0 = time.perf_counter()
    c_mean, c_tasks = savings(
        arrival[valid].cpu(), duration[valid].cpu(), ci.cpu(), DT_H,
        device="cpu")
    cpu_s = time.perf_counter() - t0
    err = _close(a_tasks.cpu().double(), c_tasks.double(), ANALYTICAL_RTOL,
                 ANALYTICAL_ATOL, "analytical savings, card vs cpu")
    _close(a_mean.cpu().double(), c_mean.double(), ANALYTICAL_RTOL,
           ANALYTICAL_ATOL, "analytical mean savings, card vs cpu")
    plain = C.SimConfig(dt_h=DT_H, n_steps=n_steps, embodied=meta["embodied"],
                        backend="megakernel")
    op = {}
    for shift in (False, True):
        c = plain.replace(shifting=C.ShiftingConfig(enabled=shift))
        out, sinfo = measured(lambda: result_to_numpy(summarize(simulate(
            tasks, hosts, ci, c, device=dev)[0], c)), dev)
        if on:
            expect_launches(sinfo, run_launches("megakernel", n_steps),
                            f"analytical gap run (shifting {shift})")
        for k, n in sinfo["launches"].items():
            info["launches"][k] += n
        info["wall_s"] += sinfo["wall_s"]
        if on:
            info["max_memory_allocated"] = max(
                info["max_memory_allocated"], sinfo["max_memory_allocated"])
        op[shift] = float(out["op_carbon_kg"])
    sim = 100.0 * (1.0 - op[True] / op[False])
    check(math.isfinite(float(a_mean)) and float(a_mean) > 0.0,
          f"analytical savings {float(a_mean)}")
    add("analytical_gap", info, n_tasks=int(valid.sum()),
        analytical_savings_pct=float(a_mean),
        analytical_cpu_savings_pct=float(c_mean),
        analytical_max_abs_err=err, analytical_card_s=card_s,
        analytical_cpu_s=cpu_s,
        simulated_savings_pct=sim,
        op_carbon_kg={"base": op[False], "shifting": op[True]},
        ratio=float(a_mean) / sim if sim else None)

    # (c) a task-trace grid: the workload re-timed on 8 regions' traffic
    # curves, one step loop for the 8 cells
    arrivals = make_arrival_sets(tasks.n, n_steps, DT_H, TASKTRACE_SETS,
                                 seed=0)
    axes = [tasktrace_axis(arrivals)]
    grid = ScenarioGrid(axes, base_dyn=dyn)
    n_chunks = -(-TASKTRACE_SETS // grid._auto_chunk_size(tasks, hosts, cfg,
                                                          None))
    tt = {}
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        out, info = measured(lambda: result_to_numpy(sweep_grid(
            tasks, hosts, c, axes, ci_trace=ci, dyn=dyn, device=dev)), dev)
        if on:
            expect_launches(info, run_launches(backend, n_steps, True,
                                               n_chunks=n_chunks),
                            f"task-trace grid {backend}")
        for k in HEADLINE:
            check(bool(np.all(np.isfinite(out[k]))),
                  f"task-trace grid {backend}: {k} not finite")
        check(len(set(out["n_done"].tolist())) > 1,
              f"task-trace grid {backend}: every cell the same")
        tt[backend] = out
        add("tasktrace_grid", info, backend=backend, cells=TASKTRACE_SETS,
            n_chunks=n_chunks, n_done=out["n_done"].tolist(),
            sla_violation_frac=out["sla_violation_frac"].tolist())
    compare_resilience(tt["stage-pipeline"], tt["megakernel"],
                       "task-trace grid backends", main["stage-pipeline"],
                       main["megakernel"])

    # (d) the scaling search over `with_scale` runs of the default
    # configuration: first at the paper's 1 % target, then at 80 %; then
    # the SLA curve at three scales
    evals = []

    def sla(n: int) -> float:
        evals.append(n)
        final, _ = simulate(tasks, with_scale(hosts, n), ci, plain,
                            device=dev)
        return float(summarize(final, plain).sla_violation_frac)

    for target in SCALING_TARGETS:
        evals.clear()

        (best, evaluated), info = measured(
            lambda: find_min_scale(sla, SCALING_LO, n_hosts, target), dev)
        if on:
            expect_launches(info, run_launches("megakernel", n_steps,
                                               runs=len(evals)),
                            f"scaling search at {target}")
        if full:
            check((best, evaluated) == SCALING_KAT[target],
                  f"scaling search at {target}: {(best, evaluated)} != the "
                  f"reference's {SCALING_KAT[target]}")
        check(best == n_hosts + 1 or evaluated[best] <= target,
              f"scaling search at {target}: best {best}")
        add("scaling", info, target=target, lo=SCALING_LO, hi=n_hosts,
            best=best, runs=len(evals),
            evaluated={str(k): v for k, v in evaluated.items()})
    scales = [round(n_hosts * f) for f in (1.0, 750 / 972, 600 / 972)]
    evals.clear()
    curve, info = measured(lambda: {n: sla(n) for n in scales}, dev)
    if on:
        expect_launches(info, run_launches("megakernel", n_steps,
                                           runs=len(scales)), "SLA curve")
    if full:
        check(curve == SLA_CURVE_KAT, f"SLA curve {curve} != the "
              f"reference's {SLA_CURVE_KAT}")
    add("sla_curve", info, sla={str(k): v for k, v in curve.items()})

    # (e) the CLI: 8 carbon regions with and without battery and shifting,
    # 750 active hosts, the whole Marconi workload
    days = n_steps * DT_H / 24
    argv = ["--workload", "marconi", "--scale", str(scale), "--days",
            str(days), "--regions", "8", "--techniques", "B,TS",
            "--active-hosts", str(n_active), "--tasks-cap", "200000",
            "--device", dev.type]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out, info = measured(lambda: cli.main(argv), dev)
    check(json.loads(buf.getvalue()) == out, "the CLI printed another JSON")
    check(out["n_tasks"] == meta["n_tasks"] and out["n_hosts"] == n_hosts,
          f"the CLI ran {out['n_tasks']} tasks on {out['n_hosts']} hosts")
    if on:
        expect_launches(info, run_launches("stage-pipeline",
                                           int(days * 24 / DT_H), runs=2),
                        "the CLI")
    check(all(math.isfinite(v) for v in out.values()
              if isinstance(v, float)), f"the CLI: {out}")
    add("cli", info, argv=argv, cli=out)
    return lines, total


# --------------------------------------------------------------------------
# phase 4d: the multi-datacenter fleet and spatial shifting
# --------------------------------------------------------------------------

FLEET_REGIONS = 8
FLEET_CAPACITY_FRAC = 1.5
# the fleet's PDU clamp while a PDU is down (kW a region): about 0.8 of a
# region's mean IT draw in the greedy fleet (291 kW, the reference's)
FLEET_PDU_CAP_KW = 240.0
FLEET_SEEDS = np.arange(1, FLEET_REGIONS + 1, dtype=np.int32)
FLEET_CAPS = np.float32([8748.0, 2187.0])
FLEET_GRID_CELLS = ((0, 0), (3, 1))
FLEET_COUNTS = ("n_done", "n_started", "n_decided", "n_tasks")
# the reference package's answers at full-scale Marconi on the CPU
# (scripts/reference_experiments.py, lines fleet_greedy, fleet_policies,
# fleet_spill): tasks placed a region, the sha1 of the i32 region ids, each
# region's counts; the greedy fleet's totals by executor; the spill fleet's
# counts, interrupts and spills with the spill on and off
FLEET_REF_PLACED = {
    "greedy": [33922, 28886, 35587, 37183, 40521, 9222, 0, 7496],
    "round_robin": [24103, 24102, 24102, 24102, 24102, 24102, 24102, 24102],
    "spill": [0, 132026, 0, 29291, 31500, 0, 0, 0]}
FLEET_REF_SHA1 = {"greedy": "66d558b75143a463a35f676edf6143873720907d",
                  "round_robin": "e09360bdac70bbece39c968bf69ee3d929d68eb7",
                  "spill": "7ec36e798a96617e2bb14befc29507f5f736e25d"}
FLEET_REF_COUNTS = {
    "greedy": {
        "n_done": [33922, 28886, 32595, 37183, 40521, 8117, 0, 5938],
        "n_started": [33922, 28886, 33743, 37183, 40521, 8895, 0, 7141],
        "n_decided": [33922, 28886, 34831, 37183, 40521, 8117, 0, 5938],
        "n_tasks": [33922, 28886, 35587, 37183, 40521, 9222, 0, 7496]},
    "round_robin": {
        "n_done": [23240, 23633, 23503, 23874, 23822, 23860, 23753, 23822],
        "n_started": [23706, 23754, 23619, 24094, 24093, 24086, 23895,
                      24093],
        "n_decided": [23244, 23633, 23503, 23874, 23822, 23860, 23753,
                      23822],
        "n_tasks": [24103, 24102, 24102, 24102, 24102, 24102, 24102, 24102]},
    "spill": {
        "n_done": [0, 107778, 0, 28997, 30999, 0, 0, 0],
        "n_started": [0, 108961, 0, 29291, 31500, 0, 0, 0],
        "n_decided": [0, 127583, 0, 28997, 30999, 0, 0, 0],
        "n_tasks": [0, 132026, 0, 29291, 31500, 0, 0, 0]}}
FLEET_REF_TOTALS = {
    "stage-pipeline": {
        "total_carbon_kg": 585637.375, "op_carbon_kg": 179040.5625,
        "emb_carbon_kg": 406596.8125, "grid_energy_kwh": 1178924.25,
        "dc_energy_kwh": 1787159.5, "it_energy_kwh": 1675052.25,
        "cooling_energy_kwh": 112106.796875, "water_l": 267946.9375,
        "energy_cost": 125921.375, "demand_cost": 17774608.0,
        "total_cost": 17891332.0, "pv_energy_kwh": 916404.9375,
        "grid_export_kwh": 191668.953125, "peak_power_kw": 213819.609375,
        "batt_discharged_kwh": 534262.5625,
        "sla_violation_frac": 0.6495369672775269,
        "done_frac": 0.9706716537475586},
    "megakernel": {
        "total_carbon_kg": 585631.0625, "op_carbon_kg": 179040.53125,
        "emb_carbon_kg": 406590.53125, "grid_energy_kwh": 1178924.5,
        "dc_energy_kwh": 1787160.0, "it_energy_kwh": 1675053.25,
        "cooling_energy_kwh": 112106.734375, "water_l": 267946.03125,
        "energy_cost": 125921.4140625, "demand_cost": 17774606.0,
        "total_cost": 17891332.0, "pv_energy_kwh": 916405.25,
        "grid_export_kwh": 191669.140625, "peak_power_kw": 213819.609375,
        "batt_discharged_kwh": 534262.375,
        "sla_violation_frac": 0.6495369672775269,
        "done_frac": 0.9706716537475586}}
FLEET_REF_SPILL = {
    True: {"n_done": [33848, 28876, 25861, 37162, 40520, 6880, 5, 5291],
           "n_started": [33928, 28876, 27119, 37166, 40520, 7909, 5, 6561],
           "n_decided": [33928, 28876, 34841, 37162, 40520, 6880, 5, 5291],
           "n_tasks": [33928, 28876, 35597, 37166, 40520, 9229, 5, 7496],
           "n_interrupts": [379, 464, 260, 329, 290, 61, 0, 27],
           "n_spills": [17, 28, 7, 26, 11, 10, 3, 4]},
    False: {"n_done": [33839, 28886, 25861, 37183, 40521, 6867, 0, 5292],
            "n_started": [33922, 28886, 27119, 37183, 40521, 7895, 0, 6557],
            "n_decided": [33922, 28886, 34831, 37183, 40521, 6867, 0, 5292],
            "n_tasks": [33922, 28886, 35587, 37183, 40521, 9222, 0, 7496],
            "n_interrupts": [367, 449, 255, 335, 295, 61, 0, 27],
            "n_spills": [0, 0, 0, 0, 0, 0, 0, 0]}}
# the small fleets' failure_hazard_scale: two days see interrupts, so
# tasks spill
SMALL_FLEET_HAZARD = 20.0


def fleet_spec(n_steps: int, n_active: int,
               policy: str = "greedy") -> FleetSpec:
    """The smoke test's fleet: the 8 synthetic regions' carbon and weather
    (seed 0), `n_active` hosts a region, `capacity_frac=1.5`."""
    return FleetSpec(
        ci_traces=make_region_traces(n_steps, DT_H, FLEET_REGIONS, seed=0),
        wb_traces=make_weather_traces(n_steps, DT_H, FLEET_REGIONS, seed=0),
        n_active_hosts=n_active, capacity_frac=FLEET_CAPACITY_FRAC,
        policy=policy)


def fleet_resilience(cfg: C.SimConfig, spill: bool = True) -> C.SimConfig:
    """Phase 4a's failures, checkpointing and closed loop (seed 1, heat-
    correlated failures x2, reactive placement) with the fleet's PDU clamp
    and the cross-region spill, 4 tasks a step."""
    return resilience_config(cfg, FLEET_PDU_CAP_KW).replace(
        resilience=C.ResilienceConfig(
            enabled=True, reactive_placement=True, heat_hazard_mult=2.0,
            pdu_cap_kw=FLEET_PDU_CAP_KW, spill_interrupted=spill,
            max_spills_per_step=4))


def fleet_counts(region: np.ndarray) -> dict:
    """Tasks placed a region and the sha1 of the region ids."""
    return {"placed": np.bincount(region[region >= 0],
                                  minlength=FLEET_REGIONS).tolist(),
            "region_sha1": hashlib.sha1(
                np.asarray(region, np.int32).tobytes()).hexdigest()}


def fleet_green_skew(n_steps: int, n_hosts: int) -> np.ndarray:
    """examples/fleet_sweep.py's green-skewed host plan: more hosts on
    where the grid is cleanest (the region's mean carbon rank)."""
    ci_mean, _ = trace_stats(make_region_traces(n_steps, DT_H, FLEET_REGIONS,
                                                seed=0), DT_H)
    rank = np.argsort(np.argsort(ci_mean))
    return np.clip((n_hosts * (1.0 - 0.5 * rank / (FLEET_REGIONS - 1))
                    ).astype(int), 1, n_hosts)


def fleet_run(fn, dev) -> tuple:
    """(total, per-region fields as numpy, info) of one fleet call."""
    res, info = measured(fn, dev)
    return result_to_numpy(res.total), result_to_numpy(res.per_region), info


def check_fleet_ref(per: dict, want: dict, what: str) -> None:
    for k, v in want.items():
        check(per[k].tolist() == [float(x) for x in v],
              f"{what}: {k} {per[k].tolist()} != the reference's {v}")


def compare_fleet_backends(a: dict, b: dict, what: str, emb_a=None,
                           emb_b=None, rtol: float = 1e-5) -> None:
    """Two executors' fleet fields: counts exact, energy, cost and
    operational carbon within `rtol` (atol 1e-4); embodied carbon, which
    the stage pipeline sums a step at a time and the megakernel takes in
    closed form (phase 4a), equal to each executor's own main run's
    (`emb_a`, `emb_b`; not compared where they are None)."""
    for k in (*COUNTS, "n_interrupts", "n_spills"):
        check(np.array_equal(a[k], b[k]),
              f"{what}: count {k} differs: {a[k]} vs {b[k]}")
    for k in ENERGY_COST_CARBON:
        if k not in ("emb_carbon_kg", "total_carbon_kg"):
            check(np.allclose(a[k], b[k], rtol=rtol, atol=1e-4),
                  f"{what}: {k} differs: {a[k]} vs {b[k]}")
    for x, e, side in ((a, emb_a, "first"), (b, emb_b, "second")):
        check(e is None or bool(np.all(x["emb_carbon_kg"] == e)),
              f"{what}: emb_carbon_kg of the {side} is not its main run's: "
              f"{x['emb_carbon_kg']} vs {e}")


def fleet_phase(dev, main: dict, scale: float, n_steps: int, n_active: int,
                full: bool) -> tuple:
    """Phase 4d at `scale` on `dev`: (a) the greedy fleet through both
    executors, (b) the round-robin and online (`spill`) placements, (c) a
    fleet grid of 4 host plans x 2 batteries x 8 regions, (d) the spill
    fleet under failures.  `main` holds the main phase's results at the
    same scale ({backend: fields}); on the card every run's launch counts
    are checked, and `full` checks the reference's full-scale answers.
    Returns (one line a part, launch counts summed over the runs, the
    inputs `fleet_profile` takes)."""
    on = dev.type == "cuda"
    tasks, hosts, _, meta = make_workload("marconi", scale=scale, seed=0,
                                          dt_h=DT_H,
                                          horizon_days=n_steps * DT_H / 24,
                                          device=dev)
    n_hosts = meta["n_hosts"]
    cfg = main_config(n_steps, meta["embodied"], n_hosts)
    _, _, price, cf = facility_traces(n_steps, dev)
    dyn = {"price_trace": price, "pv_cf_trace": cf}
    spec = fleet_spec(n_steps, n_active)
    lines, total = [], dict.fromkeys(build.KERNELS, 0)

    def add(part: str, info: dict, **kw):
        for k, n in info["launches"].items():
            total[k] += n
        lines.append({"phase": "fleet", "part": part, **info, **kw})

    def expect(info, want, what):
        if on:
            expect_launches(info, want, what)

    # (a) greedy placement (once, on the host), then both executors
    t0 = time.perf_counter()
    region = fleet_place(tasks, hosts, spec, DT_H, n_steps=n_steps)
    place_s = time.perf_counter() - t0
    placed = fleet_counts(region)
    if full:
        check(placed == {"placed": FLEET_REF_PLACED["greedy"],
                         "region_sha1": FLEET_REF_SHA1["greedy"]},
              f"greedy placement {placed} is not the reference's")
    greedy = {}
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        tot, per, info = fleet_run(lambda: simulate_fleet(
            tasks, hosts, c, spec, dyn=dyn, region=region, device=dev), dev)
        expect(info, run_launches(backend, n_steps, True),
               f"greedy fleet {backend}")
        for k in HEADLINE:
            check(bool(np.all(np.isfinite(per[k]))),
                  f"greedy fleet {backend}: {k} not finite")
        check(per["n_tasks"].tolist() == [float(x)
                                          for x in placed["placed"]],
              f"greedy fleet {backend}: n_tasks {per['n_tasks']} is not "
              f"the placement {placed['placed']}")
        if full:
            check_fleet_ref(per, FLEET_REF_COUNTS["greedy"],
                            f"greedy fleet {backend}")
            want = FLEET_REF_TOTALS[backend]
            for k, v in want.items():
                check(math.isclose(float(tot[k]), v, rel_tol=1e-4),
                      f"greedy fleet {backend}: total {k} {float(tot[k])} "
                      f"vs the reference's {v}")
        greedy[backend] = (tot, per)
        add("greedy", info, backend=backend, placement_s=place_s,
            **placed, n_done=per["n_done"].tolist(),
            total_carbon_kg=float(tot["total_carbon_kg"]),
            op_carbon_kg=float(tot["op_carbon_kg"]))
    compare_fleet_backends(greedy["stage-pipeline"][1],
                           greedy["megakernel"][1], "greedy fleet backends",
                           main["stage-pipeline"]["emb_carbon_kg"],
                           main["megakernel"]["emb_carbon_kg"])
    compare_fleet_backends(greedy["stage-pipeline"][0],
                           greedy["megakernel"][0],
                           "greedy fleet backends, totals")

    # (b) round-robin and the online router, megakernel
    mega = cfg.replace(backend="megakernel")
    for policy in ("round_robin", "spill"):
        t0 = time.perf_counter()
        reg = fleet_place(tasks, hosts, fleet_spec(n_steps, n_active, policy),
                          DT_H, n_steps=n_steps)
        seconds = time.perf_counter() - t0
        placed = fleet_counts(reg)
        tot, per, info = fleet_run(lambda: simulate_fleet(
            tasks, hosts, mega, spec.replace(policy=policy), dyn=dyn,
            region=reg, device=dev), dev)
        expect(info, run_launches("megakernel", n_steps, True),
               f"{policy} fleet")
        if full:
            check(placed == {"placed": FLEET_REF_PLACED[policy],
                             "region_sha1": FLEET_REF_SHA1[policy]},
                  f"{policy} placement {placed} is not the reference's")
            check_fleet_ref(per, FLEET_REF_COUNTS[policy], f"{policy} fleet")
        add("policy", info, policy=policy, placement_s=seconds,
            n_tasks=int(np.isfinite(tasks.arrival.cpu().numpy()).sum()),
            **placed, n_done=per["n_done"].tolist(),
            total_carbon_kg=float(tot["total_carbon_kg"]),
            op_carbon_kg=float(tot["op_carbon_kg"]))

    # (c) the fleet grid: 4 host plans x 2 batteries x 8 regions, 64 rows
    plans = np.stack([np.full(FLEET_REGIONS, n_hosts),
                      np.full(FLEET_REGIONS, n_active),
                      np.full(FLEET_REGIONS, n_hosts // 2),
                      fleet_green_skew(n_steps, n_hosts)]).astype(np.int32)
    caps = FLEET_CAPS * np.float32(n_hosts / 972)
    axes = [fleet_axis(n_active_hosts=plans), dyn_axis(batt_capacity_kwh=caps),
            region_axis(spec)]
    grid = ScenarioGrid(axes, base_dyn=dyn)
    split = split_by_region(tasks, region, FLEET_REGIONS, device=dev)
    n_chunks = -(-len(plans) // grid._auto_chunk_size(split, hosts, cfg,
                                                      None))
    del split
    fgrid = {}
    for backend in ("stage-pipeline", "megakernel"):
        c = cfg.replace(backend=backend)
        tot, per, info = fleet_run(lambda: grid.run(tasks, hosts, c,
                                                    device=dev), dev)
        expect(info, run_launches(backend, n_steps, True, n_chunks=n_chunks),
               f"fleet grid {backend}")
        check(per["n_done"].shape == (4, 2, FLEET_REGIONS)
              and tot["n_done"].shape == (4, 2),
              f"fleet grid {backend}: shapes {per['n_done'].shape}")
        for k in HEADLINE:
            check(bool(np.all(np.isfinite(per[k]))),
                  f"fleet grid {backend}: {k} not finite")
        fgrid[backend] = (tot, per)
        rows = per["n_done"].size
        years = rows * n_steps * DT_H / C.HOURS_PER_YEAR
        add("grid", info, backend=backend, shape=[4, 2, FLEET_REGIONS],
            rows=rows, n_chunks=n_chunks, plans=plans.tolist(),
            caps=caps.tolist(), sim_years_per_s=years / info["wall_s"],
            n_done=tot["n_done"].tolist(),
            total_carbon_kg=tot["total_carbon_kg"].tolist())
    compare_backends(fgrid["stage-pipeline"][1], fgrid["megakernel"][1],
                     1e-4, "fleet grid backends")
    # the 750-host, full-battery cell is (a)'s fleet
    compare_fleet_backends(cell(fgrid["megakernel"][1], (1, 0)),
                           greedy["megakernel"][1], "fleet grid cell (1, 0) "
                           "vs the greedy fleet")
    for k, j in FLEET_GRID_CELLS:
        one = simulate_fleet(tasks, hosts, mega, spec, dyn={
            **dyn, "n_active_hosts": plans[k], "batt_capacity_kwh": caps[j]},
            device=dev)
        for part, want in (("total", one.total),
                           ("per_region", one.per_region)):
            got = cell(fgrid["megakernel"][0 if part == "total" else 1],
                       (k, j))
            want = result_to_numpy(want)
            for f in (*COUNTS, "n_interrupts", "n_spills"):
                check(np.array_equal(got[f], want[f]),
                      f"fleet grid cell ({k}, {j}) {part}: {f} {got[f]} vs "
                      f"its simulate_fleet's {want[f]}")
            for f in ENERGY_COST_CARBON:
                check(np.allclose(got[f], want[f], rtol=1e-5, atol=1e-4),
                      f"fleet grid cell ({k}, {j}) {part}: {f} {got[f]} vs "
                      f"its simulate_fleet's {want[f]}")

    # (d) the coupled fleet under failures at full width, with the spill
    # and without it
    seeds = {"seed": FLEET_SEEDS}
    spill = {}
    for on_spill in (True, False):
        c = fleet_resilience(cfg.replace(backend="stage-pipeline"), on_spill)
        tot, per, info = fleet_run(lambda: simulate_fleet(
            tasks, hosts, c, spec, dyn={**dyn, **seeds}, region=region,
            width=tasks.n, device=dev), dev)
        expect(info, run_launches("stage-pipeline", n_steps),
               f"spill fleet (spill {on_spill})")
        for k in HEADLINE:
            check(bool(np.all(np.isfinite(per[k]))),
                  f"spill fleet ({on_spill}): {k} not finite")
        if full:
            check_fleet_ref(per, FLEET_REF_SPILL[on_spill],
                            f"spill fleet (spill {on_spill})")
        spill[on_spill] = per
        add("spill" if on_spill else "spill_off", info, width=tasks.n,
            seeds=FLEET_SEEDS.tolist(), pdu_cap_kw=FLEET_PDU_CAP_KW,
            **{k: per[k].tolist() for k in (
                "n_spills", "n_interrupts", "n_done", "lost_work_h",
                "throttled_h", "derate_h")})
    if full:
        check(float(spill[True]["n_spills"].sum()) > 0,
              "spill fleet: no task spilled")
        check(float(spill[True]["n_done"].sum())
              != float(spill[False]["n_done"].sum()),
              "spill fleet: the spill changed no outcome")
    ctx = {"tasks": tasks, "hosts": hosts, "cfg": cfg, "dyn": dyn,
           "spec": spec, "region": region, "plans": plans, "caps": caps}
    return lines, total, ctx


def fleet_profile(ctx: dict, n_steps: int, dev) -> list:
    """Where the time goes: the first `n_steps` steps of the fleet grid (c)
    on the megakernel and of the spill fleet (d) under the profiler, each
    after one unprofiled run (`ctx` from `fleet_phase`).  One executor for
    (c): a profiled run costs ~25 s of the profiler's own host time."""
    tasks, hosts, cfg, spec = ctx["tasks"], ctx["hosts"], ctx["cfg"], \
        ctx["spec"]
    s = n_steps
    dyn = {k: v[:s] for k, v in ctx["dyn"].items()}
    cut = spec.replace(ci_traces=spec.ci_traces[:, :s],
                       wb_traces=spec.wb_traces[:, :s])
    axes = [fleet_axis(n_active_hosts=ctx["plans"]),
            dyn_axis(batt_capacity_kwh=ctx["caps"]), region_axis(cut)]
    watch = ("first_fit", "facility_power_kernel", "power_carbon_kernel",
             "facility_totals_kernel")
    mega = cfg.replace(n_steps=s, backend="megakernel")
    spill = fleet_resilience(cfg.replace(n_steps=s))
    runs = [("grid", "megakernel", lambda: sweep_grid(
                tasks, hosts, mega, axes, dyn=dyn, device=dev)),
            ("spill", "stage-pipeline", lambda: simulate_fleet(
                tasks, hosts, spill, cut, dyn={**dyn, "seed": FLEET_SEEDS},
                region=ctx["region"], width=tasks.n, device=dev))]
    rows = []
    for part, backend, run in runs:
        run()
        row = profiled(run, watch=watch)
        rows.append({"phase": "fleet_profile", "part": part,
                     "backend": backend, "n_steps": s,
                     "host_ms_per_step": row["wall_s"] / s * 1e3, **row})
    return rows



def small_fleet_card_vs_cpu(dev) -> dict:
    """A small greedy fleet (both executors), a small spill fleet (every
    failure rate x SMALL_FLEET_HAZARD) and a small fleet grid (2 host plans
    x 8 regions, megakernel) at scale 0.05 over 192 steps, on `dev` (the
    card) and with the plain versions on the CPU: counts exact, totals
    within rtol 1e-4."""
    out, seconds = {}, {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        tasks, hosts, _, meta = make_workload("marconi", scale=0.05, seed=0,
                                              dt_h=DT_H, horizon_days=2.0,
                                              device=d)
        cfg = main_config(192, meta["embodied"], meta["n_hosts"])
        _, _, price, cf = facility_traces(192, d)
        dyn = {"price_trace": price, "pv_cf_trace": cf}
        spec = fleet_spec(192, 38)
        for backend in ("stage-pipeline", "megakernel"):
            out[(side, backend)] = simulate_fleet(
                tasks, hosts, cfg.replace(backend=backend), spec, dyn=dyn,
                device=d)
        out[(side, "spill")] = simulate_fleet(
            tasks, hosts, fleet_resilience(cfg), spec, device=d,
            dyn={**dyn, "seed": FLEET_SEEDS,
                 "failure_hazard_scale": SMALL_FLEET_HAZARD})
        out[(side, "grid")] = sweep_grid(
            tasks, hosts, cfg.replace(backend="megakernel"),
            [fleet_axis(n_active_hosts=np.int32([[38] * 8, [20] * 8])),
             region_axis(spec)], dyn=dyn, device=d)
        seconds[side] = time.perf_counter() - t0
    for what in ("stage-pipeline", "megakernel", "spill", "grid"):
        for part in ("total", "per_region"):
            a, b = (result_to_numpy(getattr(out[(s, what)], part))
                    for s in ("card", "cpu"))
            compare_backends(a, b, 1e-4, f"small fleet {what} {part} card "
                             "vs cpu", counts=(*COUNTS, "n_interrupts",
                                               "n_spills"))
    spills = float(out[("card", "spill")].total.n_spills)
    check(spills > 0, "small spill fleet: no task spilled")
    return {"n_done": out[("card", "megakernel")].per_region.n_done.tolist(),
            "n_spills": spills, "grid_shape": list(
                out[("card", "grid")].per_region.n_done.shape),
            "seconds": seconds}


# --------------------------------------------------------------------------
# the serving path: zamba2-7b, mamba2-2.7b, qwen2-1.5b and paligemma-3b
# --------------------------------------------------------------------------

SERVE_BATCH = 2
SERVE_DIR = os.path.join(ROOT, "results", "serve_smoke")
PREFILL_LEN = 4096           # the train_4k length
CONTRACT_LEN = 512           # two SSD chunks
GREEDY_TOKENS = 32
# The decode-vs-prefill contract runs at full width in f32 with the depth
# cut to 13 layers (two groups of six mamba layers, two shared-attention
# sites, one trailing layer: every module and both KV caches' reuse of the
# shared weights).  The contract holds only up to f32 rounding, which
# random weights amplify: at all 81 layers (CONTRACT_LAYERS = 81) the last
# logits moved by their own size, so there it cannot tell a fault from
# rounding.  At 13 layers the limit is relative to the logits' largest
# magnitude.  tests/test_torch_decode_contract.py measures the reference's
# own decode-vs-prefill error and one-ulp sensitivity beside the port's, on
# one set of weights (on the CPU; at full width when run as a script): the
# reference's own rounding reaches a few 1e-3 of the logits' scale, below
# this limit.
# qwen2-1.5b's contract runs on its first DENSE_CONTRACT_LAYERS layers:
# at full width its random weights amplify f32 rounding by a factor that
# varies with the weights (decode against prefill 6.6e-7, 2.8e-5, 9.0e-4
# and 0.10 of the logits' scale at 1, 2, 4 and 8 layers, 64 tokens, on the
# CPU; on the card at 512 tokens 8.7e-7 and 5.0e-4 at 1 and 3 layers of
# one set of weights, where the CPU gives 2.7e-7 and 1.2e-4, and 2.8e-2 at
# 3 layers of the smoke's weights; at width 256 all 28 layers stay at
# 2e-7).  paligemma's
# gemma-style weights amplify too, in the reference as well (2e-3 of the
# scale at 6 layers, 0.3 at 12, width 256), so its phase serves the
# prefill without a contract.
CONTRACT_LAYERS = 13
DENSE_CONTRACT_LAYERS = 2
CONTRACT_RTOL = 5e-3
DENSE_ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "gemma2-2b", "gemma3-4b",
               "paligemma-3b")
# phase 7d: the MoE decoders at their published widths, the depth cut to
# what one 80 GB card holds beside the phase's working memory (a peak of
# max_memory_allocated at or under 72 GB): qwen3-moe 10 of 94 layers (4.98
# GB of bf16 a layer, 2.49 GB of embedding and head: 52.3 GB of weights),
# deepseek-v2 its dense first layer and 6 of its 59 MoE layers (7.94 GB an
# MoE layer, 0.68 GB the dense one, 2.10 GB of embeddings: 50.4 GB).  The
# whole models (94 and 60 layers, ~470 GB of bf16) need a mesh.
MOE_LAYERS = {"qwen3-moe-235b-a22b": 10, "deepseek-v2-236b": 7}
# the f32 contract's layers: qwen3-moe's first two MoE layers; deepseek's
# dense layer and first MoE layer (MLA's absorbed decode against its
# expanded prefill at kv_lora 512 and 128 heads).  Random weights amplify
# rounding layer by layer at full width (DENSE_CONTRACT_LAYERS).
MOE_CONTRACT_LAYERS = 2
MOE_ARCHS = tuple(MOE_LAYERS)
# phase 7e: whisper-base at batch 8 x (1500 frame embeddings, 448 decoder
# tokens), Whisper's decoder context (arXiv:2212.04356)
WHISPER_BATCH = 8
WHISPER_DEC_LEN = 448
# whisper's f32 contract runs on its first WHISPER_CONTRACT_LAYERS decoder
# layers (after the whole encoder): `Model.init`'s fan-in rule gives the
# [d, 8, 64] projections std 1/sqrt(8), the softmax saturates, and rounding
# grows layer by layer.  On one set of full-width weights, 48 tokens, on
# the CPU: the port's decode against prefill 2.0e-5, 5.1e-5, 7.3e-4 and
# 0.135 of the logits' scale at 1, 2, 3 and 6 layers, the reference's own
# 1.2e-3 and 5.0e-2 at 3 and 6; on the card at 448 tokens all 6 layers
# were 0.77 apart with one argmax differing.
WHISPER_CONTRACT_LAYERS = 2


def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill: one SSD per mamba layer and one
    flash per shared-attention site (hybrid); one flash per global layer
    of a model without attention softcap (dense, vlm: the dispatch of
    `layers.attention`); one flash a layer (moe, deepseek's dense first
    layers and MLA included); one a self-attention and one a
    cross-attention (encdec: encoder, decoder, cross)."""
    if cfg.family == "moe":
        return {"flash_attention": cfg.n_layers}
    if cfg.family == "encdec":
        return {"flash_attention": cfg.n_enc_layers + 2 * cfg.n_layers}
    if cfg.family in ("dense", "vlm"):
        n = 0 if cfg.attn_softcap else sum(
            layer_window(cfg, i) == 0 for i in range(cfg.n_layers))
        return {"flash_attention": n} if n else {}
    want = {"ssd_intra_chunk": cfg.n_layers}
    if cfg.family == "hybrid":
        want["flash_attention"] = cfg.n_layers // cfg.attn_every
    return want


def check_launches(counts: dict, cfg, dev, what: str) -> None:
    """On the card a prefill launches exactly `expected_launches`; on the
    CPU (plain versions) nothing."""
    want = expected_launches(cfg) if dev.type == "cuda" else {}
    check(counts == want, f"{what}: launches {counts} != {want}")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _tokens(gen, cfg, b, s, dev):
    return torch.randint(0, cfg.vocab, (b, s), generator=gen, device=dev)


def _batch(gen, cfg, b, s, dev) -> dict:
    """A prefill batch of `s` positions: tokens, and for the VLM its
    `n_frontend_tokens` patch embeddings first (standard normal, as the
    reference's `make_batch` draws them) and s - n_frontend_tokens
    tokens; for the encoder-decoder `enc_seq` frame embeddings (standard
    normal) and `s` decoder tokens."""
    if cfg.family == "encdec":
        return {"frames": torch.randn((b, cfg.enc_seq, cfg.d_model),
                                      generator=gen, device=dev),
                "tokens": _tokens(gen, cfg, b, s, dev)}
    if cfg.family != "vlm":
        return {"tokens": _tokens(gen, cfg, b, s, dev)}
    p = cfg.n_frontend_tokens
    return {"patch_embeds": torch.randn((b, p, cfg.frontend_dim),
                                        generator=gen, device=dev),
            "tokens": _tokens(gen, cfg, b, s - p, dev)}


def timed_prefill(model, params, batch: dict, dev) -> tuple:
    """(logits, wall s, launch counts) of one prefill, counts reset just
    before and read just after."""
    _sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits = model.prefill(params, batch)
    _sync(dev)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    return logits, wall, counts


def decode_cache(model, params, batch: dict, b: int, s: int, dev) -> dict:
    """An empty decode cache of `s` positions; for the encoder-decoder the
    cross-attention K / V projected from the encoder output of the batch's
    frames, which `whisper_decode_step` reads and its caller fills (as the
    reference's tests fill it)."""
    cache = model.init_cache(b, s, device=dev)
    cfg = model.cfg
    if cfg.family == "encdec":
        cdt = dtype_of(cfg.compute_dtype)
        with torch.no_grad():
            enc = whisper.encode(cfg, params, batch["frames"])
            for i in range(cfg.n_layers):
                lp = layer(params["dec_layers"], i)["cross_attn"]
                cache["cross_k"][i] = whisper._project(lp, enc, cdt, "k")
                cache["cross_v"][i] = whisper._project(lp, enc, cdt, "v")
    return cache


def decode_contract(model, params, batch: dict, dev) -> dict:
    """The serving contract: the prefill's last logits (kernels) against
    those after one decode step per token from an empty cache (plain
    recurrences; the encoder-decoder's cross-attention cache from its
    encoder output)."""
    full, _, counts = timed_prefill(model, params, batch, dev)
    check_launches(counts, model.cfg, dev, "contract prefill")
    tokens = batch["tokens"]
    b, s = tokens.shape
    cache = decode_cache(model, params, batch, b, s, dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(s):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
    _sync(dev)
    wall = time.perf_counter() - t0
    check(not any(ops.launch_counts().values()), "decode launched a kernel")
    # the vocab's own columns (a padded vocab's pad columns are -1e30 on
    # both sides and would set the scale)
    v = model.cfg.vocab
    full, logits = full[..., :v], logits[..., :v]
    err = float((logits - full).abs().max())
    tol = CONTRACT_RTOL * float(full.abs().max())
    # argmax must agree wherever the prefill's top two are further apart
    # than the error allowed
    top2 = full[:, -1].topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * tol
    agree = full[:, -1].argmax(-1) == logits[:, -1].argmax(-1)
    return {"positions": s, "max_abs_err": err, "tol": tol,
            "max_abs_logit": float(full.abs().max()),
            "argmax_agree": agree.tolist(), "top2_gap_decided":
            decided.tolist(), "ok": err <= tol
            and bool((agree | ~decided).all()),
            "decode_ms_per_token": wall / s * 1e3}


def cut_depth(cfg, params: dict, n_layers: int) -> tuple:
    """(config, params) of the first `n_layers` layers of the same weights
    (views); for the hybrid, of its mamba layers: the leading groups, their
    adapters and sites, and the leading trailing layers; for an MoE model
    its dense first layers, then MoE layers; for the encoder-decoder its
    first decoder layers after the whole encoder."""
    cut = cfg.replace(n_layers=n_layers)
    if cfg.family == "moe":
        nd = min(cfg.moe.first_dense, n_layers)
        cut = cut.replace(moe=dataclasses.replace(cfg.moe, first_dense=nd))
        out = dict(params, layers=tree_map(lambda t: t[:n_layers - nd],
                                           params["layers"]))
        if nd:
            out["dense_layers"] = tree_map(lambda t: t[:nd],
                                           params["dense_layers"])
        return cut, out
    if cfg.family == "encdec":
        return cut, dict(params, dec_layers=tree_map(lambda t: t[:n_layers],
                                                      params["dec_layers"]))
    if cfg.family in ("dense", "vlm"):
        return cut, dict(params, layers=tree_map(lambda t: t[:n_layers],
                                                  params["layers"]))
    if cfg.family == "ssm":
        return cut, dict(params, layers=tree_map(lambda t: t[:n_layers],
                                                  params["layers"]))
    n_groups = n_layers // cfg.attn_every
    trailing = n_layers - n_groups * cfg.attn_every
    out = dict(params, groups=tree_map(lambda t: t[:n_groups],
                                       params["groups"]),
               adapters=tree_map(lambda t: t[:n_groups], params["adapters"]))
    out.pop("trailing", None)
    if trailing:
        out["trailing"] = tree_map(lambda t: t[:trailing], params["trailing"])
    return cut, out


def greedy_decode(model, params, batch: dict, n: int, cache_len: int,
                  dev) -> dict:
    """n greedy tokens from the batch's last token on a cache of
    `cache_len` positions (`decode_cache`); the tokens stay on the device
    (argmax feeds the next step)."""
    first = batch["tokens"][:, -1:]
    cache = decode_cache(model, params, batch, first.shape[0], cache_len,
                         dev)
    tok, out = first, []
    _sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for t in range(n):
        logits, cache = model.decode_step(params, cache, tok, t)
        tok = logits[:, -1].argmax(-1, keepdim=True)
        out.append(tok)
    _sync(dev)
    wall = time.perf_counter() - t0
    check(not any(ops.launch_counts().values()), "decode launched a kernel")
    toks = torch.cat(out, dim=1)
    check(toks.shape == (first.shape[0], n) and
          bool(((toks >= 0) & (toks < model.cfg.vocab)).all()),
          "greedy tokens out of range")
    return {"tokens": n, "cache_len": cache_len, "wall_s": wall,
            "ms_per_token": wall / n * 1e3}


def contract_config(cfg):
    """The f32 contract's config: f32 compute; for an MoE model the capacity
    factor raised to ceil(n_experts / top_k) (16 for qwen3-moe, 27 for
    deepseek-v2), so that every group's capacity is at least its size (c
    >= group at prefill, c >= batch at decode) and neither path drops a
    token.  At the configured 1.25 the reference itself drops tokens at
    prefill (groups of 512: capacity 40 against a mean load of 32) and at
    batch-2 decode whenever both rows pick one expert (capacity 1), so the
    two paths would see other experts; the reference's own contract raises
    the factor for this reason (tests/test_decode_consistency.py)."""
    cfg = cfg.replace(compute_dtype="float32")
    if cfg.family == "moe":
        m = cfg.moe
        cfg = cfg.replace(moe=dataclasses.replace(
            m, capacity_factor=float(math.ceil(m.n_experts / m.top_k))))
    return cfg


def serve(dev, cfg, prefill_len: int, contract_len: int, greedy: int,
          profile: bool = False,
          contract_layers: int = CONTRACT_LAYERS,
          batch_size: int = SERVE_BATCH,
          sort_repeat: bool = False) -> tuple[dict, dict]:
    """One model as configured: params from a seeded generator on `dev`;
    the decode-vs-prefill contract in f32 (`contract_config`;
    `contract_len` tokens, text only, on the first `contract_layers`
    layers, skipped at 0 tokens); a warm-up and two timed prefills of
    `batch_size` x `prefill_len` positions (a VLM's patch prefix among
    them; an encoder-decoder's frames beside them) at the config's types
    with exact launch counts; with `sort_repeat` (MoE) the same prefill
    twice through the sort dispatch, bit for bit; `greedy` greedy decode
    tokens.  Returns (info, launches of the last timed prefill)."""
    model = get_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model.init(gen, device=dev)
    _sync(dev)
    info = {"model": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype,
            "n_params": sum(t.numel() for t in flatten(params).values()),
            "init_s": time.perf_counter() - t0}
    if cfg.family == "moe":
        info["n_layers_configured"] = get_config(cfg.name).n_layers
    if contract_len:
        t0 = time.perf_counter()
        cfg32 = contract_config(cfg)
        cbatch = (_batch(gen, cfg, batch_size, contract_len, dev)
                  if cfg.family == "encdec" else
                  {"tokens": _tokens(gen, cfg, batch_size, contract_len,
                                     dev)})
        ccfg, cut_params = cut_depth(cfg32, params, min(contract_layers,
                                                        cfg.n_layers))
        info["contract_f32"] = dict(
            n_layers=ccfg.n_layers, capacity_factor=ccfg.moe.capacity_factor
            if cfg.family == "moe" else None,
            **decode_contract(get_model(ccfg), cut_params, cbatch, dev),
            wall_s=time.perf_counter() - t0)
        check(info["contract_f32"]["ok"],
              f"decode vs prefill: {info}")
        del cbatch, cut_params
    cparams = model.compute_params(params)
    batch = _batch(gen, cfg, batch_size, prefill_len, dev)
    timed_prefill(model, cparams, batch, dev)              # warm-up
    walls = []
    for _ in range(2):
        logits, wall, counts = timed_prefill(model, cparams, batch, dev)
        walls.append(wall)
        check_launches(counts, cfg, dev, f"{cfg.name} prefill")
    check(tuple(logits.shape) == (batch_size, 1, cfg.padded_vocab)
          and bool(torch.isfinite(logits[..., :cfg.vocab]).all()),
          f"{cfg.name} prefill logits")
    n_tok = batch_size * prefill_len
    info.update(prefill={"batch": batch_size, "seq": prefill_len,
                         "patch_positions": cfg.n_frontend_tokens
                         if cfg.family == "vlm" else 0,
                         "frames": cfg.enc_seq
                         if cfg.family == "encdec" else 0,
                         "wall_s": walls,
                         "tokens_per_s": [n_tok / w for w in walls],
                         "launches": counts})
    if sort_repeat:
        scfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="sort"))
        smodel = get_model(scfg)
        runs = [timed_prefill(smodel, cparams, batch, dev) for _ in range(3)]
        for _, _, c in runs:
            check_launches(c, scfg, dev, f"{cfg.name} sort prefill")
        check(torch.equal(runs[1][0], runs[2][0]),
              f"{cfg.name}: the sort dispatch did not repeat bit for bit")
        info["sort_dispatch"] = {
            "bit_equal": True, "wall_s": [r[1] for r in runs[1:]],
            "max_abs_diff_vs_einsum": float((runs[2][0] - logits).abs()
                                            .max())}
        del runs
    if profile:
        if cfg.family == "moe":
            info["prefill_profile"] = profiled_moe(
                lambda: model.prefill(cparams, batch), dev)
        else:
            info["prefill_profile"] = profiled(
                lambda: model.prefill(cparams, batch), top_n=10,
                watch=("ssd_intra_kernel", "flash"),
                classes=(("flash", ("flash",)),
                         ("gemm", ("gemm", "cutlass", "xmma", "nvjet")),
                         ("ssd", ("ssd_intra_kernel",))))
    if greedy:
        info["greedy_decode"] = greedy_decode(
            model, cparams, batch, greedy, prefill_len + greedy, dev)
    if dev.type == "cuda":
        info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return info, counts


def profiled_moe(fn, dev) -> dict:
    """One MoE prefill under the profiler in a telemetry session (so
    `moe.moe_ffn` is the profiler range `moe`): device ms by class, flash
    (by kernel name), GEMMs outside and inside the `moe` range (the
    latter the expert products and the dispatch / combine einsums),
    the `moe` range's other kernels (routing, one-hots, capacity
    arithmetic, casts: the glue), and the rest; wall, busy and idle share,
    the top kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _sync(dev)
    with telemetry.session(out_dir=os.path.join(SERVE_DIR, "telemetry")):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            _sync(dev)
            wall = time.perf_counter() - t0

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent
    split = dict.fromkeys(("flash", "gemm", "moe_gemm", "moe_glue", "rest"),
                          0.0)
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        in_moe = any(a.name == "moe" for a in chain(e))
        for k in e.kernels:
            if any(p in k.name.lower() for p in GEMM_PARTS):
                cls = "moe_gemm" if in_moe else "gemm"
            else:
                cls = "moe_glue" if in_moe else "rest"
            split[cls] += k.duration
    events = [(e.key, e.self_device_time_total, e.count)
              for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA
              and e.key not in ("moe", "attention")]
    busy_us = sum(t for _, t, _ in events)
    # the flash kernel launches through ctypes, under no aten op: its time
    # is taken by name
    split["flash"] = sum(t for k, t, _ in events if "flash" in k)
    split["rest"] += busy_us - sum(split.values())
    top = sorted(events, key=lambda e: -e[1])
    return {"wall_s": wall, "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "device_ms_by_class": {k: v / 1e3 for k, v in split.items()},
            "top_kernels": [{"name": k[:80], "device_ms": t / 1e3,
                             "count": n} for k, t, n in top[:10]]}


def small_models_card_vs_cpu(dev, archs=("zamba2-7b", "mamba2-2.7b")
                             ) -> dict:
    """Reduced models (f32) with the same weights on the card (the kernels)
    and on the CPU (their plain versions): prefill logits of 2 x 64
    positions (paligemma's 8 patch embeddings among them; whisper's 16
    frames beside them) and 16 decode steps (whisper's cross-attention
    cache from its encoder output), within 1e-4; prefill launch counts
    exact on the card.  An MoE config runs through both dispatch modes
    (keys "<arch>" and "<arch> sort")."""
    out = {}
    variants = [(a, "einsum") for a in archs] + [
        (a, "sort") for a in archs if reduced(a).family == "moe"]
    for arch, dispatch in variants:
        cfg = reduced(arch)
        if dispatch == "sort":
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                                      dispatch="sort"))
        model = get_model(cfg)
        p_cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
        batch = _batch(torch.Generator().manual_seed(1), cfg, 2, 64,
                       torch.device("cpu"))
        res, card_counts = [], None
        for d in (dev, torch.device("cpu")):
            params = tree_map(lambda t: t.to(d), p_cpu)  # noqa: B023
            bd = {k: v.to(d) for k, v in batch.items()}
            full, _, counts = timed_prefill(model, params, bd, d)
            check_launches(counts, cfg, d, f"small {arch}")
            card_counts = card_counts if card_counts is not None else counts
            cache = decode_cache(model, params, bd, 2, 64, d)
            steps = []
            tk = bd["tokens"]
            for t in range(16):
                lg, cache = model.decode_step(params, cache, tk[:, t:t + 1],
                                              t)
                steps.append(lg)
            res.append((full.cpu(), torch.cat(steps, 1).cpu()))
        errs = [_close(g, w, 1e-4, 1e-4, f"small {arch} card vs cpu")
                for g, w in zip(*res)]
        key = arch + (" sort" if dispatch == "sort" else "")
        out[key] = {"prefill_max_abs_err": errs[0],
                    "decode_max_abs_err": errs[1], "launches": card_counts}
    return out


def time_model_kernels(dev, results: dict) -> None:
    """Kernels 5 and 6 and their plain versions at zamba2-7b's prefill
    shapes (B = 2, S = 4096): SSD with Q 256, H 112, P 64, G 2, N 64 in
    f32; flash causal with H = KV = 32, D = 112 in bf16, and at the dense
    decoders' prefill shapes (qwen2-1.5b: H 12, KV 2, D 128; paligemma-3b:
    H 8, KV 1, D 256), each beside one call of PyTorch's
    scaled_dot_product_attention on the same inputs (a yardstick; the port
    never calls it).  Bounds count what the causal triangle needs.
    SSD: per (row, column) pair and head 2P + 3 f32 operations (the decay's
    difference and exp, its product with the score, the output's 2P), and
    per pair and group 2N for the score C_q . B_k, which every head of the
    group shares.  Flash: per pair and head 4D bf16 operations.  Bytes are
    every input read once and the output written once."""
    gen = torch.Generator(device=dev).manual_seed(7)
    cfg = get_config("zamba2-7b")
    s_cfg = cfg.ssm
    b, s = SERVE_BATCH, PREFILL_LEN
    q_len = s_cfg.chunk
    h = s_cfg.expand * cfg.d_model // s_cfg.head_dim
    shape = (b, s // q_len, q_len, h, s_cfg.head_dim, s_cfg.n_groups,
             s_cfg.d_state)
    args = _ssd_inputs(gen, shape, dev)
    pairs = b * (s // q_len) * q_len * (q_len + 1) // 2
    nbytes = 4 * sum(t.numel() for t in args) + 4 * args[0].numel()
    products = pairs * (h * 2 * s_cfg.head_dim
                        + s_cfg.n_groups * 2 * s_cfg.d_state)
    b_ms, b_by = bound(nbytes, products + pairs * h * 3)
    tc_ms, tc_by = bound(nbytes, 3 * products, PEAK_TF32_OPS_S)
    results["ssd_intra_chunk"].update(
        bound_tf32_ms=tc_ms, bound_tf32_by=tc_by,
        slab=ssd_k.slab_heads(shape[0] * shape[1], shape[5],
                              shape[3] // shape[5]),
        ms=time_ms(lambda: ssd_k.ssd_intra_chunk(*args)),
        plain_ms=time_ms(lambda: ref.ssd_intra_chunk(*args)),
        device_ms=device_ms(lambda: ssd_k.ssd_intra_chunk(*args),
                            "ssd_intra_kernel", reps=20),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        shape={"xdt": list(args[0].shape), "b": list(args[2].shape)})
    del args

    nh, hd = cfg.n_heads, cfg.hd
    q, k, v = (torch.randn((b, s, nh, hd), generator=gen, device=dev).to(
        torch.bfloat16) for _ in range(3))
    scale = 1.0 / math.sqrt(hd)
    pairs = b * nh * s * (s + 1) // 2
    b_ms, b_by = bound(4 * q.numel() * 2, pairs * 4 * hd, PEAK_BF16_OPS_S)
    hl_ms, hl_by = bound(4 * q.numel() * 2, pairs * 6 * hd, PEAK_BF16_OPS_S)
    results["flash_attention"].update(bound_hilo_ms=hl_ms,
                                      bound_hilo_by=hl_by)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    results["flash_attention"].update(
        ms=time_ms(lambda: fa_k.flash_attention(q, k, v, scale=scale)),
        plain_ms=time_ms(lambda: ref.flash_attention(q, k, v, scale=scale)),
        device_ms=device_ms(lambda: fa_k.flash_attention(q, k, v,
                                                         scale=scale),
                            "flash_tc_kernel", reps=10),
        library_ms=time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                        scale=scale, enable_gqa=True)),
        bound_ms=b_ms, bound_by=b_by,
        shape={"q": list(q.shape), "dtype": "bfloat16"})
    del q, k, v, qt, kt, vt
    # the dense decoders' prefill shapes (GQA, MQA), the same yardstick
    dense = {}
    for arch in ("qwen2-1.5b", "paligemma-3b"):
        c = get_config(arch)
        q = torch.randn((b, s, c.n_heads, c.hd), generator=gen,
                        device=dev).to(torch.bfloat16)
        k, v = (torch.randn((b, s, c.n_kv_heads, c.hd), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        scale = 1.0 / math.sqrt(c.hd)
        pairs = b * c.n_heads * s * (s + 1) // 2
        b_ms, b_by = bound(2 * (2 * q.numel() + 2 * k.numel()),
                           pairs * 4 * c.hd, PEAK_BF16_OPS_S)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        dense[arch] = {
            "shape": {"q": list(q.shape), "kv": list(k.shape),
                      "dtype": "bfloat16"},
            "ms": time_ms(lambda: fa_k.flash_attention(q, k, v,
                                                       scale=scale)),
            "plain_ms": time_ms(lambda: ref.flash_attention(q, k, v,
                                                            scale=scale)),
            "device_ms": device_ms(lambda: fa_k.flash_attention(
                q, k, v, scale=scale), "flash_tc_kernel", reps=10),
            "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                               scale=scale,
                                               enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        del q, k, v, qt, kt, vt
    results["flash_attention"]["dense_shapes"] = dense
    torch.cuda.synchronize()


def time_new_flash_shapes(dev, results: dict) -> None:
    """Kernel 6 at the MoE and encoder-decoder shapes (FLASH_NEW_SHAPES):
    ms, plain ms (the plain version 32 query heads at a time,
    `_flash_plain`), device ms, one call of scaled_dot_product_attention on
    the function's own inputs (MLA: v of 128, not padded), and the bound
    of the function: bytes of q, k, v and the output once, operations 2 d_qk
    + 2 d_v a (row, column) pair and head that the mask keeps.  MLA's
    kernel runs on v padded to 192, 1.2x the function's operations."""
    gen = torch.Generator(device=dev).manual_seed(8)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for name, (b, sq, sk, h, kv, d, causal, dt, _, _) in \
            FLASH_NEW_SHAPES.items():
        q = torch.randn((b, sq, h, d), generator=gen, device=dev).to(dt)
        k = torch.randn((b, sk, kv, d), generator=gen, device=dev).to(dt)
        dv = MLA_V if d == MLA_QK else d
        v = torch.randn((b, sk, kv, dv), generator=gen, device=dev).to(dt)
        vp = torch.nn.functional.pad(v, (0, d - dv))
        scale = 1.0 / math.sqrt(d)
        pairs = b * (sq * (sq + 1) // 2 if causal else sq * sk)
        nbytes = 2 * (q.numel() + k.numel() + v.numel() + b * sq * h * dv)
        b_ms, b_by = bound(nbytes, pairs * h * (2 * d + 2 * dv),
                           PEAK_BF16_OPS_S)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        out[name] = {
            "shape": {"q": list(q.shape), "kv": list(k.shape), "v_width": dv,
                      "causal": causal, "dtype": "bfloat16"},
            "ms": time_ms(lambda: fa_k.flash_attention(  # noqa: B023
                q, k, vp, scale=scale, causal=causal)),  # noqa: B023
            "plain_ms": time_ms(lambda: _flash_plain(  # noqa: B023
                q, k, vp, scale, causal)),  # noqa: B023
            "device_ms": device_ms(lambda: fa_k.flash_attention(  # noqa: B023
                q, k, vp, scale=scale, causal=causal),  # noqa: B023
                "flash_tc_kernel", reps=10),
            "library_ms": time_ms(lambda: sdpa(  # noqa: B023
                qt, kt, vt, is_causal=causal, scale=scale,  # noqa: B023
                enable_gqa=True)),
            "bound_ms": b_ms, "bound_by": b_by}
        del q, k, v, vp, qt, kt, vt
        torch.cuda.empty_cache()
    results["flash_attention"]["moe_encdec_shapes"] = out
    torch.cuda.synchronize()


# --------------------------------------------------------------------------
# phases 7d / 7e: the MoE decoders and the encoder-decoder
# --------------------------------------------------------------------------

def _peak(dev) -> int | None:
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def _reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def moe_phase(dev, layers: dict, prefill_len: int, contract_len: int,
              greedy: int, reduced_archs: bool = False):
    """Phase 7d's (line, prefill launches) pairs, each yielded when its part
    ends: each MoE config at `layers[arch]` layers through `serve` (the
    contract at `contract_config`'s capacity, prefills with one flash
    launch a layer, the sort dispatch twice bit for bit, the profile split
    by the `moe` range, greedy decode), then both reduced configs card
    against CPU through both dispatch modes.  `reduced_archs`: serve the
    reduced configs instead (the CPU rehearsal)."""
    for arch, n in layers.items():
        t0 = time.perf_counter()
        cfg = (reduced(arch) if reduced_archs else get_config(arch)
               ).replace(n_layers=n)
        info, counts = serve(dev, cfg, prefill_len, contract_len, greedy,
                             profile=dev.type == "cuda",
                             contract_layers=MOE_CONTRACT_LAYERS,
                             sort_repeat=True)
        yield ({"phase": "serve_moe", **info,
                "part_s": time.perf_counter() - t0}, counts)
    t0 = time.perf_counter()
    _reset_peak(dev)
    yield ({"phase": "small_moe_card_vs_cpu",
            **small_models_card_vs_cpu(dev, MOE_ARCHS),
            "max_memory_allocated": _peak(dev),
            "part_s": time.perf_counter() - t0}, {})


def whisper_phase(dev, cfg, batch: int, dec_len: int, greedy: int):
    """Phase 7e's (line, prefill launches) pairs: `cfg` through `serve` (the
    f32 contract on its first WHISPER_CONTRACT_LAYERS decoder layers over
    `dec_len` tokens with the cross-attention cache from the encoder
    output, prefills of `batch` x
    (enc_seq frames, `dec_len` tokens) with one flash launch an attention,
    a profile, greedy decode), then the reduced config card against
    CPU."""
    t0 = time.perf_counter()
    info, counts = serve(dev, cfg, dec_len, dec_len, greedy,
                         profile=dev.type == "cuda",
                         contract_layers=WHISPER_CONTRACT_LAYERS,
                         batch_size=batch)
    yield ({"phase": "serve_whisper", **info,
            "part_s": time.perf_counter() - t0}, counts)
    t0 = time.perf_counter()
    _reset_peak(dev)
    yield ({"phase": "small_whisper_card_vs_cpu",
            **small_models_card_vs_cpu(dev, ("whisper-base",)),
            "max_memory_allocated": _peak(dev),
            "part_s": time.perf_counter() - t0}, {})


# --------------------------------------------------------------------------
# phase 7c: training and carbon-aware training
# --------------------------------------------------------------------------

TRAIN_BATCH = 2
TRAIN_SEQ = 4096             # train_4k's length (its global batch of 256
                             # needs a mesh)
TRAIN_TIMED_STEPS = 4
# the profiled steps: the profiler's host-side processing of a step's
# events (CPU ops, autograd nodes, kernels) took ~20-26 s a step on the
# card's host (79 s for 4, 51.5 s for 2), and 32 steps' did not finish
# within the smoke's time; one step keeps the smoke under ~900 s with
# phases 7d / 7e
TRAIN_PROFILE_STEPS = 1
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=10)
# (b): the gradient card against CPU at full width on the first layers in
# f32 (random weights amplify rounding layer by layer, as in phase 7b)
TRAIN_GRAD_LAYERS = 2
TRAIN_GRAD_SEQ = 256
TRAIN_ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "gemma2-2b", "gemma3-4b",
               "paligemma-3b", "mamba2-2.7b", "zamba2-7b",
               "qwen3-moe-235b-a22b", "deepseek-v2-236b", "whisper-base")
# the gradient norm's tolerance: gemma2's reduced f32 gradient resolves to
# ~5e-4 of its scale in both packages (tests/test_torch_train_models.py)
TRAIN_NORM_RTOL = {"gemma2-2b": 1e-3}
TRAIN_SMALL_LR = 1e-3
TRAIN_DIR = os.path.join(ROOT, "results", "train_smoke")
GEMM_PARTS = ("gemm", "cutlass", "xmma", "nvjet")
# the carbon-aware setups (scripts/reference_experiments.py TRAIN_SETUPS)
# and the reference's reports on the CPU (its --train lines)
CA_SETUPS = {
    "square_wave": dict(model="reduced", batch=2, seq=32, lr=1e-3, warmup=1,
                        total=50, steps=16, trace="square", k=3,
                        ca=dict(ckpt_every=5, step_time_s=3600.0,
                                shifting=True, failure_prob_per_step=0.0,
                                seed=0)),
    "failures": dict(model="reduced", batch=2, seq=32, lr=1e-3, warmup=1,
                     total=50, steps=10, trace="flat", k=3,
                     ca=dict(ckpt_every=3, step_time_s=2.0, shifting=False,
                             failure_prob_per_step=0.3, seed=5)),
    "example": dict(model="widened", batch=8, seq=128, lr=3e-4, warmup=20,
                    total=200, steps=200, trace="region4", k=10,
                    ca=dict(ckpt_every=50, step_time_s=120.0, power_kw=80.0,
                            idle_power_kw=2.0, shifting=True,
                            failure_prob_per_step=0.01, seed=0)),
}
CA_COUNTS = ("steps_done", "n_pauses", "n_failures", "n_restores",
             "paused_hours", "busy_hours", "sim_hours")
CA_CARBON = ("op_carbon_kg", "baseline_carbon_kg")
CA_REF = {
    "square_wave": dict(steps_done=16, n_pauses=1, n_failures=0,
                        n_restores=0, paused_hours=12.0, busy_hours=16.0,
                        sim_hours=28.0, op_carbon_kg=214.0,
                        baseline_carbon_kg=480.0),
    "failures": dict(steps_done=10, n_pauses=0, n_failures=5, n_restores=5,
                     paused_hours=0.0, busy_hours=0.007777777777777778,
                     sim_hours=0.007777777777777778,
                     op_carbon_kg=0.07777777777777777,
                     baseline_carbon_kg=0.07777777777777777),
    "example": dict(steps_done=200, n_pauses=2, n_failures=4, n_restores=4,
                    paused_hours=27.0, busy_hours=10.533333333333307,
                    sim_hours=37.53333333333316,
                    op_carbon_kg=26.90641165161131,
                    baseline_carbon_kg=38.44442897033694),
}
TRAIN_CLI = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "20",
             "--carbon-aware", "--failures", "0.02"]
CLI_REF = {"steps": 20, "sim_hours": 16.02, "paused_hours": 16.0,
           "pauses": 1, "failures": 2, "restores": 2, "op_carbon_kg": 12.925,
           "baseline_carbon_kg": 0.224, "carbon_reduction_pct": -5665.86}


def train_flops(cfg, n_params: int, b: int, s: int) -> float:
    """Model FLOPs of one train step: 6 per parameter a token (forward and
    backward of every matrix, the tied unembedding included) and 6 B S^2 H
    hd a layer for causal attention's two products."""
    return (6.0 * n_params * b * s
            + 6.0 * cfg.n_layers * b * s * s * cfg.n_heads * cfg.hd)


def profile_split(prof, n_steps: int) -> dict:
    """Device ms a step by class, from a profile taken in a telemetry
    session (so `layers.attention` and the optimizer are profiler ranges):
    `gemm`, the matrix-product kernels by name; `attention_glue`, the other
    kernels launched inside an `attention` range (its forward and
    checkpoint recompute) or by the backward of an op launched there (the
    autograd node's sequence number); `optimizer`, inside the `optimizer`
    range; `rest`, the remaining busy time."""
    from torch.autograd import DeviceType
    evs = prof.events()

    def chain(e):
        while e is not None:
            yield e
            e = e.cpu_parent
    att_seq = {e.sequence_nr for e in evs if e.sequence_nr >= 0
               and any(a.name == "attention" for a in chain(e))}
    split = dict.fromkeys(("gemm", "attention_glue", "optimizer", "rest"),
                          0.0)
    for e in evs:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        up = list(chain(e))
        if any(a.name == "optimizer" for a in up):
            cls = "optimizer"
        elif any(a.name == "attention" or (
                a.name.startswith("autograd::engine::evaluate_function")
                and a.sequence_nr in att_seq) for a in up):
            cls = "attention_glue"
        else:
            cls = "rest"
        for k in e.kernels:
            split["gemm" if any(p in k.name.lower() for p in GEMM_PARTS)
                  else cls] += k.duration
    # device events less the ranges' own spans on the device timeline
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.key not in ("attention", "optimizer"))
    split["rest"] += busy - sum(split.values())
    return {"device_busy_ms_per_step": busy / 1e3 / n_steps,
            "device_ms_per_step": {k: v / 1e3 / n_steps
                                   for k, v in split.items()}}


def input_fan_in(params: dict) -> dict:
    """`params` (in place) with each attention projection drawn at the
    fan-in of its input width: `Model.init`, as the reference's init,
    takes the last-but-one axis as fan-in, which for the [d, H, hd] query /
    key / value tensors is H and for the [H, hd, d] output is hd (std
    1/sqrt(12) and 1/sqrt(128) where 1/sqrt(1536) is the input's at
    qwen2-1.5b), and with those the gradient grows 2-3x a layer."""
    with torch.no_grad():
        for path, t in flatten(params).items():
            if path[-1] in ("wq", "wk", "wv"):       # [..., d, H, hd]
                t.mul_(math.sqrt(t.shape[-2] / t.shape[-3]))
            elif path[-1] == "wo":                   # [..., H, hd, d]
                t.mul_(math.sqrt(1.0 / t.shape[-3]))
    return params


def train_full(dev, cfg, seq: int, timed: int, profile_steps: int,
               opt: dict) -> dict:
    """(a) One model as configured: random weights from a seed, a batch of
    TRAIN_BATCH x `seq` tokens from the port's pipeline.  First the
    gradient of `Model.init`'s weights (recorded: at 28 layers its global
    norm overflows f32, so the clip zeroes the update); then with the
    attention projections at their input's fan-in (`input_fan_in`) a
    warm-up step and `timed` timed steps on the batch (host clock ending
    in a synchronise), no kernel launched, every loss and gradient norm
    finite, the loss after the last update below the first step's (at the
    initial weights) by 1e-3; then `profile_steps` steps under the profiler
    (`profile_split`)."""
    from torch.profiler import ProfilerActivity, profile
    model = get_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(**opt))
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_train_state(model, torch.Generator(device=dev).manual_seed(0),
                             tcfg, device=dev)
    _sync(dev)
    n_params = sum(t.numel() for t in flatten(state.params).values())
    info = {"model": cfg.name, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "remat": cfg.remat,
            "remat_policy": cfg.remat_policy, "n_params": n_params,
            "batch": TRAIN_BATCH, "seq": seq, "opt": opt,
            "init_s": time.perf_counter() - t0}
    batch = to_device(TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=TRAIN_BATCH)).batch_at(0),
        dev)
    loss, grads = value_and_grad(model, state.params, batch)
    flat = flatten(grads)
    info["model_init_weights"] = {
        "loss": float(loss), "grad_norm": float(global_norm(grads)),
        "max_abs_grad": {"/".join(k): float(flat[k].abs().max())
                         for k in (("embed", "tok"), ("ln_f", "w"))}}
    del loss, grads, flat
    input_fan_in(state.params)
    step = make_train_step(model, tcfg)
    losses, norms, walls = [], [], []
    ops.reset_launch_counts()
    for i in range(1 + timed):
        _sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        _sync(dev)
        if i:
            walls.append(time.perf_counter() - t0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    check(counts == {}, f"train steps launched kernels: {counts}")
    check(all(math.isfinite(x) for x in losses + norms),
          f"train: non-finite loss or norm {losses} {norms}")
    # the reference's criterion (tests/test_archs_smoke.py): the loss after
    # the updates below the first step's, at the initial weights, by 1e-3
    check(losses[timed] < losses[0] - 1e-3,
          f"train: loss did not fall by 1e-3: {losses}")
    check(int(state.opt.step) == 1 + timed, "train: optimizer step count")
    step_s = sum(walls) / len(walls)
    flops = train_flops(cfg, n_params, TRAIN_BATCH, seq)
    info.update(losses=losses, grad_norms=norms, ln_vocab=math.log(cfg.vocab),
                launches=counts, step_wall_s=walls, step_ms=step_s * 1e3,
                tokens_per_s=TRAIN_BATCH * seq / step_s,
                model_flops_per_step=flops,
                mfu=flops / step_s / PEAK_BF16_OPS_S,
                opt_step=int(state.opt.step))
    if dev.type == "cuda":
        info["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    if profile_steps:
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with telemetry.session(out_dir=os.path.join(TRAIN_DIR, "telemetry")):
            with profile(activities=acts) as prof:
                _sync(dev)
                t0 = time.perf_counter()
                for _ in range(profile_steps):
                    state, m = step(state, batch)
                _sync(dev)
                wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        info["profile"] = {"steps": profile_steps,
                           "wall_ms_per_step": wall / profile_steps * 1e3,
                           **profile_split(prof, profile_steps)}
        info["profile"]["processing_s"] = time.perf_counter() - t0
        busy = info["profile"]["device_busy_ms_per_step"]
        info["profile"]["device_idle_share"] = 1.0 - busy / (
            wall / profile_steps * 1e3)
        check(math.isfinite(float(m["loss"])), "train: profiled loss")
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return info


def _leaf_close(got, want, rtol: float, what: str) -> float:
    """Max abs error of `got` against `want`, held within rtol / atol rtol
    x the leaf's largest magnitude."""
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    scale = float(want.abs().max())
    return _close(got, want, rtol, rtol * scale, what)


def train_grads_card_vs_cpu(dev, cfg, n_layers: int, seq: int) -> dict:
    """(b) The first `n_layers` layers at full width in f32, the same
    weights and batch on the card and on the CPU: the loss, the gradient
    norm and every gradient leaf within rtol 1e-4 / atol 1e-4 x the leaf's
    largest magnitude."""
    cfg = cfg.replace(n_layers=n_layers, compute_dtype="float32")
    model = get_model(cfg)
    # the weights of (a) (Model.init's attention projections saturate the
    # softmax at full width: the f32 gradient norm then moved by 4 %
    # between the card and the CPU)
    p_cpu = input_fan_in(model.init(torch.Generator().manual_seed(3),
                                    device="cpu"))
    batch = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=seq,
                                     global_batch=TRAIN_BATCH,
                                     seed=1)).batch_at(0)
    res, walls = {}, {}
    for d in (dev, torch.device("cpu")):
        params = trainable(tree_map(lambda t: t.to(d).clone(), p_cpu))  # noqa: B023
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        loss, grads = value_and_grad(model, params, to_device(batch, d))
        _sync(d)
        walls[d.type] = time.perf_counter() - t0
        check(not any(ops.launch_counts().values()), "grads launched a kernel")
        res[d.type] = (loss, global_norm(grads), flatten(grads))
        del params
    (cl, cn, cg), (pl, pn, pg) = res[dev.type], res["cpu"]
    errs = {"loss": _close(cl.cpu(), pl, 1e-4, 1e-4 * abs(float(pl)),
                           "train grads: loss"),
            "grad_norm": _close(cn.cpu(), pn, 1e-4, 1e-4 * float(pn),
                                "train grads: norm")}
    leaf_err = max(_leaf_close(cg[k], pg[k], 1e-4, f"train grads: {k}")
                   / max(float(pg[k].abs().max()), 1e-30) for k in pg)
    return {"n_layers": n_layers, "d_model": cfg.d_model, "seq": seq,
            "loss": float(pl), "grad_norm": float(pn), "errors": errs,
            "max_leaf_err_over_scale": leaf_err, "n_leaves": len(pg),
            "wall_s": walls}


def _state_to(state, dev):
    """A copy of a TrainState on `dev`, parameters trainable."""
    copy = lambda t: t.detach().to(dev).clone()  # noqa: E731
    tree = lambda t: tree_map(copy, t)  # noqa: E731
    return TrainState(trainable(tree(state.params)), OptState(
        copy(state.opt.step), tree(state.opt.m), tree(state.opt.v)),
        None if state.ef is None else tree(state.ef))


def _train_batch(cfg, b: int, s: int, seed: int = 1) -> dict:
    """A pipeline batch of `s` positions on the CPU (a VLM: its patch
    embeddings, standard normal, then s - P tokens; the encoder-decoder:
    its frame embeddings, standard normal, beside s tokens)."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)).astype(np.float32))
        s -= cfg.n_frontend_tokens
    out.update(to_device(TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b, seed=seed)).batch_at(0),
        "cpu"))
    return out


def train_small_card_vs_cpu(dev) -> dict:
    """(c) The reduced configs, the same weights and batch: three steps on
    the CPU, and at each the card's step from a copy of the CPU's state:
    the loss within 1e-4, the gradient norm within relative 1e-4 (gemma2's
    1e-3), the learning rate equal, every new parameter within 2.5 lr, no
    kernel launched (one step at a time: Adam's sign flips of near-zero
    gradient elements make free-running trajectories drift); stablelm
    again with int8 compression; qwen2's step over 2 microbatches against
    the whole batch's (the loss within 1e-6, the gradient norm 1e-4); the
    ops guard on the card."""
    out = {}
    cases = [(a, {}) for a in TRAIN_ARCHS] + [("stablelm-1.6b",
                                               {"grad_compression": True})]
    for arch, tkw in cases:
        cfg = reduced(arch)
        model = get_model(cfg)
        tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_SMALL_LR, warmup_steps=1,
                                           total_steps=10), **tkw)
        state = new_train_state(model.init(torch.Generator().manual_seed(0),
                                           device="cpu"), tcfg)
        batch = _train_batch(cfg, 2, 64)
        bd = {k: v.to(dev) for k, v in batch.items()}
        step = make_train_step(model, tcfg)
        errs = []
        for _ in range(3):
            ops.reset_launch_counts()
            card, cm = step(_state_to(state, dev), bd)
            check(not any(ops.launch_counts().values()),
                  f"{arch}: a train step launched a kernel")
            state, pm = step(state, batch)
            what = f"train small {arch} {tkw}"
            e_loss = _close(cm["loss"].cpu(), pm["loss"], 0, 1e-4,
                            f"{what}: loss")
            rt = TRAIN_NORM_RTOL.get(arch, 1e-4)
            _close(cm["grad_norm"].cpu(), pm["grad_norm"], rt, 0,
                   f"{what}: grad norm")
            check(float(cm["lr"]) == float(pm["lr"]), f"{what}: lr")
            cp = flatten(card.params)
            e_par = max(_close(cp[k].detach().cpu(), p.detach(), 0,
                               2.5 * TRAIN_SMALL_LR, f"{what}: {k}")
                        for k, p in flatten(state.params).items())
            errs.append({"loss": e_loss, "params": e_par,
                         "loss_value": float(pm["loss"])})
        out[arch + ("+compression" if tkw else "")] = errs
    # gradient accumulation: 2 microbatches against the whole batch, one
    # step from the same state on the card
    cfg = reduced("qwen2-1.5b")
    model = get_model(cfg)
    p0 = model.init(torch.Generator().manual_seed(0), device="cpu")
    bd = {k: v.to(dev) for k, v in _train_batch(cfg, 2, 64).items()}
    mets = []
    for mb in (1, 2):
        tcfg = TrainConfig(opt=AdamWConfig(lr=TRAIN_SMALL_LR, warmup_steps=1,
                                           total_steps=10), microbatches=mb)
        st = new_train_state(tree_map(lambda t: t.to(dev).clone(), p0), tcfg)
        _, m = make_train_step(model, tcfg)(st, bd)
        mets.append(m)
    # the loss within 1e-6; the gradient norm within 1e-4 like the others
    # (cuBLAS takes other kernels for the half batch: 4.9e-5 apart)
    mb_errs = {k: _close(mets[1][k], mets[0][k], rt, 0,
                         f"microbatches 2 vs 1: {k}")
               for k, rt in (("loss", 1e-6), ("grad_norm", 1e-4))}
    out["qwen2-1.5b microbatches 2 vs 1"] = mb_errs
    # the guard: a tensor that requires grad never reaches a kernel
    q = torch.randn((1, 64, 4, 32), device=dev, requires_grad=True)
    refused = False
    try:
        ops.flash_attention(q, q.detach(), q.detach(), scale=0.25)
    except RuntimeError as e:
        refused = "use_kernels=False" in str(e)
    check(refused, "ops.flash_attention took a tensor that requires grad")
    out["guard_refuses"] = refused
    return out


def _ca_trace(name: str) -> np.ndarray:
    if name == "square":
        return np.tile(np.r_[np.full(12, 100.0), np.full(12, 900.0)], 30)
    if name == "flat":
        return np.full(100, 100.0)
    return make_region_traces(24 * 30, dt_h=1.0, n_regions=1, seed=4)[0]


def carbon_aware_phase(dev) -> list:
    """(d) The carbon-aware trainer on `dev` in CA_SETUPS: counts and hours
    the reference's (CA_REF) exactly, carbon within rtol 1e-6, the mean of
    the last k losses below the first k's; then the example's final state
    saved and restored bit for bit."""
    lines, example = [], None
    for name, st in CA_SETUPS.items():
        cfg = reduced("qwen2-1.5b")
        if st["model"] == "widened":
            cfg = cfg.replace(n_layers=4, d_model=256, n_heads=8,
                              n_kv_heads=2, head_dim=32, d_ff=768, vocab=4096)
        model = get_model(cfg)
        tcfg = TrainConfig(opt=AdamWConfig(lr=st["lr"],
                                           warmup_steps=st["warmup"],
                                           total_steps=st["total"]))
        state = init_train_state(model,
                                 torch.Generator(device=dev).manual_seed(0),
                                 tcfg, device=dev)
        pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=st["seq"],
                                        global_batch=st["batch"]))
        d = os.path.join(TRAIN_DIR, name)
        shutil.rmtree(d, ignore_errors=True)
        ca = dict(st["ca"], shifting=C.ShiftingConfig(
            enabled=st["ca"]["shifting"]))
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        state, rep = run_carbon_aware_training(
            model, tcfg, state,
            lambda s: to_device(pipe.batch_at(s), dev),  # noqa: B023
            st["steps"], _ca_trace(st["trace"]),
            CarbonAwareConfig(ckpt_dir=d, **ca))
        _sync(dev)
        wall = time.perf_counter() - t0
        check(not any(ops.launch_counts().values()),
              f"carbon-aware {name}: a kernel launched")
        want = CA_REF[name]
        for k in CA_COUNTS:
            check(getattr(rep, k) == want[k],
                  f"carbon-aware {name}: {k} {getattr(rep, k)} != {want[k]}")
        for k in CA_CARBON:
            check(math.isclose(getattr(rep, k), want[k], rel_tol=1e-6),
                  f"carbon-aware {name}: {k} {getattr(rep, k)} != {want[k]}")
        k = st["k"]
        first, last = np.mean(rep.losses[:k]), np.mean(rep.losses[-k:])
        check(bool(np.isfinite(rep.losses).all()) and last < first,
              f"carbon-aware {name}: losses {first} -> {last}")
        lines.append({"part": "d", "setup": name, "wall_s": wall,
                      **{k: getattr(rep, k) for k in CA_COUNTS + CA_CARBON},
                      "carbon_reduction_pct": rep.carbon_reduction_pct,
                      "loss_first": float(first), "loss_last": float(last),
                      "opt_step": int(state.opt.step)})
        example = state
    # a checkpoint's save and restore on the card, bit for bit
    d = os.path.join(TRAIN_DIR, "roundtrip")
    shutil.rmtree(d, ignore_errors=True)
    _sync(dev)
    t0 = time.perf_counter()
    ckpt_lib.save(d, int(example.opt.step), example)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = ckpt_lib.restore(d, int(example.opt.step), example, device=dev)
    _sync(dev)
    restore_s = time.perf_counter() - t0
    got, want = ckpt_lib._leaf_paths(back), ckpt_lib._leaf_paths(example)
    check([n for n, _ in got] == [n for n, _ in want]
          and all(torch.equal(a, b) and a.device == b.device
                  for (_, a), (_, b) in zip(got, want)),
          "checkpoint round trip not bit-equal")
    nbytes = sum(t.numel() * t.element_size() for _, t in want)
    lines.append({"part": "d", "checkpoint_roundtrip": "bit-equal",
                  "leaves": len(want), "bytes": nbytes, "save_s": save_s,
                  "restore_s": restore_s})
    return lines


def train_cli_phase(dev) -> dict:
    """(e) `python -m repro_torch.launch.train` with TRAIN_CLI on `dev`: its
    JSON report's counts, hours and carbon equal the reference CLI's
    (CLI_REF)."""
    d = os.path.join(TRAIN_DIR, "cli")
    shutil.rmtree(d, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_CLI,
           "--ckpt-dir", d, "--device", dev.type]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                         cwd=ROOT, env=env)
    wall = time.perf_counter() - t0
    check(out.returncode == 0, f"train CLI failed: {out.stderr[-2000:]}")
    rep = json.loads(out.stdout.strip().splitlines()[-1])
    for k, v in CLI_REF.items():
        check(rep[k] == v, f"train CLI: {k} {rep[k]} != {v}")
    check(math.isfinite(rep["final_loss"]), "train CLI: final loss")
    return {"part": "e", "argv": TRAIN_CLI, "wall_s": wall, **rep}


def train_phase(dev, full_cfg, seq: int, timed: int, profile_steps: int,
                opt: dict):
    """Phase 7c's lines, each yielded when its part ends: (a) `full_cfg`
    trained, (b) its gradient card against CPU, (c) the reduced configs
    card against CPU, (d) carbon-aware training, (e) the CLI; each part's
    wall time in its line."""
    t0 = time.perf_counter()
    yield {"phase": "train", "part": "a",
           **train_full(dev, full_cfg, seq, timed, profile_steps, opt),
           "part_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    yield {"phase": "train", "part": "b", **train_grads_card_vs_cpu(
        dev, full_cfg, TRAIN_GRAD_LAYERS,
        TRAIN_GRAD_SEQ if dev.type == "cuda" else 64),
        "part_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    yield {"phase": "train", "part": "c", **train_small_card_vs_cpu(dev),
           "part_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    lines = carbon_aware_phase(dev)
    lines[-1]["part_s"] = time.perf_counter() - t0
    for line in lines:
        yield {"phase": "train", **line}
    yield {"phase": "train", **train_cli_phase(dev)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: a rehearsal at a tiny size with the plain "
                         "versions (no card, no kernels, no timings)")
    args = ap.parse_args()
    if args.device == "cpu":
        cpu = torch.device("cpu")
        meta, results, infos = main_path(cpu, 0.02, 192, 15, False)
        for info in infos:
            emit({"phase": "main", "rehearsal": True, "n_tasks":
                  meta["n_tasks"], **info})
        tel_lines, _, tel_ctx = telemetry_phase(cpu, results, 0.02, 192, 15,
                                                False)
        for line in tel_lines:
            emit({"rehearsal": True, **line})
        res = resilience_path(cpu, 0.02, 192, 15,
                              pdu_cap_kw(results["megakernel"], 192),
                              results, False, False)
        for info in res["runs"] + res["grid"]:
            emit({"phase": "resilience", "rehearsal": True, **info})
        for line in experiments_phase(cpu, results, 0.02, 192, 15, False)[0]:
            emit({"rehearsal": True, **line})
        emit({"phase": "small_tasktrace_card_vs_cpu", "rehearsal": True,
              **small_tasktrace_card_vs_cpu(cpu)})
        for line in fleet_phase(cpu, results, 0.02, 192, 15, False)[0]:
            emit({"rehearsal": True, **line})
        emit({"phase": "small_fleet_card_vs_cpu", "rehearsal": True,
              **small_fleet_card_vs_cpu(cpu)})
        emit({"rehearsal": True, **telemetry_profile(tel_ctx, 48)})
        for row in grid_phase(cpu, results, 0.02, 192, 15, False)[0]:
            emit({"phase": "grid", "rehearsal": True, **row})
        emit({"phase": "small_grid_card_vs_cpu", "rehearsal": True,
              **small_grid_card_vs_cpu(cpu)})
        for arch, contract in (("zamba2-7b", 64), ("mamba2-2.7b", 0),
                               ("qwen2-1.5b", 64), ("paligemma-3b", 0)):
            cfg = reduced(arch)
            info, _ = serve(cpu, cfg, 64, contract, 4,
                            contract_layers=cfg.n_layers
                            if cfg.family == "dense" else CONTRACT_LAYERS)
            emit({"phase": "serve", "rehearsal": True, **info})
        emit({"phase": "small_dense_card_vs_cpu", "rehearsal": True,
              **small_models_card_vs_cpu(cpu, DENSE_ARCHS)})
        for line, _ in moe_phase(cpu, {a: reduced(a).n_layers
                                       for a in MOE_ARCHS}, 64, 64, 4,
                                 reduced_archs=True):
            emit({"rehearsal": True, **line})
        for line, _ in whisper_phase(cpu, reduced("whisper-base"), 2, 64, 4):
            emit({"rehearsal": True, **line})
        for line in train_phase(cpu, reduced("qwen2-1.5b").replace(
                remat=True), 64, TRAIN_TIMED_STEPS, 2,
                dict(TRAIN_OPT, lr=1e-3)):
            emit({"rehearsal": True, **line})
        emit({"rehearsal": True, "ok_on_cpu": True})
        return 0
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); this smoke test runs on the card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "device", "nvidia_smi": smi,
          "torch_name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    report = build.build_all()
    seconds = time.perf_counter() - t0
    # registers and spills of the two kernels redesigned in registers (the
    # libraries are built fresh in a fresh checkout; a reused one has no
    # compiler output to read)
    resources = {}
    for lib, kernel in (("first_fit", "first_fit_warp_kernel"),
                        ("power_carbon", "power_carbon_kernel"),
                        ("power_carbon", "facility_power_kernel"),
                        ("fused_step", "facility_totals_kernel"),
                        ("host_sum", "host_sum_kernel")):
        if lib in report:
            resources[kernel] = build.resources(report[lib]["ptxas"], kernel)
            check(bool(resources[kernel]), f"no ptxas report of {kernel}")
    # first-fit's hosts and kernel 3's chain live in registers: a stack
    # frame without spills is an array left in local memory
    for kernel in ("first_fit_warp_kernel", "facility_totals_kernel"):
        for r in resources.get(kernel, []):
            check(r.get("stack") == r.get("spill_stores")
                  == r.get("spill_loads") == 0,
                  f"{kernel} uses local memory: {r}")
    # the per-host sums' kernel keeps two blocks an SM (its registers and
    # shared memory, as the occupancy calculator counts them), no spills
    for r in resources.get("host_sum_kernel", []):
        check(r.get("stack") == r.get("spill_stores") == 0,
              f"host_sum_kernel uses local memory: {r}")
    check(hs_k.blocks_per_sm() >= 2,
          f"host_sum_kernel: {hs_k.blocks_per_sm()} blocks an SM, not 2")
    emit({"phase": "build", "seconds": seconds, "libraries": report,
          "resources": resources})

    kres = {name: {} for name in (*build.KERNELS,
                                  "fused_facility_totals_derate")}
    t0 = time.perf_counter()
    check_power_kernels(dev, kres)
    check_first_fit(dev, kres)
    check_facility_kernel(dev, kres)
    check_facility_derate(dev, kres)
    check_facility_series(dev, kres)
    check_ssd_kernel(dev, kres)
    check_flash_kernel(dev, kres)
    check_host_sum(dev, kres)
    emit({"phase": "kernels_vs_plain", "seconds": time.perf_counter() - t0,
          "results": kres, "threefry": check_threefry(dev)})

    meta, results, infos = main_path(dev, 1.0, MAIN_STEPS, MARCONI_ACTIVE,
                                     True)
    check(meta["n_tasks"] == 192817 and meta["n_hosts"] == 972,
          f"Marconi at full scale: {meta['n_tasks']} tasks, "
          f"{meta['n_hosts']} hosts")
    for info in infos:
        emit({"phase": "main", "workload": "marconi", "n_tasks":
              meta["n_tasks"], "n_hosts": meta["n_hosts"],
              "n_steps": MAIN_STEPS, "n_active_hosts": MARCONI_ACTIVE,
              **info})

    # telemetry and the probe bus at the main configuration (its profile
    # comes after the grid phase's)
    t0 = time.perf_counter()
    tel_lines, tel_launches, tel_ctx = telemetry_phase(
        dev, results, 1.0, MAIN_STEPS, MARCONI_ACTIVE, True)
    for line in tel_lines:
        emit({"workload": "marconi", "n_steps": MAIN_STEPS, **line})
    tel_s = time.perf_counter() - t0

    # the main path with host failures, checkpointing and the closed
    # resilience loop: both executors, then the seed x hazard grid (timed
    # before any profile; the profile comes after the grid phase's)
    t0 = time.perf_counter()
    cap = pdu_cap_kw(results["megakernel"], MAIN_STEPS)
    resil = resilience_path(dev, 1.0, MAIN_STEPS, MARCONI_ACTIVE, cap,
                            results, True, True)
    for info in resil["runs"]:
        emit({"phase": "resilience", "workload": "marconi", "n_tasks":
              meta["n_tasks"], "n_steps": MAIN_STEPS, "seed": RES_SEED,
              "pdu_cap_kw": cap, **info})
    for row in resil["grid"]:
        emit({"phase": "resilience_grid", "seeds": RES_GRID_SEEDS,
              "failure_hazard_scale": RES_GRID_HAZARDS, **row})
    emit({"phase": "resilience_summary", "pdu_cap_kw": cap,
          "backend_rel_diff": resil["backend_rel_diff"],
          "open_loop_vs_closed": resil["open_loop_vs_closed"]})
    res_seconds = time.perf_counter() - t0

    # the experiment tooling at full scale: aggregate scheduling, the §III
    # gap, a task-trace grid, the scaling searches and the CLI (before any
    # profile)
    t0 = time.perf_counter()
    exp_lines, exp_launches = experiments_phase(dev, results, 1.0,
                                                MAIN_STEPS, MARCONI_ACTIVE,
                                                True)
    for line in exp_lines:
        emit(line)
    emit({"phase": "experiments_summary",
          "seconds": time.perf_counter() - t0,
          "seconds_by_part": [[x["part"], x["wall_s"]] for x in exp_lines],
          "launches": exp_launches})

    # the multi-datacenter fleet: greedy, round-robin and online placement,
    # a 64-row fleet grid and the cross-region spill under failures (timed
    # before any profile; its profiles come after the grid phase's)
    t0 = time.perf_counter()
    fleet_lines, fleet_launches, fleet_ctx = fleet_phase(
        dev, results, 1.0, MAIN_STEPS, MARCONI_ACTIVE, True)
    for line in fleet_lines:
        emit({"workload": "marconi", "n_steps": MAIN_STEPS, **line})
    fleet_s = time.perf_counter() - t0

    # the scenario grid at the main configuration: B = 1, 16, 64 cells in
    # one step loop each, on both backends; then the profiles of the main
    # run and of each grid
    t0 = time.perf_counter()
    grid_rows, grid_launches, profile, seconds = grid_phase(
        dev, results, 1.0, MAIN_STEPS, MARCONI_ACTIVE, True,
        profile_steps=PROFILE_STEPS)
    for row in profile:
        emit({"phase": "profile", **row})
    for row in grid_rows:
        emit({"phase": "grid", "workload": "marconi", "n_tasks":
              meta["n_tasks"], "n_steps": MAIN_STEPS, **row})
    emit({"phase": "small_grid_card_vs_cpu", "ok": True,
          **small_grid_card_vs_cpu(dev), "grid_phase_seconds": seconds,
          "grid_phase_s": time.perf_counter() - t0})
    emit({"phase": "small_tasktrace_card_vs_cpu", "ok": True,
          **small_tasktrace_card_vs_cpu(dev)})
    # telemetry.profile of 192 probed megakernel steps
    t0 = time.perf_counter()
    emit({"workload": "marconi", **telemetry_profile(tel_ctx, 192)})
    del tel_ctx
    emit({"phase": "telemetry_summary", "seconds": tel_s,
          "profile_s": time.perf_counter() - t0, "launches": tel_launches})
    # where the resilience path's time goes: PROFILE_STEPS of each executor
    # under the profiler
    t0 = time.perf_counter()
    tasks, hosts, cfg, ci, dyn = resilience_inputs(dev, 1.0, MAIN_STEPS,
                                                   MARCONI_ACTIVE, cap)
    for row in profile_window(tasks, hosts, cfg, dyn, ci, PROFILE_STEPS,
                              dev):
        emit({"phase": "resilience_profile", **row})
    res_seconds += time.perf_counter() - t0
    # where aggregate scheduling's time goes: the same steps
    cfg = main_config(MAIN_STEPS, meta["embodied"], meta["n_hosts"]).replace(
        scheduler=C.SchedulerConfig(mode="aggregate"))
    for row in profile_window(tasks, hosts, cfg, dyn, ci, PROFILE_STEPS,
                              dev):
        emit({"phase": "experiments_profile", "mode": "aggregate", **row})
    del tasks, hosts
    # where the fleet's time goes: PROFILE_STEPS of the fleet grid on each
    # executor and of the spill fleet
    t0 = time.perf_counter()
    for row in fleet_profile(fleet_ctx, PROFILE_STEPS, dev):
        emit(row)
    del fleet_ctx
    emit({"phase": "fleet_summary", "seconds": fleet_s,
          "profile_s": time.perf_counter() - t0,
          "seconds_by_part": [[x["part"], x.get("policy", x.get("backend")),
                               x["wall_s"]] for x in fleet_lines],
          "launches": fleet_launches})

    # the small run on the card against the plain versions on the CPU
    small = {}
    for d in (dev, torch.device("cpu")):
        _, res, _ = main_path(d, 0.05, 192, 38, d.type == "cuda")
        small[d.type] = res
    for backend in ("stage-pipeline", "megakernel"):
        compare_backends(small["cuda"][backend], small["cpu"][backend], 1e-4,
                         f"card vs cpu ({backend})")
    emit({"phase": "small_card_vs_cpu", "ok": True,
          "n_done": float(small["cuda"]["stage-pipeline"]["n_done"])})
    t0 = time.perf_counter()
    info = small_resilience_card_vs_cpu(dev, small)
    emit({"phase": "small_resilience_card_vs_cpu", "ok": True, **info,
          "seconds": time.perf_counter() - t0,
          "resilience_phase_s": res_seconds + time.perf_counter() - t0})
    t0 = time.perf_counter()
    emit({"phase": "small_fleet_card_vs_cpu", "ok": True,
          **small_fleet_card_vs_cpu(dev),
          "seconds_total": time.perf_counter() - t0})

    # the serving path: zamba2-7b as configured (contract, prefill, greedy
    # decode), then mamba2-2.7b's prefill, then the dense decoders; each
    # timed prefill's launch counts are reset just before it and read just
    # after
    launches = {k: sum(i["launches"][k] for i in infos) + grid_launches[k]
                + resil["launches"][k] + exp_launches[k] + fleet_launches[k]
                + tel_launches[k] for k in build.KERNELS}
    # kernel 3's derate route: its launches on the resilience path
    launches["fused_facility_totals_derate"] = resil["launches"][
        "fused_facility_totals"]
    for cfg, contract, greedy in ((get_config("zamba2-7b"), CONTRACT_LEN,
                                   GREEDY_TOKENS),
                                  (get_config("mamba2-2.7b"), 0, 0)):
        info, counts = serve(dev, cfg, PREFILL_LEN, contract, greedy,
                             profile=True)
        emit({"phase": "serve", **info})
        for k, n in counts.items():
            launches[k] += n
    emit({"phase": "small_models_card_vs_cpu",
          **small_models_card_vs_cpu(dev)})

    # the dense and VLM decoders: qwen2-1.5b as configured (the contract
    # on its first 2 layers, prefill, greedy decode, a profile), paligemma-3b's
    # prefill behind its patch prefix; then the five dense / VLM configs
    # reduced, card against CPU (each part's wall time in its line)
    t0 = time.perf_counter()
    for cfg, contract, greedy in ((get_config("qwen2-1.5b"), CONTRACT_LEN,
                                   GREEDY_TOKENS),
                                  (get_config("paligemma-3b"), 0, 0)):
        t1 = time.perf_counter()
        info, counts = serve(dev, cfg, PREFILL_LEN, contract, greedy,
                             profile=cfg.family == "dense",
                             contract_layers=DENSE_CONTRACT_LAYERS)
        emit({"phase": "serve_dense", "nvidia_smi": smi, **info,
              "part_s": time.perf_counter() - t1})
        for k, n in counts.items():
            launches[k] += n
    t1 = time.perf_counter()
    emit({"phase": "small_dense_card_vs_cpu",
          **small_models_card_vs_cpu(dev, DENSE_ARCHS),
          "part_s": time.perf_counter() - t1,
          "dense_phase_s": time.perf_counter() - t0})

    # the MoE decoders at their published widths (depth cut to the card)
    # and whisper-base as configured; then their reduced configs card
    # against CPU (each part's wall time and peak memory in its line)
    t0 = time.perf_counter()
    for line, counts in moe_phase(dev, MOE_LAYERS, PREFILL_LEN, CONTRACT_LEN,
                                  GREEDY_TOKENS):
        emit({"nvidia_smi": smi, **line})
        for k, n in counts.items():
            launches[k] += n
    moe_s = time.perf_counter() - t0
    for line, counts in whisper_phase(dev, get_config("whisper-base"),
                                      WHISPER_BATCH, WHISPER_DEC_LEN,
                                      GREEDY_TOKENS):
        emit({"nvidia_smi": smi, **line})
        for k, n in counts.items():
            launches[k] += n
    emit({"phase": "moe_whisper_summary", "moe_phase_s": moe_s,
          "whisper_phase_s": time.perf_counter() - t0 - moe_s})

    # training: qwen2-1.5b as configured (no kernel launches), its gradient
    # card against CPU, the reduced configs, carbon-aware training and the
    # CLI (each part's wall time in its line)
    t0 = time.perf_counter()
    for line in train_phase(dev, get_config("qwen2-1.5b"), TRAIN_SEQ,
                            TRAIN_TIMED_STEPS, TRAIN_PROFILE_STEPS,
                            TRAIN_OPT):
        emit({"nvidia_smi": smi, **line})
    emit({"phase": "train_summary", "seconds": time.perf_counter() - t0})

    main_cfg = main_config(MAIN_STEPS, meta["embodied"])
    time_kernels(dev, kres, main_cfg)
    rows64 = time_kernels_at_rows(dev, main_cfg, 64)
    for name, ms in rows64["device_ms"].items():
        kres[name]["device_ms_b64"] = ms
    time_model_kernels(dev, kres)
    time_new_flash_shapes(dev, kres)
    time_host_sum(dev, kres)
    emit({"phase": "timing", "results": kres})
    sources = {"fused_power_carbon": ("power_carbon.cu",
                                      "src/repro/kernels/power_carbon.py:198"),
               "fused_facility_power": ("power_carbon.cu",
                                        "src/repro/kernels/power_carbon.py:159"),
               "fused_facility_totals": ("fused_step.cu",
                                         "src/repro/kernels/fused_step.py:261"),
               "fused_facility_totals_derate": (
                   "fused_step.cu", "src/repro/kernels/fused_step.py:261"),
               "fused_facility_series": (
                   "fused_step.cu", "src/repro/kernels/fused_step.py:261"),
               "first_fit_place": ("first_fit.cu",
                                   "src/repro/kernels/first_fit.py:78"),
               "ssd_intra_chunk": ("ssd_chunk.cu",
                                   "src/repro/kernels/ssd_chunk.py:64"),
               "flash_attention": ("flash_attn.cu",
                                   "src/repro/kernels/flash_attn.py:97"),
               # the port's own kernel: it replaces the reference's
               # segment_sum, no Pallas kernel
               "per_host_sum": ("host_sum.cu",
                                "src/repro/core/scheduler.py:45")}
    rows = []
    for name in (*build.KERNELS, "fused_facility_totals_derate"):
        r = kres[name]
        check(launches[name] > 0, f"{name} never launched on the main path")
        src, replaces = sources[name]
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{src}",
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                     "bound_by": r["bound_by"],
                     "library_ms": r["library_ms"],
                     "device_ms": r["device_ms"], "kernel_ms": r["ms"],
                     "bound_us": r["bound_ms"] * 1e3,
                     "launch_floor_ms": r.get("launch_floor_ms"),
                     "device_ms_b64": r.get("device_ms_b64")})
        check(all(math.isfinite(v) for v in (r["ms"], r["plain_ms"],
                                              r["bound_ms"])),
              f"{name}: timing not finite")
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
