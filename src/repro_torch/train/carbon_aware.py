"""Carbon-aware training: the paper's temporal-shifting technique applied to
a real training loop (the port of the reference's `train/carbon_aware.py`,
line for line).

The trainer runs a normal train-step loop but treats the job as a STEAM
task: simulated wall-clock advances with each step, a carbon-intensity
trace provides ci(t), and the same 35th-percentile-of-next-week threshold
used by `core/shifting.py` gates execution.  When carbon is high the
trainer checkpoints and PAUSES (temporal shifting); when an injected
failure hits, it restores from the latest checkpoint and replays the data
stream, which is exact because the data pipeline is stateless per step.

The schedule is host arithmetic: the threshold is computed on the CPU from
the trace, failures are numpy draws, and the carbon sums are Python
floats, so its counts and carbon figures are the reference's; only the
train steps run on the state's device.
"""
from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field

import numpy as np
import torch

from ..core.config import ShiftingConfig
from ..core.shifting import precompute_shift_threshold
from . import checkpoint as ckpt_lib
from .step import TrainConfig, TrainState, make_train_step


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "steamx_ckpt")


@dataclass(frozen=True)
class CarbonAwareConfig:
    step_time_s: float = 2.0          # simulated wall-clock per train step
    power_kw: float = 100.0           # job power draw while training
    idle_power_kw: float = 5.0        # draw while paused (host overhead)
    ckpt_every: int = 50              # steps between periodic checkpoints
    ckpt_dir: str = field(default_factory=_default_ckpt_dir)
    keep: int = 2
    shifting: ShiftingConfig = ShiftingConfig(enabled=True)
    failure_prob_per_step: float = 0.0
    max_sim_hours: float = 1e9        # safety bound on simulated time
    seed: int = 0


@dataclass
class CarbonAwareReport:
    steps_done: int = 0
    sim_hours: float = 0.0
    busy_hours: float = 0.0
    paused_hours: float = 0.0
    op_carbon_kg: float = 0.0
    baseline_carbon_kg: float = 0.0   # same steps, no shifting
    n_failures: int = 0
    n_pauses: int = 0
    n_restores: int = 0
    losses: list = field(default_factory=list)

    @property
    def carbon_reduction_pct(self) -> float:
        if self.baseline_carbon_kg <= 0:
            return 0.0
        return 100.0 * (1 - self.op_carbon_kg / self.baseline_carbon_kg)


def run_carbon_aware_training(model, tcfg: TrainConfig, state: TrainState,
                              batches, n_steps: int, ci_trace,
                              ca: CarbonAwareConfig,
                              trace_dt_h: float = 1.0
                              ) -> tuple[TrainState, CarbonAwareReport]:
    """Drive `n_steps` of training through the carbon-aware schedule.

    batches: callable step -> batch (the stateless pipeline), on the
    state's device.  ci_trace: f32[T] carbon intensity at trace_dt_h
    resolution.
    """
    ci = torch.as_tensor(np.asarray(ci_trace, np.float32))
    thresh = precompute_shift_threshold(ci, trace_dt_h, ca.shifting).numpy()
    ci_np = ci.numpy()
    train_step = make_train_step(model, tcfg)
    rng = np.random.default_rng(ca.seed)
    device = state.opt.step.device

    rep = CarbonAwareReport()
    t_h = 0.0                        # simulated wall-clock (hours)
    step_h = ca.step_time_s / 3600.0
    last_ckpt_step = None

    def ci_at(t):
        i = min(int(t / trace_dt_h), len(ci_np) - 1)
        return float(ci_np[i]), float(thresh[i])

    # always have a step-0 checkpoint to restore to
    ckpt_lib.save(ca.ckpt_dir, int(state.opt.step), state)
    last_ckpt_step = int(state.opt.step)
    # paper §V-B2: a task may be delayed at most max_delay_h, then runs FIFO.
    # The unit of shifting here is a checkpoint segment: the budget refills
    # each time a segment of ckpt_every steps completes.
    delay_budget_h = ca.shifting.max_delay_h

    while rep.steps_done < n_steps and t_h < ca.max_sim_hours:
        now_ci, now_th = ci_at(t_h)
        pausing = False
        # --- temporal shifting gate (paper §V-B2 policy, 24h cap) ---
        while (ca.shifting.enabled and now_ci > now_th
               and delay_budget_h >= trace_dt_h):
            if not pausing:
                ckpt_lib.save(ca.ckpt_dir, int(state.opt.step), state)
                last_ckpt_step = int(state.opt.step)
                rep.n_pauses += 1
                pausing = True
            rep.op_carbon_kg += ca.idle_power_kw * trace_dt_h * now_ci / 1000.0
            t_h += trace_dt_h
            delay_budget_h -= trace_dt_h
            rep.paused_hours += trace_dt_h
            now_ci, now_th = ci_at(t_h)

        # --- failure injection + restore ---
        if rng.random() < ca.failure_prob_per_step:
            rep.n_failures += 1
            if last_ckpt_step is not None:
                lost = int(state.opt.step) - last_ckpt_step
                state = ckpt_lib.restore(ca.ckpt_dir, last_ckpt_step, state,
                                         device=device)
                rep.steps_done -= lost
                rep.n_restores += 1
            continue

        # --- one real train step ---
        batch = batches(rep.steps_done)
        state, metrics = train_step(state, batch)
        rep.losses.append(float(metrics["loss"]))
        rep.steps_done += 1
        rep.op_carbon_kg += ca.power_kw * step_h * now_ci / 1000.0
        rep.baseline_carbon_kg += ca.power_kw * step_h * \
            float(ci_np[min(int(rep.busy_hours / trace_dt_h), len(ci_np) - 1)])\
            / 1000.0
        t_h += step_h
        rep.busy_hours += step_h

        if rep.steps_done % ca.ckpt_every == 0:
            ckpt_lib.save(ca.ckpt_dir, int(state.opt.step), state)
            last_ckpt_step = int(state.opt.step)
            ckpt_lib.prune(ca.ckpt_dir, ca.keep)
            delay_budget_h = ca.shifting.max_delay_h   # segment completed

    rep.sim_hours = t_h
    return state, rep
