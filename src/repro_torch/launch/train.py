"""End-to-end training entry point (the port of the reference's
`launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 200 --reduced --batch 8 --seq 128 [--carbon-aware] \
        [--failures 0.02] [--device cpu]

Runs a real training loop on `--device` (default the card): the stateless
data pipeline, AdamW, periodic checkpointing with restart on failure, and
optionally the paper's temporal-shifting technique through the
carbon-aware trainer, whose report is one JSON line (the reference's
keys).  `--reduced` trains the family's small variant; without it the
config as published (one card: qwen2-1.5b fits at modest batch).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch

from repro_torch.carbontraces.synthetic import make_region_traces
from repro_torch.configs import get_config, reduced as reduced_cfg
from repro_torch.core.config import ShiftingConfig
from repro_torch.data.pipeline import (DataConfig, TokenPipeline,
                                       entropy_floor, to_device)
from repro_torch.models.layers import flatten
from repro_torch.models.registry import get_model
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.carbon_aware import (CarbonAwareConfig,
                                            run_carbon_aware_training)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import (TrainConfig, init_train_state,
                                    make_train_step)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--reduced", action="store_true",
                    help="train the smoke-scale variant")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "steamx_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--carbon-aware", action="store_true",
                    help="temporal-shift training around carbon peaks")
    ap.add_argument("--failures", type=float, default=0.0,
                    help="per-step failure probability (tests restart path)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where training runs (cuda or cpu)")
    args = ap.parse_args(argv)

    cfg = reduced_cfg(args.arch) if args.reduced else get_config(args.arch)
    model = get_model(cfg)
    tcfg = TrainConfig(
        opt=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                        total_steps=args.steps),
        grad_compression=args.grad_compression)

    dcfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                      global_batch=args.batch, seed=args.seed)
    pipe = TokenPipeline(dcfg)
    dev = torch.device(args.device)
    state = init_train_state(
        model, torch.Generator(device=dev).manual_seed(args.seed), tcfg,
        device=dev)
    n_params = sum(x.numel() for x in flatten(state.params).values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M "
          f"entropy_floor={entropy_floor(dcfg):.3f}")

    start_step = 0
    if args.resume:
        last = ckpt_lib.latest_step(args.ckpt_dir)
        if last is not None:
            state = ckpt_lib.restore(args.ckpt_dir, last, state, device=dev)
            start_step = last
            print(f"resumed from step {last}")

    def batch_fn(step):
        return to_device(pipe.batch_at(step), dev)

    if args.carbon_aware:
        traces = make_region_traces(n_steps=24 * 60, dt_h=1.0, n_regions=1,
                                    seed=args.seed)
        ca = CarbonAwareConfig(
            ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
            shifting=ShiftingConfig(enabled=True),
            failure_prob_per_step=args.failures, seed=args.seed)
        state, rep = run_carbon_aware_training(
            model, tcfg, state, batch_fn, args.steps, traces[0], ca)
        print(json.dumps({
            "steps": rep.steps_done, "sim_hours": round(rep.sim_hours, 2),
            "paused_hours": round(rep.paused_hours, 2),
            "pauses": rep.n_pauses, "failures": rep.n_failures,
            "restores": rep.n_restores,
            "op_carbon_kg": round(rep.op_carbon_kg, 3),
            "baseline_carbon_kg": round(rep.baseline_carbon_kg, 3),
            "carbon_reduction_pct": round(rep.carbon_reduction_pct, 2),
            "final_loss": rep.losses[-1] if rep.losses else None}))
        return

    train_step = make_train_step(model, tcfg)
    rng = np.random.default_rng(args.seed)
    t0 = time.time()
    step = start_step
    while step < args.steps:
        if args.failures and rng.random() < args.failures:
            last = ckpt_lib.latest_step(args.ckpt_dir)
            if last is not None:
                print(f"[failure injected @ step {step}] restoring {last}")
                state = ckpt_lib.restore(args.ckpt_dir, last, state,
                                         device=dev)
                step = last
                continue
        state, metrics = train_step(state, batch_fn(step))
        step += 1
        if step % args.log_every == 0 or step == args.steps:
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"({(time.time()-t0)/max(step-start_step,1):.2f}s/step)")
        if step % args.ckpt_every == 0:
            ckpt_lib.save(args.ckpt_dir, step, state)
            ckpt_lib.prune(args.ckpt_dir, keep=2)
    print(f"done: {args.steps} steps in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
