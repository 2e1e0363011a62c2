"""The port's carbon-aware trainer (train/carbon_aware.py) and training CLI
(launch/train.py) against the reference's.

The schedule (the shifting threshold from the carbon trace, the failure
draws, the simulated clock and the carbon sums) does not depend on the
model's numbers, so each report's counts and hours equal the reference's
exactly and its carbon figures within rtol 1e-6, though the two packages
train different random weights: the reference's two setups of
tests/test_train_substrate.py (a square wave of 12 h at 100 and 12 h at
900 g/kWh over 16 one-hour steps; constant carbon with a failure
probability of 0.3, seed 5), and the CLI's carbon-aware run.
"""
from __future__ import annotations

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced as j_reduced
from repro.core.config import ShiftingConfig as JShifting
from repro.data.pipeline import DataConfig as JData, TokenPipeline as JPipe
from repro.launch import train as j_cli
from repro.models.registry import get_model as j_get_model
from repro.train import carbon_aware as jca
from repro.train.optimizer import AdamWConfig as JAdamW
from repro.train.step import TrainConfig as JTrain, \
    init_train_state as j_init
from repro_torch.configs import reduced as p_reduced
from repro_torch.core.config import ShiftingConfig
from repro_torch.data.pipeline import DataConfig, TokenPipeline, to_device
from repro_torch.launch import train as p_cli
from repro_torch.models import get_model
from repro_torch.models.layers import flatten
from repro_torch.train import carbon_aware as pca
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.step import TrainConfig, init_train_state

torch.set_num_threads(1)
COUNTS = ("steps_done", "n_pauses", "n_failures", "n_restores",
          "paused_hours", "busy_hours", "sim_hours")
CARBON = ("op_carbon_kg", "baseline_carbon_kg")

SQUARE = np.tile(np.r_[np.full(12, 100.0), np.full(12, 900.0)], 30)
SETUPS = {
    "pauses": dict(ci=SQUARE, n=16, ckpt_every=5, step_time_s=3600.0,
                   shifting=True, failure=0.0, seed=0),
    "failures": dict(ci=np.full(100, 100.0), n=10, ckpt_every=3,
                     step_time_s=2.0, shifting=False, failure=0.3, seed=5),
}


def _reference(setup: dict, ckpt_dir: str):
    cfg = j_reduced("qwen2-1.5b")
    model = j_get_model(cfg)
    tcfg = JTrain(opt=JAdamW(lr=1e-3, warmup_steps=1, total_steps=50))
    state = j_init(model, jax.random.PRNGKey(0), tcfg)
    pipe = JPipe(JData(vocab=cfg.vocab, seq_len=32, global_batch=2))
    ca = jca.CarbonAwareConfig(
        ckpt_dir=ckpt_dir, ckpt_every=setup["ckpt_every"],
        step_time_s=setup["step_time_s"],
        shifting=JShifting(enabled=setup["shifting"]),
        failure_prob_per_step=setup["failure"], seed=setup["seed"])
    return jca.run_carbon_aware_training(
        model, tcfg, state,
        lambda s: {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()},
        setup["n"], setup["ci"], ca)


def _port(setup: dict, ckpt_dir: str):
    cfg = p_reduced("qwen2-1.5b")
    model = get_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=50))
    state = init_train_state(model, torch.Generator().manual_seed(0), tcfg,
                             device="cpu")
    pipe = TokenPipeline(DataConfig(vocab=cfg.vocab, seq_len=32,
                                    global_batch=2))
    ca = pca.CarbonAwareConfig(
        ckpt_dir=ckpt_dir, ckpt_every=setup["ckpt_every"],
        step_time_s=setup["step_time_s"],
        shifting=ShiftingConfig(enabled=setup["shifting"]),
        failure_prob_per_step=setup["failure"], seed=setup["seed"])
    return pca.run_carbon_aware_training(
        model, tcfg, state, lambda s: to_device(pipe.batch_at(s), "cpu"),
        setup["n"], setup["ci"], ca)


@pytest.mark.parametrize("name", list(SETUPS))
def test_report_equals_the_references(name, tmp_path):
    setup = SETUPS[name]
    jstate, want = _reference(setup, str(tmp_path / "ref"))
    state, got = _port(setup, str(tmp_path / "port"))
    for k in COUNTS:
        assert getattr(got, k) == getattr(want, k), k
    for k in CARBON:
        np.testing.assert_allclose(getattr(got, k), getattr(want, k),
                                   rtol=1e-6, err_msg=k)
    np.testing.assert_allclose(got.carbon_reduction_pct,
                               want.carbon_reduction_pct, rtol=1e-6,
                               atol=1e-9)
    assert len(got.losses) == len(want.losses)
    assert all(np.isfinite(got.losses))
    assert int(state.opt.step) == int(jstate.opt.step) == setup["n"]
    assert all(p.requires_grad for p in flatten(state.params).values())
    if name == "pauses":       # the reference's own assertions
        assert got.steps_done == 16 and got.n_pauses >= 1
        assert got.paused_hours > 0
        assert got.op_carbon_kg < got.baseline_carbon_kg
    else:
        assert got.n_failures > 0 and got.n_restores > 0


def _cli(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    lines = out.getvalue().strip().splitlines()
    assert lines[0].startswith("arch=qwen2-1.5b params=0.1M")
    return json.loads(lines[-1])


def test_cli_report_equals_the_references(tmp_path):
    args = ["--arch", "qwen2-1.5b", "--reduced", "--steps", "20",
            "--carbon-aware", "--failures", "0.02"]
    want = _cli(j_cli.main, args + ["--ckpt-dir", str(tmp_path / "ref")])
    got = _cli(p_cli.main, args + ["--ckpt-dir", str(tmp_path / "port"),
                                   "--device", "cpu"])
    assert set(got) == set(want)
    for k in ("steps", "sim_hours", "paused_hours", "pauses", "failures",
              "restores", "op_carbon_kg", "baseline_carbon_kg",
              "carbon_reduction_pct"):
        assert got[k] == want[k], k
    assert got["failures"] > 0 and np.isfinite(got["final_loss"])


def test_cli_plain_loop_with_failures_and_resume(tmp_path):
    """The CLI's loop without the carbon gate: periodic checkpoints, a
    restore on an injected failure, then --resume from the last one."""
    args = ["--arch", "mamba2-2.7b", "--reduced", "--batch", "2", "--seq",
            "32", "--ckpt-every", "4", "--log-every", "4", "--failures",
            "0.2", "--seed", "3", "--device", "cpu", "--ckpt-dir",
            str(tmp_path / "ck")]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        p_cli.main(args + ["--steps", "12"])
    text = out.getvalue()
    assert "[failure injected @ step" in text
    assert "step    12 loss" in text and "done: 12 steps" in text
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        p_cli.main(args + ["--steps", "16", "--resume"])
    assert "resumed from step 12" in out.getvalue()
