"""The port's train step (train/step.py) against the reference's jitted
`make_train_step`: three steps on one batch from one set of weights.

Adam's update is about lr x sign(g) per parameter, so a gradient element
near zero whose sign differs between the packages moves that parameter by
2 lr, and the next step's loss by an amount the model's conditioning sets:
the trajectories are compared on the loss, not parameter by parameter
(tests/test_torch_train.py holds AdamW itself to the reference on
identical inputs).  Two comparisons, at lr 1e-3 (the reference CLI's
default; at its smoke test's 1e-2 the flips move the loss by up to 9e-3
within three steps):

  * each of the seven served families' reduced configs, one step at a
    time from the reference's state after 0, 1 and 2 steps: the loss within
    1e-4 (the same parameters), the gradient norm within relative 1e-4
    (gemma2's 1e-3, the resolution of its f32 gradient;
    tests/test_torch_train_models.py), the learning rate exact, every new
    parameter within 2.5 lr of the reference's;
  * three free-running steps, the losses within 1e-4, where the f32
    gradient resolves its signs: not gemma2 and zamba2, whose third losses
    drift 4.5e-3 and 6.6e-4 from the reference's
    (`test_free_running_drift_of_ill_resolved_configs` records it);

then gradient accumulation over 2 microbatches (qwen2) and int8
compression with error feedback (stablelm, the reference's
`test_compression_in_train_step` case).
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.registry import get_model as j_get_model
from repro.train import optimizer as jopt
from repro.train import step as jstep
import repro_torch.configs as pconfigs
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import flatten
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep

torch.set_num_threads(1)
ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "gemma2-2b", "gemma3-4b",
         "paligemma-3b", "mamba2-2.7b", "zamba2-7b")
# f32 gradients that resolve their signs: three free-running steps agree
RESOLVED = ("qwen2-1.5b", "stablelm-1.6b", "gemma3-4b", "paligemma-3b",
            "mamba2-2.7b")
NORM_RTOL = {"gemma2-2b": 1e-3}
STEPS = 3
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)


def _batch(cfg, b: int = 2, s: int = 64, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (b, cfg.n_frontend_tokens, cfg.frontend_dim)) * 0.5).astype(
                np.float32)
        s -= cfg.n_frontend_tokens
    out["tokens"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (b, s), dtype=np.int32)
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch: str, b: int, tkw: tuple):
    """The reference's (jitted step, initial state, batch), compiled once
    per file."""
    jcfg = jconfigs.reduced(arch)
    jtc = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT), **dict(tkw))
    jmodel = j_get_model(jcfg)
    jst = jstep.init_train_state(jmodel, jax.random.PRNGKey(0), jtc)
    return (jax.jit(jstep.make_train_step(jmodel, jtc)), jst,
            _batch(jcfg, b))


def _setup(arch: str, b: int = 2, **tkw):
    """The reference's (jitted step, state, batch) and the port's (step,
    state on the same weights, batch)."""
    jfn, jst, batch = _reference(arch, b, tuple(sorted(tkw.items())))
    ptc = pstep.TrainConfig(opt=popt.AdamWConfig(**OPT), **tkw)
    pst = pstep.new_train_state(
        params_from_numpy(jax.tree.map(np.asarray, jst.params), "cpu"), ptc)
    return ((jfn, jst, batch),
            (pstep.make_train_step(get_model(pconfigs.reduced(arch)), ptc),
             pst, {k: torch.as_tensor(v) for k, v in batch.items()}))


def _metrics(m) -> list:
    return [float(m[k]) for k in ("loss", "grad_norm", "lr")]


def _runs(arch: str, b: int = 2, **tkw):
    """Per-step (loss, grad norm, lr) of three free-running steps of the
    reference and of the port, and the port's last state."""
    (jfn, jst, jb), (pfn, pst, pb) = _setup(arch, b, **tkw)
    ref, port = [], []
    for _ in range(STEPS):
        jst, jm = jfn(jst, jb)
        pst, pm = pfn(pst, pb)
        ref.append(_metrics(jm))
        port.append(_metrics(pm))
    assert int(pst.opt.step) == int(jst.opt.step) == STEPS
    return np.array(ref), np.array(port), pst


def _port_state(jst, tkw: dict):
    """The reference's TrainState as the port's (parameters trainable)."""
    tree = lambda t: params_from_numpy(jax.tree.map(np.asarray, t), "cpu")
    st = pstep.new_train_state(tree(jst.params),
                               pstep.TrainConfig(**tkw))
    return pstep.TrainState(st.params, popt.OptState(
        torch.tensor(int(jst.opt.step), dtype=torch.int32), tree(jst.opt.m),
        tree(jst.opt.v)), None if jst.ef is None else tree(jst.ef))


def _check(arch: str, ref, port) -> None:
    np.testing.assert_allclose(port[:, 0], ref[:, 0], rtol=0, atol=1e-4)
    # the first step's gradient is taken at the same parameters
    np.testing.assert_allclose(port[0, 1], ref[0, 1],
                               rtol=NORM_RTOL.get(arch, 1e-4))
    np.testing.assert_array_equal(port[:, 2].astype(np.float32),
                                  ref[:, 2].astype(np.float32))


@pytest.mark.parametrize("arch", ARCHS)
def test_each_step_from_the_reference_state(arch):
    (jfn, jst, jb), (pfn, _, pb) = _setup(arch)
    for _ in range(STEPS):
        pst, pm = pfn(_port_state(jst, {}), pb)
        jst, jm = jfn(jst, jb)
        got, want = _metrics(pm), _metrics(jm)
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[1], want[1],
                                   rtol=NORM_RTOL.get(arch, 1e-4))
        assert np.float32(got[2]) == np.float32(want[2])
        assert int(pst.opt.step) == int(jst.opt.step)
        new = flatten(jax.tree.map(np.asarray, jst.params))
        for path, p in flatten(pst.params).items():
            np.testing.assert_allclose(p.detach().numpy(), new[path],
                                       rtol=0, atol=2.5 * LR,
                                       err_msg=str(path))


@pytest.mark.parametrize("arch", RESOLVED)
def test_three_steps_match_reference(arch):
    ref, port, state = _runs(arch)
    _check(arch, ref, port)
    assert all(p.requires_grad for p in flatten(state.params).values())


@pytest.mark.parametrize("arch,drift", [("gemma2-2b", 1e-3),
                                        ("zamba2-7b", 1e-4)])
def test_free_running_drift_of_ill_resolved_configs(arch, drift):
    """The two configs whose f32 gradient does not resolve its signs: the
    first loss agrees, the third drifts by more than the tolerance (so the
    test above cannot hold them), and both still fall."""
    ref, port, _ = _runs(arch)
    assert abs(port[0, 0] - ref[0, 0]) < 1e-5
    assert abs(port[2, 0] - ref[2, 0]) > drift
    assert port[2, 0] < port[0, 0] and ref[2, 0] < ref[0, 0]


def test_microbatches_match_reference():
    arch = "qwen2-1.5b"
    ref, port, _ = _runs(arch, b=4, microbatches=2)
    _check(arch, ref, port)
    # and accumulation over 2 microbatches is the whole batch's first step
    # (the same parameters; later steps follow Adam's sign flips)
    _, whole, _ = _runs(arch, b=4)
    np.testing.assert_allclose(port[0, :2], whole[0, :2], rtol=1e-6)
    np.testing.assert_allclose(port[:, 0], whole[:, 0], rtol=0, atol=1e-4)


def test_grad_compression_matches_reference():
    arch = "stablelm-1.6b"
    ref, port, state = _runs(arch, grad_compression=True)
    _check(arch, ref, port)
    assert state.ef is not None
    assert port[1, 0] < port[0, 0] + 1e-3     # the reference's own check


def test_eval_step_is_the_loss_without_grad():
    arch = "mamba2-2.7b"
    cfg = pconfigs.reduced(arch)
    model = get_model(cfg)
    st = pstep.init_train_state(model, torch.Generator().manual_seed(0),
                                pstep.TrainConfig(), device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in _batch(cfg).items()}
    loss = pstep.make_eval_step(model)(st.params, batch)
    assert not loss.requires_grad
    assert torch.equal(loss, model.loss(st.params, batch).detach())
