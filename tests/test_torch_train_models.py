"""The served families' training losses (`Model.loss`) and their gradients
against the reference's `jax.value_and_grad(model.loss)`.

qwen2, stablelm, gemma2, gemma3, paligemma, mamba2 and zamba2 at their
reduced configs: one set of weights, made by the reference package from
PRNGKey(0) and carried across with `models/convert.py`, and a batch of
2 x 64 positions (paligemma: 8 patch embeddings and 56 tokens) made with
numpy seeds, with and without a loss mask.  The port's loss takes each
family's plain path (no kernel entry: the ops refuse autograd), the
reference's jnp path (`use_pallas=False`, `attn_impl="xla"`).
Tolerances: the loss within rtol 1e-5; every gradient leaf within rtol
1e-4 / atol 1e-4 x the leaf's largest magnitude, except gemma2's, whose
f32 gradient sits ~5e-4 of its scale from the same function in f64 in
both packages (`test_gemma2_gradient_resolution` measures it), held
within 1e-3.  Activation checkpointing changes no bit; the kernels'
entries refuse a tensor that requires grad; serving runs under no_grad.
"""
from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models.registry import get_model as j_get_model
import repro_torch.configs as pconfigs
from repro_torch.kernels import ops
from repro_torch.models import get_model, layers as PL
from repro_torch.models import transformer as ptransformer
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.layers import flatten, tree_map
from repro_torch.train.step import trainable

torch.set_num_threads(1)
ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "gemma2-2b", "gemma3-4b",
         "paligemma-3b", "mamba2-2.7b", "zamba2-7b")
S = 64
# the gradient tolerance (x the leaf's largest magnitude): gemma2's f32
# gradient resolves only to ~5e-4 of its scale (the reference's own f32
# gradient is 7.5e-4 from f64, the port's 4.6e-4)
GRAD_TOL = {"gemma2-2b": 1e-3}


def _batch(cfg, seed: int = 1) -> dict:
    """Tokens, labels and a mask of S positions (a VLM's patch embeddings
    among them), as numpy."""
    rng = np.random.default_rng(seed)
    s, out = S, {}
    if cfg.family == "vlm":
        out["patch_embeds"] = (rng.standard_normal(
            (2, cfg.n_frontend_tokens, cfg.frontend_dim)) * 0.5).astype(
                np.float32)
        s -= cfg.n_frontend_tokens
    out["tokens"] = rng.integers(0, cfg.vocab, (2, s), dtype=np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (2, s), dtype=np.int32)
    out["mask"] = (rng.random((2, s)) < 0.7).astype(np.float32)
    return out


def _unmasked(batch: dict) -> dict:
    return {k: v for k, v in batch.items() if k != "mask"}


@functools.lru_cache(maxsize=None)
def _reference(arch: str):
    """(params, batch, {masked: (loss, flat grads)}) of the reference, from
    one jit of both value_and_grads."""
    cfg = jconfigs.reduced(arch)
    model = j_get_model(cfg)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    batch = _batch(cfg)
    vg = jax.value_and_grad(model.loss)
    both = jax.jit(lambda p, b: (vg(p, _unmasked(b)), vg(p, b)))(params,
                                                                 batch)
    out = {masked: (float(loss), flatten(jax.tree.map(np.asarray, grads)))
           for masked, (loss, grads) in zip((False, True), both)}
    return params, batch, out


def _port_value_and_grad(arch: str, batch: dict, cfg=None, params=None):
    """(loss, flat grads) of the port's Model.loss on the reference's
    weights."""
    cfg = cfg or pconfigs.reduced(arch)
    if params is None:
        params = trainable(params_from_numpy(_reference(arch)[0], "cpu"))
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss = get_model(cfg).loss(params, tb)
    paths, leaves = zip(*sorted(flatten(params).items()))
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), dict(zip(paths, grads))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, masked):
    _, batch, ref = _reference(arch)
    want_loss, want_grads = ref[masked]
    loss, grads = _port_value_and_grad(
        arch, batch if masked else _unmasked(batch))
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-5)
    assert sorted(grads) == sorted(want_grads)
    tol = GRAD_TOL.get(arch, 1e-4)
    for path, want in want_grads.items():
        got = grads[path].numpy()
        scale = float(np.abs(want).max())
        assert scale > 0, path
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=tol * scale,
                                   err_msg=str(path))


def test_gemma2_gradient_resolution(monkeypatch):
    """The reduced gemma2's gradient in f32 against the same function in
    f64 (the port's code with f64 in place of f32): the reference's f32
    gradient and the port's both sit more than 1e-4 of the leaf scale from
    it, so 1e-4 is below what f32 resolves here, and both within 1e-3."""
    arch = "gemma2-2b"
    params, batch, ref = _reference(arch)
    _, want32 = ref[False]
    _, got32 = _port_value_and_grad(arch, _unmasked(batch))
    monkeypatch.setitem(PL.DTYPES, "float64", torch.float64)
    monkeypatch.setattr(PL, "F32", torch.float64)
    cfg64 = pconfigs.reduced(arch).replace(compute_dtype="float64")
    p64 = trainable(tree_map(lambda t: t.double(),
                             params_from_numpy(params, "cpu")))
    _, g64 = _port_value_and_grad(arch, _unmasked(batch), cfg64, p64)

    def dist(grads):
        return max(float(np.abs(np.asarray(grads[k], np.float64)
                                - g64[k].numpy()).max()
                         / np.abs(g64[k].numpy()).max()) for k in g64)
    ref_dist = dist(want32)
    port_dist = dist({k: v.numpy() for k, v in got32.items()})
    assert 1e-4 < ref_dist < 1e-3, ref_dist
    assert port_dist < 1e-3, port_dist


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["qwen2-1.5b", "gemma3-4b", "mamba2-2.7b",
                                  "zamba2-7b"])
def test_remat_changes_no_bit(arch, policy):
    """Activation checkpointing per layer (and the blockwise attention's
    per block, always on under grad) recomputes the same bits."""
    _, batch, _ = _reference(arch)
    cfg = pconfigs.reduced(arch)
    off = _port_value_and_grad(arch, batch, cfg.replace(remat=False))
    on = _port_value_and_grad(arch, batch,
                              cfg.replace(remat=True, remat_policy=policy))
    assert torch.equal(off[0], on[0])
    for path, g in off[1].items():
        assert torch.equal(g, on[1][path]), path


def test_remat_policy_context():
    cfg = pconfigs.reduced("qwen2-1.5b")
    assert PL.remat_policy(cfg) is torch.utils.checkpoint.noop_context_fn
    dots = PL.remat_policy(cfg.replace(remat_policy="dots"))
    assert dots.func is \
        torch.utils.checkpoint.create_selective_checkpoint_contexts
    f = lambda x: x * 2  # noqa: E731
    assert PL.checkpointed(cfg, f) is f          # remat off: unchanged
    wrapped = PL.checkpointed(cfg.replace(remat=True), f)
    x = torch.ones(3, requires_grad=True)
    with torch.no_grad():
        assert torch.equal(wrapped(x), f(x))


def test_kernel_entries_refuse_autograd():
    """On the CPU too: a training path that reached a kernel entry would
    lose that input's gradient on the card."""
    g = torch.Generator().manual_seed(0)
    q = torch.randn((1, 8, 2, 4), generator=g, requires_grad=True)
    k, v = torch.randn((1, 8, 2, 4)), torch.randn((1, 8, 2, 4))
    with pytest.raises(RuntimeError, match="use_kernels=False"):
        ops.flash_attention(q, k, v, scale=0.5)
    with torch.no_grad():
        ops.flash_attention(q, k, v, scale=0.5)
    ops.flash_attention(q.detach(), k, v, scale=0.5)
    xdt = torch.randn((1, 2, 4, 2, 3), requires_grad=True)
    da = -torch.rand((1, 2, 2, 4))
    b, c = torch.randn((1, 2, 4, 1, 5)), torch.randn((1, 2, 4, 1, 5))
    with pytest.raises(RuntimeError, match="no backward"):
        ops.ssd_intra_chunk(xdt, da, b, c)
    with torch.no_grad():
        ops.ssd_intra_chunk(xdt, da, b, c)
    with pytest.raises(RuntimeError, match="requires grad"):
        ops.per_host_sum(torch.ones(6, dtype=torch.int32),
                         torch.tensor([0, 1, 1, 0, 2, 2], dtype=torch.int32),
                         torch.rand(6, requires_grad=True), torch.rand(6), 3)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "mamba2-2.7b", "zamba2-7b"])
def test_serving_path_refuses_and_serving_runs_without_grad(arch):
    """The serving functions called directly with trainable parameters
    reach a kernel entry and raise; `Model.prefill` and `decode_step` run
    under no_grad and give the logits of plain tensors (within an ulp or
    two: PyTorch's matmul keeps a weight that requires grad out of its
    folded 2-D product, a different CPU kernel)."""
    cfg = pconfigs.reduced(arch)
    model = get_model(cfg)
    plain = params_from_numpy(_reference(arch)[0], "cpu")
    train = trainable(params_from_numpy(_reference(arch)[0], "cpu"))
    tokens = torch.as_tensor(_reference(arch)[1]["tokens"])
    logits_fn = (ptransformer.dense_logits if cfg.family == "dense"
                 else None)
    if logits_fn is not None:
        with pytest.raises(RuntimeError, match="requires grad"):
            logits_fn(cfg, train, tokens)
    want = model.prefill(plain, {"tokens": tokens})
    got = model.prefill(train, {"tokens": tokens})
    assert not got.requires_grad
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    cache = model.init_cache(2, 4, device="cpu")
    lg, _ = model.decode_step(train, cache, tokens[:, :1], 0)
    assert not lg.requires_grad
