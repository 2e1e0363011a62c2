"""The port's encoder-decoder (models/whisper.py) against the reference's.

whisper-base at its reduced config: one set of weights, made by the
reference package from PRNGKey(0) and carried across with
`models/convert.py`, and frame embeddings and tokens made with numpy seeds
go through both packages on the CPU.  The reference's attention takes its
blockwise softmax (causal in the decoder, over every key in the encoder
and the cross-attention); the port's serving path takes flash attention's
plain version with the same causal flags, its loss the blockwise softmax.
Decode reads the cross-attention K / V from the cache, built by the caller
from the encoder output as tests/test_decode_consistency.py builds it.
Tolerances: 1e-4 for encoder states, logits and caches, 2e-4 for the port's
decode-vs-prefill contract (the reference test's), rtol 1e-4 for the loss
and each gradient leaf (atol 1e-4 x the leaf's scale).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as JL
from repro.models import whisper as jwhisper
from repro.models.registry import get_model as j_get_model
from repro.train import optimizer as jopt
from repro.train import step as jstep
import repro_torch.configs as pconfigs
from repro_torch.models import get_model, layers as PL
from repro_torch.models import whisper as pwhisper
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import flatten
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep

torch.set_num_threads(1)
T = torch.tensor
ARCH = "whisper-base"
S = 16
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)


@functools.lru_cache(maxsize=None)
def _weights():
    """(reduced config, reference params as numpy) from PRNGKey(0)."""
    cfg = jconfigs.reduced(ARCH)
    return cfg, jax.tree.map(np.asarray,
                             j_get_model(cfg).init(jax.random.PRNGKey(0)))


def _port(cfg=None):
    """(the port's config, the reference's weights as CPU tensors)."""
    return (cfg or pconfigs.reduced(ARCH),
            params_from_numpy(_weights()[1], device="cpu"))


def _frames(cfg, b=2, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _tokens(cfg, b=2, s=S, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@functools.lru_cache(maxsize=None)
def _reference_enc():
    cfg, jp = _weights()
    frames = _frames(cfg)
    return frames, np.asarray(jax.jit(
        lambda p, f: jwhisper.encode(cfg, p, f))(jp, frames))


def test_param_tree_matches_and_round_trips():
    cfg, jp = _weights()
    pcfg, pp = _port()
    own = get_model(pcfg).init(torch.Generator().manual_seed(0), device="cpu")
    flat_ref = PL.flatten(jp)
    assert set(PL.flatten(own)) == set(PL.flatten(pp)) == set(flat_ref)
    for path, a in flat_ref.items():
        assert tuple(PL.flatten(own)[path].shape) == a.shape, path
    for path, a in PL.flatten(params_to_numpy(pp)).items():
        np.testing.assert_array_equal(a, flat_ref[path], err_msg=str(path))


@pytest.mark.parametrize("seq,d", [(16, 64), (1500, 512)])
def test_sinusoid_matches_reference(seq, d):
    """The encoder's positions in f32 (PyTorch's and XLA's exp, sin and cos
    may differ by ulps; at 1500 positions an ulp of the frequency moves the
    angle by ~1e-4 rad)."""
    want = np.asarray(jwhisper._sinusoid(seq, d))
    got = pwhisper._sinusoid(seq, d)
    _close(got, want, 1e-6 if seq <= 16 else 2e-4)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("block,sq,sk", [(8, 32, 32), (8, 32, 20),
                                         (512, 16, 24)])
def test_sdpa_blockwise_matches_reference(causal, block, sq, sk):
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, sk, 2, 16)).astype(np.float32)
            for _ in range(2))
    want = JL.sdpa_blockwise(q, k, v, 0.25, block=block, causal=causal)
    got = PL.sdpa_blockwise(T(q), T(k), T(v), 0.25, block=block,
                            causal=causal)
    _close(got, want, 1e-5)


def test_encode_matches_reference():
    frames, want = _reference_enc()
    pcfg, pp = _port()
    _close(pwhisper.encode(pcfg, pp, T(frames)), want, 1e-4)
    _close(pwhisper.encode(pcfg, pp, T(frames), use_kernels=False), want,
           1e-4, "blockwise")


@pytest.mark.parametrize("last_only", [True, False])
def test_decode_train_matches_reference(last_only):
    cfg, jp = _weights()
    frames, enc = _reference_enc()
    tokens = _tokens(cfg)
    want = jax.jit(lambda p, t, e: jwhisper.decode_train(
        cfg, p, t, e, last_only=last_only))(jp, tokens, enc)
    pcfg, pp = _port()
    got = pwhisper.decode_train(pcfg, pp, T(tokens), T(enc),
                                last_only=last_only)
    _close(got, want, 1e-4)
    if last_only:
        model = get_model(pcfg)
        got = model.prefill(pp, {"frames": T(frames), "tokens": T(tokens)})
        _close(got, want, 1e-4, "prefill")


def test_decoder_positions_wrap_like_reference():
    """Past the table's rows the decoder positions repeat (the reference
    tiles its 4096 rows; here a table of 8 rows and 20 tokens)."""
    cfg, jp = _weights()
    jp = dict(jp, dec_pos=jp["dec_pos"][:8])
    _, enc = _reference_enc()
    tokens = _tokens(cfg, s=20, seed=3)
    want = jwhisper.decode_train(cfg, jp, tokens, enc)
    pcfg, _ = _port()
    got = pwhisper.decode_train(pcfg, params_from_numpy(jp, device="cpu"),
                                T(tokens), T(enc))
    _close(got, want, 1e-4)


def _cross_cache(cfg, params, enc, cache, project, cdt, stack):
    """The serving path's cross-attention K / V: each decoder layer's
    projection of the encoder output (tests/test_decode_consistency.py)."""
    xk, xv = [], []
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in params["dec_layers"]["cross_attn"].items()}
        xk.append(project(lp, enc, cdt, "k"))
        xv.append(project(lp, enc, cdt, "v"))
    return dict(cache, cross_k=stack(xk), cross_v=stack(xv))


def test_decode_steps_match_reference():
    """16 decode steps from an empty self-attention cache with the
    cross-attention K / V built from the same encoder output: logits every
    step and the caches."""
    cfg, jp = _weights()
    _, enc = _reference_enc()
    tokens = _tokens(cfg, seed=5)
    jmodel = j_get_model(cfg)
    jcache = _cross_cache(cfg, jp, enc, jmodel.init_cache(2, S),
                          jwhisper._project, jnp.float32, jnp.stack)
    pcfg, pp = _port()
    model = get_model(pcfg)
    cache = _cross_cache(pcfg, pp, T(enc),
                         model.init_cache(2, S, device="cpu"),
                         pwhisper._project, torch.float32, torch.stack)
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    step = jax.jit(jmodel.decode_step)
    for t in range(S):
        want, jcache = step(jp, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = model.decode_step(pp, cache, T(tokens[:, t:t + 1]), t)
        _close(got, want, 1e-4, f"step {t}")
    for k in jcache:
        _close(cache[k], jcache[k], 1e-4, k)


def test_decode_matches_prefill():
    """The port's own contract: step decode over the cached cross K / V
    against the prefill's last logits (flash's plain version)."""
    pcfg, pp = _port()
    model = get_model(pcfg)
    frames = T(_frames(pcfg, seed=6))
    tokens = T(_tokens(pcfg, seed=7), dtype=torch.int64)
    full = model.prefill(pp, {"frames": frames, "tokens": tokens})
    with torch.no_grad():
        enc = pwhisper.encode(pcfg, pp, frames)
        cache = _cross_cache(pcfg, pp, enc, model.init_cache(2, S,
                                                             device="cpu"),
                             pwhisper._project, torch.float32, torch.stack)
    for t in range(S):
        logits, cache = model.decode_step(pp, cache, tokens[:, t:t + 1], t)
    assert float((logits - full).abs().max()) < 2e-4


def test_bf16_compute_keeps_norms_and_gives_the_same_bits():
    """Under bf16 compute (whisper-base's) the layer norms, the encoder's
    and decoder's final norms and the cross-attention norm stay f32, and
    serving on the cast tree gives the bits of casting at every use."""
    pcfg, pp = _port(pconfigs.reduced(ARCH).replace(compute_dtype="bfloat16"))
    model = get_model(pcfg)
    cast = model.compute_params(pp)
    for path, w in flatten(cast).items():
        norm = any(p in ("ln1", "ln2", "ln_x", "enc_ln", "dec_ln")
                   for p in path)
        assert w.dtype == (torch.float32 if norm else torch.bfloat16), path
    batch = {"frames": T(_frames(pcfg)), "tokens": T(_tokens(pcfg))}
    assert torch.equal(model.prefill(pp, batch), model.prefill(cast, batch))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _batch(cfg, masked: bool, seed: int = 8) -> dict:
    rng = np.random.default_rng(seed)
    out = {"frames": rng.standard_normal((2, cfg.enc_seq, cfg.d_model))
           .astype(np.float32),
           "tokens": rng.integers(0, cfg.vocab, (2, S), dtype=np.int32),
           "labels": rng.integers(0, cfg.vocab, (2, S), dtype=np.int32)}
    if masked:
        out["mask"] = (rng.random((2, S)) < 0.7).astype(np.float32)
    return out


@pytest.mark.parametrize("masked", [False, True])
def test_loss_and_grads_match_reference(masked):
    cfg, jp = _weights()
    batch = _batch(cfg, masked)
    wl, wg = jax.jit(jax.value_and_grad(j_get_model(cfg).loss))(jp, batch)
    pcfg, pp = _port()
    params = pstep.trainable(pp)
    loss = get_model(pcfg).loss(params, {k: T(v) for k, v in batch.items()})
    paths, leaves = zip(*sorted(flatten(params).items()))
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss.detach()), float(wl), rtol=1e-4)
    want = flatten(jax.tree.map(np.asarray, wg))
    assert sorted(grads) == sorted(want)
    for path, w in want.items():
        scale = float(np.abs(w).max())
        if scale == 0:            # the unused rows of dec_pos have none
            assert float(grads[path].abs().max()) == 0, path
            continue
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


def test_train_step_matches_reference():
    cfg, _ = _weights()
    jmodel = j_get_model(cfg)
    jtc = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT))
    jst = jstep.init_train_state(jmodel, jax.random.PRNGKey(0), jtc)
    batch = _batch(cfg, False)
    jst2, jm = jax.jit(jstep.make_train_step(jmodel, jtc))(jst, batch)
    ptc = pstep.TrainConfig(opt=popt.AdamWConfig(**OPT))
    pst = pstep.new_train_state(
        params_from_numpy(jax.tree.map(np.asarray, jst.params), "cpu"), ptc)
    pst2, pm = pstep.make_train_step(get_model(pconfigs.reduced(ARCH)), ptc)(
        pst, {k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert np.float32(pm["lr"]) == np.float32(jm["lr"])
    new = flatten(jax.tree.map(np.asarray, jst2.params))
    for path, p in flatten(pst2.params).items():
        np.testing.assert_allclose(p.detach().numpy(), new[path], rtol=0,
                                   atol=2.5 * LR, err_msg=str(path))
