"""The port's dense and VLM decoders (models/transformer.py) against the
reference's.

qwen2, stablelm, gemma2, gemma3 and paligemma at their reduced configs: one
set of weights, made by the reference package from PRNGKey(0) and carried
across with `models/convert.py`, and tokens and patch embeddings made with
numpy seeds go through both packages on the CPU.  The reference's dense
layers take its blockwise softmax (they ignore `attn_impl`); the port's
take flash attention's plain version on a global layer without softcap and
the blockwise softmax otherwise, so the comparison holds one route against
the other.  Tolerances: 1e-4 for logits and caches (the reference's own
between its kernels and its jnp paths), 2e-4 for the port's
decode-vs-prefill contract (tests/test_decode_consistency.py's).
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
from repro.models import transformer as jtransformer
from repro.models.registry import get_model as j_get_model
import repro_torch.configs as pconfigs
from repro_torch.models import get_model, layers as PL
from repro_torch.models import transformer as ptransformer
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
T = torch.tensor
ARCHS = ("qwen2-1.5b", "stablelm-1.6b", "gemma2-2b", "gemma3-4b",
         "paligemma-3b")
S = 32          # four windows of the reduced gemmas' 8
DECODE = 16
# flash launches of one prefill by the dispatch rule (a global layer
# without softcap): every layer of qwen2, stablelm and paligemma, gemma3's
# one global layer of six, none of gemma2's (softcapped)
FLASH_CALLS = {"qwen2-1.5b": 2, "stablelm-1.6b": 2, "gemma2-2b": 0,
               "gemma3-4b": 1, "paligemma-3b": 2}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _weights(arch_id: str):
    """(reduced config, reference params as numpy) from PRNGKey(0)."""
    cfg = jconfigs.reduced(arch_id)
    return cfg, _np_tree(j_get_model(cfg).init(jax.random.PRNGKey(0)))


def _port(arch_id: str):
    """(the port's model, the reference's weights as CPU tensors)."""
    _, jp = _weights(arch_id)
    return (get_model(pconfigs.reduced(arch_id)),
            params_from_numpy(jp, device="cpu"))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _patches(cfg, b, seed=5):
    return (np.random.default_rng(seed).standard_normal(
        (b, cfg.n_frontend_tokens, cfg.frontend_dim)) * 0.5).astype(
            np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# weights and the per-layer pattern
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_trees_match_and_round_trip(arch_id):
    """The port's tree has the reference's leaves (vision_proj, the QKV
    biases, gemma's post norms), and the reference's weights cross both
    ways bit for bit."""
    _, jp = _weights(arch_id)
    model, pp = _port(arch_id)
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_ref, flat_port = PL.flatten(jp), PL.flatten(pp)
    assert set(flat_port) == set(flat_ref) == set(PL.flatten(own))
    for path, a in flat_ref.items():
        assert tuple(PL.flatten(own)[path].shape) == a.shape, path
        assert flat_port[path].dtype == torch.float32, path
    for path, a in PL.flatten(params_to_numpy(pp)).items():
        np.testing.assert_array_equal(a, flat_ref[path], err_msg=str(path))


@pytest.mark.parametrize("arch_id", ARCHS)
def test_layer_window_matches_reference(arch_id):
    for get in ("get_config", "reduced"):
        cfg = getattr(pconfigs, get)(arch_id)
        want = [int(JL.layer_window(cfg, jnp.int32(i)))
                for i in range(cfg.n_layers)]
        assert [PL.layer_window(cfg, i) for i in range(cfg.n_layers)] == \
            want, (arch_id, get)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("window", [0, 8])
def test_attention_traced_window_matches_reference(window, softcap):
    """Each route of the dispatch: flash's plain version (window 0, no
    softcap) and the blockwise softmax with a window, a softcap or both,
    against the reference's traced-window attention."""
    cfg, jp = _weights("gemma2-2b")
    cfg = cfg.replace(attn_softcap=softcap, attn_block=8)
    ap = jax.tree.map(lambda a: a[1], jp["layers"]["attn"])
    x = (np.random.default_rng(6).standard_normal((2, S, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.arange(S)[None, :]
    want = JL.attention_traced_window(cfg, ap, x, pos, jnp.int32(window))
    got = PL.attention_traced_window(cfg, params_from_numpy(ap, device="cpu"),
                                     T(x), T(pos), window)
    _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("last_only", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_logits_match_reference(arch_id, last_only):
    cfg, jp = _weights(arch_id)
    tokens = _tokens(cfg, 2, S)
    want = jtransformer.dense_logits(cfg, jp, tokens, last_only=last_only)
    model, pp = _port(arch_id)
    tt = T(tokens, dtype=torch.int64)
    got = (model.prefill(pp, {"tokens": tt}) if last_only
           else ptransformer.dense_logits(model.cfg, pp, tt))
    assert got.shape == want.shape and got.dtype == torch.float32
    _close(got, want, 1e-4)


@pytest.mark.parametrize("last_only", [True, False])
def test_vlm_prefill_with_patch_embeds(last_only):
    """paligemma's prefix: patches projected, scaled by sqrt(d) and
    prepended; the full logits drop their positions."""
    cfg, jp = _weights("paligemma-3b")
    tokens, patches = _tokens(cfg, 2, S, seed=7), _patches(cfg, 2)
    want = jtransformer.dense_logits(cfg, jp, tokens, patches,
                                     last_only=last_only)
    model, pp = _port("paligemma-3b")
    tt = T(tokens, dtype=torch.int64)
    if last_only:
        got = model.prefill(pp, {"tokens": tt, "patch_embeds": T(patches)})
    else:
        got = ptransformer.dense_logits(model.cfg, pp, tt, T(patches))
    assert got.shape == want.shape == (2, 1 if last_only else S,
                                       cfg.padded_vocab)
    _close(got, want, 1e-4)
    # the patches reach the text: the same tokens without them differ
    text = model.prefill(pp, {"tokens": tt})
    assert float((text - got[:, -1:]).abs().max()) > 1e-4


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_steps_match_reference(arch_id):
    cfg, jp = _weights(arch_id)
    tokens = _tokens(cfg, 2, DECODE, seed=2)
    jmodel = j_get_model(cfg)
    jcache = jmodel.init_cache(2, DECODE)
    jstep = jax.jit(jmodel.decode_step)
    model, pp = _port(arch_id)
    cache = model.init_cache(2, DECODE, device="cpu")
    tt = T(tokens, dtype=torch.int64)
    for t in range(DECODE):
        want, jcache = jstep(jp, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = model.decode_step(pp, cache, tt[:, t:t + 1], t)
        _close(got, want, 1e-4, f"step {t}")
    for k in ("k", "v"):
        _close(cache[k], _np_tree(jcache)[k], 1e-4, k)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_matches_prefill(arch_id):
    """The serving contract (text only for the VLM): S decode steps from an
    empty cache end on the prefill's last logits, through every window
    (S is four of the reduced gemmas' windows)."""
    model = get_model(pconfigs.reduced(arch_id))
    params = model.init(torch.Generator().manual_seed(0), device="cpu")
    tokens = T(_tokens(model.cfg, 2, S, seed=3), dtype=torch.int64)
    full = model.prefill(params, {"tokens": tokens})
    cache = model.init_cache(2, S, device="cpu")
    for t in range(S):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
    err = float((logits - full).abs().max())
    assert err < 2e-4, err


def test_gemma_local_window_masks():
    """A token outside every local window still reaches the global layers:
    gemma2's alternating pattern differs from an all-global model beyond
    the window and equals it within (test_decode_consistency.py's check)."""
    model, pp = _port("gemma2-2b")
    cfg = model.cfg
    tokens = T(_tokens(cfg, 1, S, seed=8), dtype=torch.int64)
    local = ptransformer.dense_logits(cfg, pp, tokens)
    glob = ptransformer.dense_logits(
        cfg.replace(local_pattern=0, sliding_window=0), pp, tokens)
    w = cfg.sliding_window
    assert float((local[:, :w] - glob[:, :w]).abs().max()) < 1e-4
    assert float((local[:, -1] - glob[:, -1]).abs().max()) > 1e-6


@pytest.mark.parametrize("arch_id", ARCHS)
def test_flash_calls_follow_the_dispatch_rule(arch_id, monkeypatch):
    """A prefill calls `ops.flash_attention` once a global layer without
    softcap (the kernel's launches on the card), and decode never."""
    calls = []
    real = PL.ops.flash_attention

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(PL.ops, "flash_attention", counted)
    model, pp = _port(arch_id)
    tokens = T(_tokens(model.cfg, 2, 8, seed=4), dtype=torch.int64)
    model.prefill(pp, {"tokens": tokens})
    assert len(calls) == FLASH_CALLS[arch_id]
    cache = model.init_cache(2, 8, device="cpu")
    model.decode_step(pp, cache, tokens[:, :1], 0)
    assert len(calls) == FLASH_CALLS[arch_id]


@pytest.mark.parametrize("arch_id", ARCHS)
def test_compute_params_give_the_same_bits(arch_id):
    """bf16 compute on weights cast once equals the same model casting at
    every use; norm weights (gemma's post norms too) stay f32.  Every leaf
    is drawn at random, so a norm weight cast to bf16 would show."""
    cfg = pconfigs.reduced(arch_id).replace(compute_dtype="bfloat16")
    model = get_model(cfg)
    gen = torch.Generator().manual_seed(2)
    params = PL.tree_map(
        lambda t: torch.randn(t.shape, generator=gen) * 0.2,
        model.init(torch.Generator().manual_seed(1), device="cpu"))
    cast = model.compute_params(params)
    for path, w in PL.flatten(cast).items():
        norm = any(p in PL._NORMS for p in path)
        assert w.dtype == (torch.float32 if norm else torch.bfloat16), path
    tokens = T(_tokens(cfg, 2, 16, seed=4), dtype=torch.int64)
    batch = {"tokens": tokens}
    if cfg.family == "vlm":
        batch["patch_embeds"] = T(_patches(cfg, 2))
    assert torch.equal(model.prefill(params, batch),
                       model.prefill(cast, batch))
