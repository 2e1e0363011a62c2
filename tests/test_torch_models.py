"""The port's serving path of the model substrate against the reference.

One set of weights, made by the reference package from a seed and carried
across with `models/convert.py`, and token / activation inputs made with
numpy seeds go through both packages on the CPU.  The reference takes its
Pallas kernels in interpret mode (`use_pallas=True`, `attn_impl="flash"`)
or its jnp paths; the port takes the plain versions of its kernels (CPU
tensors).  Tolerances: 1e-4 for outputs and decode state (the reference's
own tolerance between its kernels and its jnp paths), 2e-4 for the port's
decode-vs-prefill contract (tests/test_decode_consistency.py's).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import hybrid as jhybrid
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.models.registry import get_model as j_get_model
import repro_torch.configs as pconfigs
from repro_torch.models import get_model, layers as PL, ssm as pssm
from repro_torch.models.convert import params_from_numpy, params_to_numpy

torch.set_num_threads(1)
T = torch.tensor
ARCHS = ("zamba2-7b", "mamba2-2.7b")
S = 64          # two SSD chunks of the reduced configs
DECODE = 16


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _weights(arch_id: str):
    """(reduced config, reference params as numpy) from PRNGKey(0)."""
    cfg = jconfigs.reduced(arch_id)
    return cfg, _np_tree(j_get_model(cfg).init(jax.random.PRNGKey(0)))


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _assert_tree_close(got: dict, want: dict, tol: float, what: str):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_tree_close(got[k], want[k], tol, f"{what}.{k}")
        else:
            g = got[k].detach().float().numpy() if torch.is_tensor(got[k]) \
                else got[k]
            np.testing.assert_allclose(g, np.asarray(want[k], np.float32),
                                       rtol=tol, atol=tol, err_msg=f"{what}.{k}")


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", list(jconfigs.ARCH_IDS))
def test_configs_equal_field_for_field(arch_id):
    for get in ("get_config", "reduced"):
        want = dataclasses.asdict(getattr(jconfigs, get)(arch_id))
        got = dataclasses.asdict(getattr(pconfigs, get)(arch_id))
        assert got == want, (arch_id, get)
    assert pconfigs.SHAPES == {k: pconfigs.ShapeCell(*dataclasses.astuple(v))
                               for k, v in jconfigs.SHAPES.items()}


@pytest.mark.parametrize("arch_id", list(jconfigs.ARCH_IDS))
def test_param_defs_and_cache_shapes_match_reference(arch_id):
    """`get_model` serves every family of the reference: at the full and
    the reduced config its parameter table has the reference's leaves
    (shape, init, scale) and its decode cache the reference's shapes and
    types, without allocating either."""
    for get in ("get_config", "reduced"):
        jm = j_get_model(getattr(jconfigs, get)(arch_id))
        pm = get_model(getattr(pconfigs, get)(arch_id))
        want = {path: (d.shape, d.init, d.scale, d.dtype)
                for path, d in PL.flatten(
                    jax.tree.map(lambda d: {"_": d}, jm.param_defs,
                                 is_leaf=lambda d: isinstance(
                                     d, JL.ParamDef))).items()}
        got = {path + ("_",): (d.shape, d.init, d.scale, d.dtype)
               for path, d in PL.flatten(pm.param_defs).items()}
        assert got == want, (arch_id, get)
        jc, pc = jm.cache_shape(2, 16), pm.cache_shape(2, 16)
        assert {k: (tuple(v.shape), jnp.dtype(v.dtype).name)
                for k, v in jc.items()} == \
            {k: (v.shape, str(v.dtype).removeprefix("torch."))
             for k, v in pc.items()}, (arch_id, get)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_param_trees_match_and_round_trip(arch_id):
    cfg, jp = _weights(arch_id)
    model = get_model(pconfigs.reduced(arch_id))
    pp = params_from_numpy(jp, device="cpu")
    own = model.init(torch.Generator().manual_seed(0), device="cpu")
    flat_ref, flat_port = PL.flatten(jp), PL.flatten(pp)
    assert set(flat_port) == set(flat_ref) == set(PL.flatten(own))
    for path, a in flat_ref.items():
        assert tuple(flat_port[path].shape) == a.shape, path
        assert tuple(PL.flatten(own)[path].shape) == a.shape, path
        assert flat_port[path].dtype == torch.float32, path
    back = params_to_numpy(pp)
    for path, a in PL.flatten(back).items():
        np.testing.assert_array_equal(a, flat_ref[path], err_msg=str(path))


def test_bf16_leaves_cross_bit_for_bit():
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(2), (5, 7),
                                     jnp.bfloat16))
    got = params_from_numpy({"w": x}, device="cpu")["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), x.astype(np.float32))
    np.testing.assert_array_equal(params_to_numpy({"w": got})["w"],
                                  x.view(np.uint16))


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _ssd_inputs(seed, s=48):
    rng = np.random.default_rng(seed)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("chunk", [4, 8, 16, 24, 48])
def test_ssd_scan_matches_reference(chunk):
    args = _ssd_inputs(chunk)
    y_ref, st_ref = jssm.ssd_scan(*args, chunk=chunk, use_pallas=True)
    y, st = pssm.ssd_scan(*(T(x) for x in args), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4,
                               atol=1e-4)


def test_ssd_scan_matches_sequential_oracle():
    from repro_torch.kernels import ref
    x, dt, a, bm, cm = (T(v) for v in _ssd_inputs(7, s=64))
    y, _ = pssm.ssd_scan(x, dt, a, bm, cm, chunk=16)
    want = torch.stack([ref.ssd_chunk(x[i], dt[i], a, bm[i], cm[i])
                        for i in range(x.shape[0])])
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-4, atol=1e-4)


def _layer0(tree):
    return jax.tree.map(lambda a: a[0], tree)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("arch_id", ARCHS)
def test_mamba2_block_matches_reference(arch_id, use_pallas):
    cfg, jp = _weights(arch_id)
    stack = jp["groups"] if "groups" in jp else jp["layers"]
    lp = _layer0(_layer0(stack) if "groups" in jp else stack)["mix"]
    u = (np.random.default_rng(4).standard_normal((2, S, cfg.d_model))
         * 0.5).astype(np.float32)
    want = jssm.mamba2_block(cfg, lp, u, use_pallas=use_pallas)
    got = pssm.mamba2_block(pconfigs.reduced(arch_id),
                            params_from_numpy(lp, device="cpu"), T(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("attn_impl", ["flash", "xla"])
def test_attention_matches_reference(attn_impl):
    cfg, jp = _weights("zamba2-7b")
    ap = jp["shared"]["attn"]
    x = (np.random.default_rng(5).standard_normal((2, S, cfg.d_model))
         * 0.5).astype(np.float32)
    pos = np.arange(S)[None, :]
    want = JL.attention(cfg.replace(attn_impl=attn_impl), ap, x, pos)
    got = PL.attention(pconfigs.reduced("zamba2-7b"),
                       params_from_numpy(ap, device="cpu"), T(x), T(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# whole models: prefill and decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch_id", ARCHS)
def test_prefill_matches_reference(arch_id):
    cfg, jp = _weights(arch_id)
    tokens = _tokens(cfg, 2, S)
    jcfg = cfg.replace(attn_impl="flash")
    logits_fn = jhybrid.hybrid_logits if cfg.family == "hybrid" \
        else jssm.ssm_logits
    want = logits_fn(jcfg, jp, tokens, use_pallas=True, last_only=True)
    model = get_model(pconfigs.reduced(arch_id))
    got = model.prefill(params_from_numpy(jp, device="cpu"),
                        {"tokens": T(tokens, dtype=torch.int64)})
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_steps_match_reference(arch_id):
    cfg, jp = _weights(arch_id)
    tokens = _tokens(cfg, 2, DECODE, seed=2)
    jmodel = j_get_model(cfg)
    jcache = jmodel.init_cache(2, DECODE)
    jstep = jax.jit(jmodel.decode_step)
    model = get_model(pconfigs.reduced(arch_id))
    params = params_from_numpy(jp, device="cpu")
    cache = model.init_cache(2, DECODE, device="cpu")
    tt = T(tokens, dtype=torch.int64)
    for t in range(DECODE):
        want, jcache = jstep(jp, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = model.decode_step(params, cache, tt[:, t:t + 1], t)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"step {t}")
    _assert_tree_close(cache, _np_tree(jcache), 1e-4, "cache")


@pytest.mark.parametrize("arch_id", ARCHS)
def test_decode_matches_prefill(arch_id):
    """The serving contract: S decode steps from an empty cache end on the
    prefill's last logits (two SSD chunks, so the inter-chunk state too)."""
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


def test_compute_params_give_the_same_bits():
    """A bf16-compute model on weights cast once equals the same model
    casting at every use."""
    cfg = pconfigs.reduced("zamba2-7b").replace(compute_dtype="bfloat16")
    model = get_model(cfg)
    params = model.init(torch.Generator().manual_seed(1), device="cpu")
    cast = model.compute_params(params)
    assert cast["groups"]["mix"]["in_x"].dtype == torch.bfloat16
    assert cast["groups"]["mix"]["a_log"].dtype == torch.float32
    assert cast["shared"]["ln1"]["w"].dtype == torch.float32
    tokens = T(_tokens(cfg, 2, S, seed=4), dtype=torch.int64)
    a = model.prefill(params, {"tokens": tokens})
    b = model.prefill(cast, {"tokens": tokens})
    assert torch.equal(a, b)



