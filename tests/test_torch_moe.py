"""The port's MoE decoders (models/moe.py) against the reference's.

qwen3-moe (GQA, routed experts only) and deepseek-v2 (MLA, a dense first
layer, shared experts) at their reduced configs, through both dispatch
modes ("einsum", the GShard one-hot dispatch both configs use, and
"sort"): one set of weights, made by the reference package from
PRNGKey(0) and carried across with `models/convert.py`, and inputs made
with numpy seeds go through both packages on the CPU.  The reference's
attention takes its blockwise softmax; the port's serving path takes flash
attention's plain version (MLA's v zero-padded to the q / k width), its
loss the blockwise softmax.

Routing is a discrete choice made from f32 values: the tests compare the
top-k indices exactly where the k-th and (k+1)-th router probabilities of
every token are further apart than `TIE_MARGIN` (asserted, so a near tie
shows as a failed margin, not as a flipped expert), then the outputs
within tolerance.  Tolerances: 1e-4 for layer outputs, logits and caches,
1e-5 for the aux loss, 2e-4 for the port's decode-vs-prefill contract
(tests/test_decode_consistency.py's, at its capacity factor 8), rtol 1e-4
for the loss and each gradient leaf (atol 1e-4 x the leaf's scale).
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
from repro.models import moe as jmoe
from repro.models.registry import get_model as j_get_model
from repro.train import optimizer as jopt
from repro.train import step as jstep
import repro_torch.configs as pconfigs
from repro_torch.models import get_model, layers as PL, moe as pmoe
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import flatten
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep

torch.set_num_threads(1)
T = torch.tensor
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
DISPATCH = ("einsum", "sort")
S = 32
DECODE = 16
# the least gap between the k-th and (k+1)-th router probability of any
# token for which the tests compare expert choices exactly
TIE_MARGIN = 1e-6
LR = 1e-3
OPT = dict(lr=LR, warmup_steps=1, total_steps=10)


def _cfgs(arch: str, **moe_kw):
    """(reference config, port config): the reduced config with the MoE
    fields `moe_kw` replaced."""
    out = []
    for mod in (jconfigs, pconfigs):
        cfg = mod.reduced(arch)
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights(arch: str, param_dtype: str = "float32"):
    """The reference's params (numpy) from PRNGKey(0)."""
    cfg = jconfigs.reduced(arch).replace(param_dtype=param_dtype)
    return jax.tree.map(np.asarray, j_get_model(cfg).init(
        jax.random.PRNGKey(0)))


def _port_params(arch: str, param_dtype: str = "float32"):
    return params_from_numpy(_weights(arch, param_dtype), device="cpu")


def _tokens(cfg, b, s, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _x(cfg, b, s, seed=3):
    return (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
            * 0.5).astype(np.float32)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _moe_params(arch: str):
    """Layer 0's MoE parameters: (reference numpy, port tensors)."""
    jp = jax.tree.map(lambda a: a[0], _weights(arch)["layers"]["moe"])
    return jp, params_from_numpy(jp, device="cpu")


def _assert_routes_match(jcfg, jp, pp, x):
    """The port's top-k experts equal the reference's, every token's k-th
    and (k+1)-th probabilities at least TIE_MARGIN apart."""
    k = jcfg.moe.top_k
    probs = jax.nn.softmax(jnp.einsum("...d,de->...e", x, jp["router"]))
    top = np.asarray(jax.lax.top_k(probs, k + 1)[0])
    margin = float((top[..., k - 1] - top[..., k]).min())
    assert margin > TIE_MARGIN, f"near tie in the routing: {margin}"
    want = np.asarray(jax.lax.top_k(probs, k)[1])
    _, _, got = pmoe._route(jcfg, pp, T(x))
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# weights, capacity, casts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_trees_match_and_round_trip(arch, param_dtype):
    """The port's tree has the reference's leaves (the router, MLA's
    low-rank projections and norms, deepseek's dense first layer and shared
    experts), types and shapes, and the weights cross both ways bit for
    bit."""
    jp = _weights(arch, param_dtype)
    cfg = pconfigs.reduced(arch).replace(param_dtype=param_dtype)
    own = get_model(cfg).init(torch.Generator().manual_seed(0), device="cpu")
    pp = _port_params(arch, param_dtype)
    flat_ref, flat_own = PL.flatten(jp), PL.flatten(own)
    assert set(PL.flatten(pp)) == set(flat_ref) == set(flat_own)
    for path, a in flat_ref.items():
        assert tuple(flat_own[path].shape) == a.shape, path
        assert flat_own[path].dtype == PL.dtype_of(param_dtype), path
    for path, a in PL.flatten(params_to_numpy(pp)).items():
        want = flat_ref[path]
        if want.dtype.name == "bfloat16":      # the port hands out the bits
            want = want.view(np.uint16)
        np.testing.assert_array_equal(a, want, err_msg=str(path))


def test_capacity_matches_reference():
    for arch in ("qwen3-moe-235b-a22b", "deepseek-v2-236b"):
        for get in ("get_config", "reduced"):
            for cf in (0.5, 1.0, 1.25, 1.5, 8.0, 16.0, 27.0):
                jcfg = getattr(jconfigs, get)(arch)
                pcfg = getattr(pconfigs, get)(arch)
                jcfg = jcfg.replace(moe=dataclasses.replace(
                    jcfg.moe, capacity_factor=cf))
                pcfg = pcfg.replace(moe=dataclasses.replace(
                    pcfg.moe, capacity_factor=cf))
                for gs in (None, 1, 2, 7, 64, 512):
                    assert pmoe._capacity(pcfg, gs) == \
                        jmoe._capacity(jcfg, gs), (arch, get, cf, gs)


def test_compute_params_keep_router_and_norms_f32():
    """Under a bf16 compute type the router (read in f32 by the reference)
    and MLA's norms stay f32; the matrices are cast once; serving on the
    cast tree gives the same bits as casting at every use."""
    cfg = pconfigs.reduced("deepseek-v2-236b").replace(
        compute_dtype="bfloat16")
    model = get_model(cfg)
    params = _port_params("deepseek-v2-236b")
    cast = model.compute_params(params)
    assert cast["layers"]["moe"]["router"].dtype == torch.float32
    assert cast["layers"]["attn"]["kv_norm"].dtype == torch.float32
    assert cast["layers"]["attn"]["q_norm"].dtype == torch.float32
    assert cast["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    assert cast["layers"]["attn"]["wkv_b"].dtype == torch.bfloat16
    tokens = T(_tokens(cfg, 2, S), dtype=torch.int64)
    assert torch.equal(model.prefill(params, {"tokens": tokens}),
                       model.prefill(cast, {"tokens": tokens}))


def test_bf16_init_draws_slabs_into_the_final_type():
    """A bf16 leaf is drawn a few leading-axis slabs at a time into a bf16
    tensor (no f32 copy of the whole leaf); f32 leaves keep one draw."""
    gen = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    d = PL.ParamDef((3, 8, 4))
    got = PL._init_leaf(gen(), d, "float32", "cpu")
    std = 1.0 / np.sqrt(8)
    want = torch.randn((3, 8, 4), generator=gen()).mul_(std)
    assert torch.equal(got, want)
    old = PL._INIT_CHUNK
    try:
        PL._INIT_CHUNK = 32             # one slab a draw
        got = PL._init_leaf(gen(), d, "bfloat16", "cpu")
    finally:
        PL._INIT_CHUNK = old
    g = gen()
    want = torch.stack([torch.randn((8, 4), generator=g).mul_(std)
                        .to(torch.bfloat16) for _ in range(3)])
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)


# ---------------------------------------------------------------------------
# the MoE FFN: both dispatch modes, capacity drops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_matches_reference(arch, dispatch):
    jcfg, pcfg = _cfgs(arch, dispatch=dispatch)
    jp, pp = _moe_params(arch)
    x = _x(jcfg, 2, S)
    _assert_routes_match(jcfg, jp, pp, x)
    want, waux = jmoe.moe_ffn(jcfg, jp, x)
    got, gaux = pmoe.moe_ffn(pcfg, pp, T(x))
    _close(got, want, 1e-4)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_drops_match_reference(arch, dispatch):
    """Capacity factor 0.5 drops tokens at prefill (capacity 8 a group of
    64 against a mean load of 16); the output moves from the undropped
    one, in both packages alike."""
    jcfg, pcfg = _cfgs(arch, dispatch=dispatch, capacity_factor=0.5)
    jp, pp = _moe_params(arch)
    x = _x(jcfg, 2, S)
    want, _ = jmoe.moe_ffn(jcfg, jp, x)
    got, _ = pmoe.moe_ffn(pcfg, pp, T(x))
    _close(got, want, 1e-4)
    full, _ = pmoe.moe_ffn(_cfgs(arch, dispatch=dispatch,
                                 capacity_factor=8.0)[1], pp, T(x))
    assert float((got - full).abs().max()) > 1e-3


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_drops_match_reference(arch, dispatch):
    """At decode a group is the batch: 2 tokens x top-2 of 8 experts at
    capacity factor 1.5 leave one slot an expert.  Two equal rows pick the
    same experts, so the second row's are dropped: its output is the
    shared experts' (or zero), the first row's is not."""
    jcfg, pcfg = _cfgs(arch, dispatch=dispatch)
    assert pmoe._capacity(pcfg, 2) == 1
    jp, pp = _moe_params(arch)
    x = np.repeat(_x(jcfg, 1, 1), 2, axis=0)
    want, _ = jmoe.moe_ffn(jcfg, jp, x)
    got, _ = pmoe.moe_ffn(pcfg, pp, T(x))
    _close(got, want, 1e-4)
    assert float((got[0] - got[1]).abs().max()) > 1e-3


def test_sort_combine_is_the_reference_scatter_order():
    """The sort dispatch's gathered combine gives the bits of the
    reference's scatter-add (XLA's, jitted: one rounding an update, in
    update order) over the same [E * C] slots, in f32 and bf16, at top-3 of
    8 experts (with two terms a token the order could not show).  PyTorch's
    `index_add_` is no stand-in: on the CPU in bf16 it adds in f32 and
    rounds once."""
    _, pp = _moe_params("qwen3-moe-235b-a22b")
    for cdt in ("float32", "bfloat16"):
        _, pcfg = _cfgs("qwen3-moe-235b-a22b", dispatch="sort", top_k=3)
        pcfg = pcfg.replace(compute_dtype=cdt)
        dt = PL.dtype_of(cdt)
        m = pcfg.moe
        x = T(_x(pcfg, 2, S))
        t, d = x.shape[0] * x.shape[1], pcfg.d_model
        got, _ = pmoe.moe_ffn(pcfg, pp, x)
        # the reference's dispatch: slots in stable expert order, the first
        # C of an expert kept; an unused slot reads token 0 with weight 0
        _, gate_vals, gate_idx = pmoe._route(pcfg, pp, x.reshape(t, d))
        e_flat = gate_idx.reshape(-1)
        order = torch.argsort(e_flat, stable=True)
        c = max(int(t * m.top_k * m.capacity_factor / m.n_experts), 1)
        e_sorted = e_flat[order]
        starts = torch.searchsorted(e_sorted, torch.arange(m.n_experts))
        rank = torch.arange(t * m.top_k) - starts[e_sorted]
        keep = rank < c
        slot = (e_sorted * c + rank)[keep]
        tok = torch.zeros(m.n_experts * c, dtype=torch.int64)
        tok[slot] = (order // m.top_k)[keep]
        w = torch.zeros(m.n_experts * c)
        w[slot] = gate_vals.reshape(-1)[order][keep]
        xe = x.reshape(t, d).to(dt)[tok].reshape(m.n_experts, c, d)
        ye = pmoe._experts(pcfg, pp, xe, dt).reshape(-1, d) * w[:, None].to(dt)
        jdt = jnp.bfloat16 if cdt == "bfloat16" else jnp.float32
        want = jax.jit(lambda y, i: jnp.zeros((t, d), jdt).at[i].add(y))(
            jnp.asarray(ye.float().numpy()).astype(jdt), tok.numpy())
        np.testing.assert_array_equal(got.reshape(t, d).float().numpy(),
                                      np.asarray(want, np.float32), cdt)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_params():
    jp = jax.tree.map(lambda a: a[0],
                      _weights("deepseek-v2-236b")["layers"]["attn"])
    return jp, params_from_numpy(jp, device="cpu")


@pytest.mark.parametrize("use_kernels", [True, False])
def test_mla_attention_matches_reference(use_kernels):
    """The expanded form: flash's plain version over v padded to the q / k
    width (serving) and the blockwise softmax (the loss's)."""
    jcfg, pcfg = _cfgs("deepseek-v2-236b")
    jp, pp = _mla_params()
    x = _x(jcfg, 2, S)
    pos = np.arange(S)[None, :]
    want = jmoe.mla_attention(jcfg, jp, x, pos)
    got = pmoe.mla_attention(pcfg, pp, T(x), T(pos), use_kernels)
    _close(got, want, 1e-4)


def test_mla_decode_matches_reference():
    """The absorbed form over the latent and rope-key caches, step by step:
    the output and both caches."""
    jcfg, pcfg = _cfgs("deepseek-v2-236b")
    jp, pp = _mla_params()
    m = jcfg.mla
    xs = _x(jcfg, 2, DECODE, seed=4)
    jck = jnp.zeros((2, DECODE, m.kv_lora_rank))
    jkr = jnp.zeros((2, DECODE, m.rope_head_dim))
    pck, pkr = torch.zeros(jck.shape), torch.zeros(jkr.shape)
    step = jax.jit(lambda x, ck, kr, pos: jmoe.mla_decode(jcfg, jp, x, ck, kr,
                                                          pos))
    for t in range(DECODE):
        want, jck, jkr = step(xs[:, t:t + 1], jck, jkr, jnp.int32(t))
        got, pck, pkr = pmoe.mla_decode(pcfg, pp, T(xs[:, t:t + 1]), pck,
                                        pkr, t)
        _close(got, want, 1e-4, f"step {t}")
    _close(pck, jck, 1e-4, "ckv cache")
    _close(pkr, jkr, 1e-4, "kr cache")


# ---------------------------------------------------------------------------
# whole models: prefill, decode, contract
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _reference_logits(arch: str, dispatch: str):
    jcfg, _ = _cfgs(arch, dispatch=dispatch)
    tokens = _tokens(jcfg, 2, S)
    logits, aux = jax.jit(lambda p, t: jmoe.moe_logits(jcfg, p, t))(
        _weights(arch), tokens)
    return tokens, np.asarray(logits), float(aux)


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_logits_match_reference(arch, dispatch):
    tokens, want, waux = _reference_logits(arch, dispatch)
    _, pcfg = _cfgs(arch, dispatch=dispatch)
    model = get_model(pcfg)
    pp = _port_params(arch)
    got, gaux = pmoe.moe_logits(pcfg, pp, T(tokens))
    _close(got, want, 1e-4)
    np.testing.assert_allclose(float(gaux), waux, rtol=1e-5)
    last = model.prefill(pp, {"tokens": T(tokens)})
    _close(last, want[:, -1:], 1e-4, "prefill")


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_reference(arch, dispatch):
    """16 decode steps from an empty cache: logits every step and the
    caches (MLA's latent and rope keys, deepseek's dense-layer caches)."""
    jcfg, pcfg = _cfgs(arch, dispatch=dispatch)
    jmodel, model = j_get_model(jcfg), get_model(pcfg)
    jp, pp = _weights(arch), _port_params(arch)
    tokens = _tokens(jcfg, 2, DECODE, seed=2)
    jcache = jmodel.init_cache(2, DECODE)
    cache = model.init_cache(2, DECODE, device="cpu")
    assert {k: tuple(v.shape) for k, v in cache.items()} == \
        {k: v.shape for k, v in jcache.items()}
    step = jax.jit(jmodel.decode_step)
    for t in range(DECODE):
        want, jcache = step(jp, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = model.decode_step(pp, cache, T(tokens[:, t:t + 1]), t)
        _close(got, want, 1e-4, f"step {t}")
    for k in jcache:
        _close(cache[k], jcache[k], 1e-4, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_drops_matches_reference(arch):
    """Batch-2 decode of two equal rows at the config's capacity: every MoE
    layer drops the second row's experts, in both packages alike."""
    jcfg, pcfg = _cfgs(arch)
    jmodel, model = j_get_model(jcfg), get_model(pcfg)
    jp, pp = _weights(arch), _port_params(arch)
    tokens = np.repeat(_tokens(jcfg, 1, 4, seed=6), 2, axis=0)
    jcache = jmodel.init_cache(2, 4)
    cache = model.init_cache(2, 4, device="cpu")
    step = jax.jit(jmodel.decode_step)
    for t in range(4):
        want, jcache = step(jp, jcache, tokens[:, t:t + 1], jnp.int32(t))
        got, cache = model.decode_step(pp, cache, T(tokens[:, t:t + 1]), t)
        _close(got, want, 1e-4, f"step {t}")
        assert float((got[0] - got[1]).abs().max()) > 1e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_prefill(arch):
    """The port's own contract at capacity factor 8 (no drops at either
    length), tests/test_decode_consistency.py's tolerance."""
    _, pcfg = _cfgs(arch, capacity_factor=8.0)
    model = get_model(pcfg)
    params = _port_params(arch)
    tokens = T(_tokens(pcfg, 2, DECODE, seed=7), dtype=torch.int64)
    full = model.prefill(params, {"tokens": tokens})
    cache = model.init_cache(2, DECODE, device="cpu")
    for t in range(DECODE):
        logits, cache = model.decode_step(params, cache, tokens[:, t:t + 1],
                                          t)
    assert float((logits - full).abs().max()) < 2e-4


# ---------------------------------------------------------------------------
# training: the loss, its gradient, a train step
# ---------------------------------------------------------------------------

def _batch(cfg, seed: int = 1) -> dict:
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab, (2, S), dtype=np.int32),
            "labels": rng.integers(0, cfg.vocab, (2, S), dtype=np.int32),
            "mask": (rng.random((2, S)) < 0.7).astype(np.float32)}


@pytest.mark.parametrize("dispatch", DISPATCH)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dispatch):
    """`moe_loss` (cross-entropy + 0.01 x aux / n_layers) and its gradient
    against `jax.value_and_grad`, with a loss mask."""
    jcfg, pcfg = _cfgs(arch, dispatch=dispatch)
    batch = _batch(jcfg)
    jp = _weights(arch)
    wl, wg = jax.jit(jax.value_and_grad(j_get_model(jcfg).loss))(jp, batch)
    params = pstep.trainable(_port_params(arch))
    loss = get_model(pcfg).loss(params, {k: T(v) for k, v in batch.items()})
    paths, leaves = zip(*sorted(flatten(params).items()))
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    np.testing.assert_allclose(float(loss), float(wl), rtol=1e-4)
    want = flatten(jax.tree.map(np.asarray, wg))
    assert sorted(grads) == sorted(want)
    for path, w in want.items():
        scale = float(np.abs(w).max())
        assert scale > 0, path
        np.testing.assert_allclose(grads[path].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=str(path))


@pytest.mark.parametrize("arch,param_dtype", [
    ("qwen3-moe-235b-a22b", "float32"), ("deepseek-v2-236b", "float32"),
    ("qwen3-moe-235b-a22b", "bfloat16")])
def test_train_step_matches_reference(arch, param_dtype):
    """One AdamW step from the reference's state: loss, gradient norm and
    learning rate, and every new parameter within 2.5 lr; with bf16
    parameters (f32 compute) the update is cast back to bf16, as the
    reference's is."""
    jcfg = jconfigs.reduced(arch).replace(param_dtype=param_dtype)
    pcfg = pconfigs.reduced(arch).replace(param_dtype=param_dtype)
    jmodel = j_get_model(jcfg)
    jtc = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT))
    jst = jstep.init_train_state(jmodel, jax.random.PRNGKey(0), jtc)
    batch = {k: v for k, v in _batch(jcfg).items() if k != "mask"}
    jst2, jm = jax.jit(jstep.make_train_step(jmodel, jtc))(jst, batch)
    ptc = pstep.TrainConfig(opt=popt.AdamWConfig(**OPT))
    pst = pstep.new_train_state(
        params_from_numpy(jax.tree.map(np.asarray, jst.params), "cpu"), ptc)
    pst2, pm = pstep.make_train_step(get_model(pcfg), ptc)(
        pst, {k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(float(pm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    assert np.float32(pm["lr"]) == np.float32(jm["lr"])
    old = flatten(jax.tree.map(np.asarray, jst.params))
    new = flatten(jax.tree.map(np.asarray, jst2.params))
    moved = 0
    for path, p in flatten(pst2.params).items():
        assert p.dtype == PL.dtype_of(param_dtype), path
        got = p.detach().float().numpy()
        np.testing.assert_allclose(got, np.asarray(new[path], np.float32),
                                   rtol=0, atol=2.5 * LR, err_msg=str(path))
        moved += int((got != np.asarray(old[path], np.float32)).any())
    assert moved > 0
