"""The port's training substrate (train/optimizer.py, compression.py,
checkpoint.py, data/pipeline.py) against the reference package's.

The reference's train step runs jitted, where XLA computes a division by a
compile-time constant as the product with its f32 reciprocal; the port
takes the same product (`config.inv_f32`).  So the learning-rate schedule,
the clip and the global norm are held to the jitted reference within 1
ulp; AdamW's parameters and moments within 2 ulps (XLA on the CPU
contracts `b * m + c * g` into fused multiply-adds, the port does not) and
its step exactly; the int8 quantiser bit for bit.  Checkpoints are
interchangeable: a directory written by either package restores in the
other bit for bit.  The data pipeline gives the reference's bits.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models.registry import get_model as j_get_model
from repro.train import checkpoint as jckpt
from repro.train import compression as jcomp
from repro.train import optimizer as jopt
from repro.train import step as jstep
import repro_torch.configs as pconfigs
from repro_torch.data import pipeline as ppipe
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy, params_to_numpy
from repro_torch.models.layers import flatten, tree_map
from repro_torch.train import checkpoint as pckpt
from repro_torch.train import compression as pcomp
from repro_torch.train import optimizer as popt
from repro_torch.train import step as pstep

torch.set_num_threads(1)
T = torch.tensor


def ulps(got, want) -> int:
    """Largest distance in f32 ulps (finite values of one sign)."""
    got = np.asarray(got, np.float32).reshape(-1)
    want = np.asarray(want, np.float32).reshape(-1)
    return int(np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64)).max(initial=0))


def _tree(seed: int, dtype=np.float32) -> dict:
    """A small parameter-like tree: matrices (decayed) and vectors (not)."""
    rng = np.random.default_rng(seed)
    return {"a": {"w": rng.standard_normal((7, 33)).astype(dtype),
                  "b": rng.standard_normal((33,)).astype(dtype)},
            "z": rng.standard_normal((3, 5, 9)).astype(dtype)}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ---------------------------------------------------------------- optimizer

@pytest.mark.parametrize("cfg", [
    popt.AdamWConfig(),
    popt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=60,
                     min_lr_frac=0.05),
    popt.AdamWConfig(warmup_steps=0, total_steps=7)])
def test_lr_schedule_within_one_ulp(cfg):
    jcfg = jopt.AdamWConfig(**cfg.__dict__)
    steps = np.arange(0, 101, dtype=np.int32)
    want = np.asarray(jax.jit(jax.vmap(
        lambda s: jopt.lr_schedule(jcfg, s)))(steps))
    got = np.array([float(popt.lr_schedule(cfg, T(s, dtype=torch.int32)))
                    for s in steps], np.float32)
    assert ulps(got, want) <= 1


@pytest.mark.parametrize("max_norm", [1.0, 1e3])
def test_clip_and_global_norm_within_one_ulp(max_norm):
    g = _tree(3)
    want_g, want_n = jax.jit(
        lambda t: jopt.clip_by_global_norm(t, max_norm))(g)
    got_g, got_n = popt.clip_by_global_norm(tree_map(T, g), max_norm)
    assert ulps(got_n, want_n) <= 1
    assert ulps(popt.global_norm(tree_map(T, g)),
                jax.jit(jopt.global_norm)(g)) <= 1
    for k, w in flatten(_np(want_g)).items():
        assert ulps(flatten(got_g)[k].numpy(), w) <= 1, k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update_within_two_ulps(dtype):
    """Three updates on identical numpy trees: parameters (cast back to
    their type), both moments within 2 ulps, the step exact.  The gradients'
    global norm stays under the clip, so both sides scale them by exactly 1
    (the clip's own 1 ulp is the test above)."""
    cfg = popt.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
    jcfg = jopt.AdamWConfig(**cfg.__dict__)
    p0 = _tree(0)
    jp = jax.tree.map(lambda a: jnp.asarray(a, dtype), p0)
    pp = params_from_numpy(_np(jp), device="cpu")
    js, ps = jopt.init_opt_state(jp), popt.init_opt_state(pp)
    upd = jax.jit(lambda p, g, s: jopt.adamw_update(jcfg, p, g, s))
    for i in range(3):
        g = jax.tree.map(lambda a: a * np.float32(0.01), _tree(10 + i))
        jg = jax.tree.map(lambda a: jnp.asarray(a, dtype), g)
        jp, js, jm = upd(jp, jg, js)
        pp, ps, pm = popt.adamw_update(
            cfg, pp, params_from_numpy(_np(jg), device="cpu"), ps)
        assert int(ps.step) == int(js.step) == i + 1
        assert ps.step.dtype == torch.int32
        assert ulps(pm["lr"], jm["lr"]) <= 1
        assert ulps(pm["grad_norm"], jm["grad_norm"]) <= 1
        for name, got, want in (("m", ps.m, js.m), ("v", ps.v, js.v)):
            for k, w in flatten(_np(want)).items():
                assert ulps(flatten(got)[k].numpy(), w) <= 2, (name, k, i)
        for k, w in flatten(_np(jp)).items():
            got = flatten(params_to_numpy(pp))[k]
            if dtype == "bfloat16":   # uint16 bits on both sides
                got = (got.astype(np.uint32) << 16).view(np.float32)
                w = (np.asarray(w).view(np.uint16).astype(np.uint32)
                     << 16).view(np.float32)
            assert ulps(got, w) <= 2, (k, i)


def test_adamw_minimizes_quadratic():
    """The reference's own check, on the port: AdamW drives a quadratic
    bowl to its minimum."""
    cfg = popt.AdamWConfig(lr=0.1, warmup_steps=1, total_steps=200,
                           weight_decay=0.0)
    params = {"x": T([3.0, -2.0, 1.5])}
    state = popt.init_opt_state(params)
    for _ in range(200):
        grads = {"x": 2.0 * params["x"]}
        params, state, _ = popt.adamw_update(cfg, params, grads, state)
    assert float(params["x"].abs().max()) < 0.05


def test_opt_state_specs_wait_for_the_mesh():
    """The moments' specs (once refused until ROADMAP item 6f) are the
    parameters', the step replicated, as the reference's."""
    from jax.sharding import PartitionSpec as JP

    from repro_torch.distributed.ctx import P
    specs = {"w": P("data", "model"), "b": {"x": P(None)}}
    got = popt.opt_state_specs(specs)
    want = jopt.opt_state_specs({"w": JP("data", "model"),
                                 "b": {"x": JP(None)}})
    assert got.step == P() and tuple(want.step) == ()
    for tree in (got.m, got.v):
        assert tree == specs
    assert tuple(want.m["w"]) == ("data", "model")


# -------------------------------------------------------------- compression

@pytest.mark.parametrize("n", [1000, 128, 4096 + 5])
def test_quantize_int8_bit_equal(n):
    rng = np.random.default_rng(n)
    g = (rng.standard_normal((n,)) * 3).astype(np.float32)
    g[: min(n, 128)] = 0.0          # an all-zero block: the 1e-12 floor
    _, _, wmeta = jcomp.quantize_int8(g)
    q, s, meta = pcomp.quantize_int8(T(g))
    jq, js = jax.jit(lambda x: jcomp.quantize_int8(x)[:2])(g)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert meta == (tuple(wmeta[0]), wmeta[1])
    back = pcomp.dequantize_int8(q, s, meta, torch.float32)
    want = jax.jit(lambda x: jcomp.compress_roundtrip(x))(g)
    np.testing.assert_array_equal(back.numpy(), np.asarray(want))
    np.testing.assert_array_equal(pcomp.compress_roundtrip(T(g)).numpy(),
                                  np.asarray(want))


def test_error_feedback_ten_steps_bit_equal():
    rng = np.random.default_rng(1)
    shapes = {"g": (256,), "w": (5, 70)}
    jef = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    pef = pcomp.init_ef_state(tree_map(T, jef))
    step = jax.jit(jcomp.apply_error_feedback)
    sent_total = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    true_total = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    for _ in range(10):
        g = {k: (rng.standard_normal(s) * 0.01).astype(np.float32)
             for k, s in shapes.items()}
        jsent, jef = step(g, jef)
        psent, pef = pcomp.apply_error_feedback(tree_map(T, g), pef)
        for k in shapes:
            np.testing.assert_array_equal(psent[k].numpy(),
                                          np.asarray(jsent[k]))
            np.testing.assert_array_equal(pef[k].numpy(), np.asarray(jef[k]))
            sent_total[k] += psent[k].numpy()
            true_total[k] += g[k]
    # the residual carries what was not sent: sent + residual = true sum
    for k in shapes:
        assert np.abs(sent_total[k] + pef[k].numpy()
                      - true_total[k]).max() < 1e-5


def test_cross_pod_allreduce_waits_for_the_mesh():
    """Once refused until ROADMAP item 6f: without a `pod` axis the
    compressed all-reduce is the identity, as the reference's (two pods on
    gloo ranks: tests/test_torch_elastic.py)."""
    import types
    grads = {"w": T([1.0, 2.0])}
    mesh = types.SimpleNamespace(mesh_dim_names=("data", "model"))
    assert pcomp.cross_pod_allreduce_compressed(grads, mesh) is grads


# ------------------------------------------------------------- checkpoints

def _train_states(compress: bool):
    """The reference's TrainState of reduced qwen2 and the port's, the same
    values (one update applied, so the step and moments are not zero)."""
    cfg = jconfigs.reduced("qwen2-1.5b")
    tcfg = jstep.TrainConfig(grad_compression=compress)
    js = jstep.init_train_state(j_get_model(cfg), jax.random.PRNGKey(0),
                                tcfg)
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.01, p.dtype),
                         js.params)
    params, opt, _ = jopt.adamw_update(tcfg.opt, js.params, grads, js.opt)
    js = jstep.TrainState(params, opt, js.ef)
    pt = pstep.TrainConfig(grad_compression=compress)
    ps = pstep.new_train_state(params_from_numpy(_np(js.params), "cpu"), pt)
    ps = pstep.TrainState(ps.params, popt.OptState(
        T(int(js.opt.step), dtype=torch.int32),
        params_from_numpy(_np(js.opt.m), "cpu"),
        params_from_numpy(_np(js.opt.v), "cpu")), ps.ef)
    return js, ps


def _same_state(port_state, ref_state):
    """Every leaf equal bit for bit, leaf names the reference's."""
    got = dict(pckpt._leaf_paths(port_state))
    want = dict(jckpt._leaf_paths(ref_state))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        g = got[name]
        assert tuple(g.shape) == tuple(np.shape(w)), name
        g_np = params_to_numpy({"x": g})["x"]
        w_np = np.asarray(w)
        if w_np.dtype.name == "bfloat16":
            w_np = w_np.view(np.uint16)
        np.testing.assert_array_equal(g_np, w_np, err_msg=name)


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_leaf_names_are_the_references(compress):
    js, ps = _train_states(compress)
    names = [n for n, _ in pckpt._leaf_paths(ps)]
    assert names == [n for n, _ in jckpt._leaf_paths(js)]
    assert ".params_embed_tok" in names and ".opt_.step" in names
    assert ".opt_.v_layers_mlp_w_down" in names
    assert any(n.startswith(".ef_") for n in names) == compress


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_reference_to_port(tmp_path, compress):
    js, ps = _train_states(compress)
    jckpt.save(str(tmp_path), 1, js)
    got = pckpt.restore(str(tmp_path), 1, ps, device="cpu")
    _same_state(got, js)
    assert all(p.requires_grad for p in flatten(got.params).values())
    assert got.opt.step.dtype == torch.int32


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoint_port_to_reference(tmp_path, compress):
    js, ps = _train_states(compress)
    pckpt.save(str(tmp_path), 1, ps)
    with open(tmp_path / "step_00000001" / "manifest.json") as f:
        port_manifest = f.read()
    got = jckpt.restore(str(tmp_path), 1, js)
    _same_state(ps, got)
    jckpt.save(str(tmp_path / "ref"), 1, js)
    with open(tmp_path / "ref" / "step_00000001" / "manifest.json") as f:
        assert f.read() == port_manifest


def test_checkpoint_bf16_both_ways(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"w": jnp.asarray(rng.standard_normal((4, 8)), jnp.bfloat16),
            "s": jnp.int32(7), "v": jnp.asarray(rng.standard_normal(5),
                                                jnp.float32)}
    like = params_from_numpy(_np(tree), "cpu")
    pckpt.save(str(tmp_path / "p"), 3, like)
    back = jckpt.restore(str(tmp_path / "p"), 3, tree)
    assert back["w"].dtype == jnp.bfloat16
    for k in tree:
        np.testing.assert_array_equal(
            np.asarray(back[k]).view(np.uint16) if k == "w"
            else np.asarray(back[k]),
            params_to_numpy(like)[k])
    jckpt.save(str(tmp_path / "j"), 3, tree)
    got = pckpt.restore(str(tmp_path / "j"), 3, like, device="cpu")
    assert got["w"].dtype == torch.bfloat16
    for k in tree:
        np.testing.assert_array_equal(params_to_numpy(got)[k],
                                      params_to_numpy(like)[k])


def test_checkpoint_roundtrip_torn_tmp_latest_and_prune(tmp_path):
    d = str(tmp_path / "ck")
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": [torch.ones(2, dtype=torch.bfloat16), torch.tensor(3)]}
    assert pckpt.latest_step(d) is None
    for step in (1, 2, 5, 9):
        pckpt.save(d, step, state)
    # a crashed writer's torn directory is ignored, then replaced
    os.makedirs(os.path.join(d, "step_00000012.tmp"))
    assert pckpt.latest_step(d) == 9
    got = pckpt.restore(d, 9, state, device="cpu")
    assert torch.equal(got["a"], state["a"])
    assert got["b"][0].dtype == torch.bfloat16
    assert torch.equal(got["b"][0], state["b"][0])
    assert int(got["b"][1]) == 3
    pckpt.save(d, 12, state)
    assert not os.path.exists(os.path.join(d, "step_00000012.tmp"))
    assert pckpt.latest_step(d) == 12
    pckpt.prune(d, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000009", "step_00000012"]
    with pytest.raises(ValueError, match="shape"):
        pckpt.restore(d, 12, {"a": torch.zeros(3, 2), "b": state["b"]},
                      device="cpu")


# ------------------------------------------------------------ data pipeline

@pytest.mark.parametrize("shards", [1, 2])
def test_batch_at_bit_equal(shards):
    kw = dict(vocab=512, seq_len=40, global_batch=4, seed=7, shards=shards)
    for shard_id in range(shards):
        jp = jpipe.TokenPipeline(jpipe.DataConfig(**kw, shard_id=shard_id))
        pp = ppipe.TokenPipeline(ppipe.DataConfig(**kw, shard_id=shard_id))
        for step in (0, 5, 1000):
            want, got = jp.batch_at(step), pp.batch_at(step)
            for k in ("tokens", "labels"):
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
    on = ppipe.to_device(got, "cpu")
    assert on["tokens"].dtype == torch.int64
    np.testing.assert_array_equal(on["labels"].numpy(), got["labels"])


def test_iterator_and_entropy_floor():
    cfg = dict(vocab=128, seq_len=16, global_batch=2, seed=3)
    pp = ppipe.TokenPipeline(ppipe.DataConfig(**cfg))
    it = pp.iterator(start_step=4)
    for want_step in (4, 5, 6):
        step, batch = next(it)
        assert step == want_step
        np.testing.assert_array_equal(batch["tokens"],
                                      pp.batch_at(step)["tokens"])
    it.close()
    for kw in (cfg, dict(cfg, rep_p=0.2, zipf_a=1.1)):
        assert ppipe.entropy_floor(ppipe.DataConfig(**kw)) == \
            jpipe.entropy_floor(jpipe.DataConfig(**kw))


def test_new_train_state_and_the_mesh_parts():
    model = get_model(pconfigs.reduced("mamba2-2.7b"))
    st = pstep.init_train_state(model, torch.Generator().manual_seed(0),
                                pstep.TrainConfig(grad_compression=True),
                                device="cpu")
    assert int(st.opt.step) == 0 and st.ef is not None
    assert all(p.requires_grad for p in flatten(st.params).values())
    # the dry run's abstract state and specs (once refused until ROADMAP
    # item 6f): no values, the reference's shapes, a spec a leaf
    tcfg = pstep.TrainConfig(grad_compression=True)
    ab = pstep.abstract_train_state(model, tcfg)
    sp = pstep.train_state_specs(model, tcfg)
    jm = j_get_model(jconfigs.reduced("mamba2-2.7b"))
    jab = jstep.abstract_train_state(jm, jstep.TrainConfig(
        grad_compression=True))
    for part in ("m", "v"):
        for path, t in flatten(getattr(ab.opt, part)).items():
            assert t.device.type == "meta" and t.dtype == torch.float32
            want = jab.opt._asdict()[part]
            for k in path:
                want = want[k]
            assert tuple(t.shape) == tuple(want.shape), path
    assert set(flatten(sp.params)) == set(flatten(ab.params)) \
        == set(flatten(sp.ef))
