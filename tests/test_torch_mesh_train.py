"""Training on a mesh of 4 gloo ranks, on the CPU.

Reduced qwen3-moe (16 query heads and 4 KV heads, so the specs split the
heads as at the published widths; routing groups of 8 tokens, so a
batch's groups split over `data`; its experts over `model` and their FSDP
split over `data`) and reduced qwen2-1.5b (heads that do not divide
`model`: the row-sharded attention blocks), both under activation
checkpointing with blockwise attention of 8-row blocks, on a (2, 2) and a
(1, 4) ("data", "model") mesh:

  * the three repairs a meshed state needs: moments, error-feedback
    residuals and the microbatch accumulator made with their parameter's
    layout (`optimizer.zeros_f32`); `init_train_state(..., mesh=)` drawing
    each rank's shards (the slices of the one-card draws); and
    `checkpoint.save` holding at most one whole leaf at a time;
  * loss and every gradient leaf of `step.value_and_grad` on the mesh
    within GRAD_RTOL of the leaf's largest magnitude of the unmeshed port's
    on the same weights and batch, every gradient in its parameter's
    placements (no partial sum left), and the collectives that lay them
    out counted (`launch.op_analysis`);
  * on (2, 2) `microbatches=2` against 1 (qwen2), and the MoE's
    `microbatches=2` against the unmeshed port's (the router's aux loss
    is taken a microbatch at a time, so its whole batch differs);
  * STEPS AdamW steps on the mesh from the reference's initial weights
    (carried across by `models/convert.py`) whose losses are within
    LOSS_TOL (the reference's elastic bound, tests/test_elastic.py) of the
    JAX package's unmeshed jitted `make_train_step` on the same batches,
    run here in the test's own process;
  * a (2, 2) checkpoint restored onto (1, 4) (`restore(shardings=)`), bit
    equal leaf by leaf to the state that was saved, and the next step's
    loss on both meshes within GRAD_RTOL.

Each world is 4 processes on a `file://` store under the test's temporary
directory, the worlds one after the other; each process holds one default
process group, as `torchrun` starts them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
import weakref

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCHS = ("qwen3-moe-235b-a22b", "qwen2-1.5b")
# the JAX package's three steps, one model on each mesh
JAX_CASES = {"2x2": "qwen3-moe-235b-a22b", "1x4": "qwen2-1.5b"}
GRAD_RTOL = 1e-5
LOSS_TOL = 5e-3
BATCH, SEQ, STEPS = 4, 16, 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ROWS = ("pod", "data")
# elements of a checkpoint block here (a stacked leaf is written a layer
# at a time)
SAVE_BLOCK = 256


def train_config(configs, arch: str):
    """The reduced config of `arch` from `configs` (either package's):
    checkpointed layers, 8-row attention blocks; for the MoE 16 query and
    4 KV heads and routing groups of 8 tokens."""
    cfg = configs.reduced(arch).replace(remat=True, attn_block=8)
    if cfg.family == "moe":
        cfg = cfg.replace(n_heads=16, n_kv_heads=4, moe=dataclasses.replace(
            cfg.moe, router_group=8))
    return cfg


def batch_np(cfg, i: int) -> dict:
    """Batch `i`: BATCH x SEQ next-token pairs from a numpy seed."""
    t = np.random.default_rng(100 + i).integers(
        0, cfg.vocab, (BATCH, SEQ + 1), dtype=np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _whole(x):
    return x.full_tensor() if type(x).__name__ == "DTensor" else x


def _guard(fn) -> dict:
    """fn's result, or the error it raised (every rank raises alike: no
    collective runs before these checks fail)."""
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 - reported by the test
        return {"error": f"{type(e).__name__}: {e}"}


class _GatherWatch:
    """The bytes of whole tensors that `DTensor.full_tensor` made (not an
    alias of the local shard) still alive at each gather: the most is what
    a save held at once beyond the state."""

    def __init__(self):
        from torch.distributed.tensor import DTensor
        self.refs, self.most, self.largest = [], 0, 0
        self._full = DTensor.full_tensor

    def _alive(self) -> int:
        return sum(r().numel() * r().element_size() for r in self.refs
                   if r() is not None)

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        full = self._full

        def watched(t, *a, **k):
            self.most = max(self.most, self._alive())
            out = full(t, *a, **k)
            if out.untyped_storage().data_ptr() != \
                    t._local_tensor.untyped_storage().data_ptr():
                self.refs.append(weakref.ref(out))
                self.largest = max(self.largest,
                                   out.numel() * out.element_size())
            self.most = max(self.most, self._alive())
            return out
        DTensor.full_tensor = watched
        return self

    def __exit__(self, *exc):
        from torch.distributed.tensor import DTensor
        DTensor.full_tensor = self._full


def _layout(got: dict, like: dict) -> bool:
    """Every leaf of `got` a DTensor laid out as its leaf of `like`."""
    from repro_torch.models.layers import flatten
    fl = flatten(like)
    return all(type(t).__name__ == "DTensor"
               and t.placements == fl[k].placements
               for k, t in flatten(got).items())


def _grads_against_plain(model, cfg, mesh, gen) -> dict:
    """value_and_grad of batch 0 on `mesh` (counted) against unmeshed."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place
    from repro_torch.launch import op_analysis
    from repro_torch.models.layers import flatten
    from repro_torch.train import step as S
    batch = {k: torch.as_tensor(v).long() for k, v in
             batch_np(cfg, 0).items()}
    plain = S.trainable(model.init(gen(), device="cpu"))
    loss0, g0 = S.value_and_grad(model, plain, batch)
    meshed = S.trainable(model.init(gen(), device="cpu", mesh=mesh))
    with ctx.use_mesh(mesh):
        pb = place(mesh, batch, {k: ctx.P(ROWS, None) for k in batch})
        (loss1, g1), totals, _ = op_analysis.count(
            S.value_and_grad, model, meshed, pb)
    fp, f0 = flatten(meshed), flatten(g0)
    errs, zero_ok, partial = {}, True, []
    for k, g in flatten(g1).items():
        if any(p.is_partial() for p in g.placements):
            partial.append("/".join(k))
        w, gw = f0[k], g.full_tensor()
        scale = float(w.abs().max())
        errs["/".join(k)] = float((gw - w).abs().max()) / max(scale, 1e-30)
        if scale == 0:
            zero_ok &= bool((gw == 0).all())
    return {"loss": [float(loss0), float(_whole(loss1))],
            "errs": errs, "zero_leaves_zero": zero_ok, "partial": partial,
            "layout": _layout(g1, meshed),
            "sharded_leaves": sum(any(p.is_shard() for p in t.placements)
                                  for t in fp.values()),
            "coll": dict(totals.coll), "counts": dict(totals.counts)}


def _threaded_backward(model, cfg, mesh, gen) -> dict:
    """The checkpointed loss's gradients on `mesh` with its backward run in
    a thread of its own, as autograd runs a backward on the card: the
    thread has the caller's autograd state (DTensor's implicit replication
    on: the engine hands its threads the caller's) but not its Python
    thread-locals (the mesh `use_mesh` installed).  Against the backward
    in the forward's thread: bit-equal."""
    import threading
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place
    from repro_torch.models.layers import flatten
    from repro_torch.train import step as S
    params = S.trainable(model.init(gen(), device="cpu", mesh=mesh))
    leaves = list(flatten(params).values())
    batch = {k: torch.as_tensor(v).long() for k, v in
             batch_np(cfg, 0).items()}
    with ctx.use_mesh(mesh):
        pb = place(mesh, batch, {k: ctx.P(ROWS, None) for k in batch})
        want = torch.autograd.grad(model.loss(params, pb), leaves)
        loss = model.loss(params, pb)
    got = {}

    def backward():
        from torch.distributed.tensor import DTensor
        DTensor._op_dispatcher._allow_implicit_replication = True
        try:
            got["grads"] = torch.autograd.grad(loss, leaves)
        except Exception as e:  # noqa: BLE001 - reported by the test
            got["error"] = f"{type(e).__name__}: {e}"[:300]
    th = threading.Thread(target=backward)
    th.start()
    th.join(timeout=120)
    if "error" in got or "grads" not in got:
        return {"error": got.get("error", "no result")}
    return {"equal": all(torch.equal(_whole(g), _whole(w))
                         for g, w in zip(got["grads"], want, strict=True))}


def _worker(name: str, rank: int, root: str):
    """One rank of the 4-rank world `name`; rank 0 prints JSON."""
    from repro_torch import configs
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import (place,
                                                  shardings_for_shaped,
                                                  tree_leaves)
    from repro_torch.launch import mesh as M
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import unflatten
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import step as S
    from repro_torch.train.compression import init_ef_state
    from repro_torch.train.optimizer import (AdamWConfig, init_opt_state)
    torch.set_num_threads(1)
    M.init_distributed("cpu", world_size=4, rank=rank,
                       store_dir=os.path.join(root, "pg_" + name))
    mesh = M.make_test_mesh(*MESHES[name], device_type="cpu")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    opt = AdamWConfig(**OPT)
    rows = {"tokens": ctx.P(ROWS, None), "labels": ctx.P(ROWS, None)}

    def pbatch(cfg, i):
        return place(mesh, {k: torch.as_tensor(v).long() for k, v in
                            batch_np(cfg, i).items()}, rows)

    def run(model, state, tcfg, batches):
        step, losses, norms = S.make_train_step(model, tcfg), [], []
        with ctx.use_mesh(mesh):
            for b in batches:
                state, m = step(state, b)
                losses.append(float(_whole(m["loss"])))
                norms.append(float(_whole(m["grad_norm"])))
        return state, losses, norms

    res = {}
    moe = get_model(train_config(configs, ARCHS[0]))
    ccfg = S.TrainConfig(opt=opt, grad_compression=True)

    # repair: moments and residuals laid out as their parameters
    def zeros():
        params = S.trainable(moe.init(gen(), device="cpu", mesh=mesh))
        st = S.new_train_state(params, ccfg)
        opt_st, ef = init_opt_state(params), init_ef_state(params)
        trees = {"m": st.opt.m, "v": st.opt.v, "ef": st.ef,
                 "init_opt_state": opt_st.m, "init_ef_state": ef}
        return {k: _layout(t, params) and all(
            bool((x.to_local() == 0).all()) and x.dtype == torch.float32
            for x in tree_leaves(t)) for k, t in trees.items()}
    res["zeros"] = _guard(zeros)

    # repair: the state drawn shard by shard on the mesh
    def init_on_mesh():
        st = S.init_train_state(moe, gen(), ccfg, device="cpu", mesh=mesh)
        want = tree_leaves(place(mesh, moe.init(gen(), device="cpu"),
                                 moe.param_specs()))
        got = tree_leaves(st.params)
        return {"equal": all(g.placements == w.placements
                             and torch.equal(g.to_local(), w.to_local())
                             for g, w in zip(got, want, strict=True)),
                "trainable": all(g.requires_grad for g in got),
                "moments": _layout(st.opt.m, st.params)
                and _layout(st.opt.v, st.params)
                and _layout(st.ef, st.params)}
    res["init_on_mesh"] = _guard(init_on_mesh)

    # gradients on the mesh against unmeshed
    res["grads"] = {arch: _grads_against_plain(
        get_model(train_config(configs, arch)),
        train_config(configs, arch), mesh, gen) for arch in ARCHS}

    res["threaded_backward"] = _threaded_backward(
        moe, train_config(configs, ARCHS[0]), mesh, gen)

    # the reference's weights, STEPS AdamW steps on the mesh
    arch = JAX_CASES[name]
    cfg = train_config(configs, arch)
    model = get_model(cfg)
    with np.load(os.path.join(root, f"jax_{arch}.npz")) as f:
        jparams = params_from_numpy(unflatten(
            {tuple(k.split("|")): f[k] for k in f.files}), "cpu")
    tcfg = S.TrainConfig(opt=opt)
    st = S.new_train_state(place(mesh, jparams, model.param_specs()), tcfg)
    _, res["jax_case_losses"], _ = run(model, st, tcfg,
                                       [pbatch(cfg, i) for i in range(STEPS)])

    if name == "2x2":
        # microbatches: qwen2 2 against 1 on the mesh
        q = get_model(train_config(configs, "qwen2-1.5b"))
        qcfg = train_config(configs, "qwen2-1.5b")
        mb = {}
        for n in (1, 2):
            t = S.TrainConfig(opt=opt, microbatches=n)
            st = S.init_train_state(q, gen(), t, device="cpu", mesh=mesh)
            st, losses, norms = run(q, st, t, [pbatch(qcfg, 0)])
            mb[n] = {"loss": losses[0], "grad_norm": norms[0]}
            if n == 2:
                qstate, qt = st, t
        res["microbatches_qwen2"] = mb
        # the MoE's 2 microbatches on the mesh against unmeshed
        t = S.TrainConfig(opt=opt, microbatches=2)
        mcfg = train_config(configs, ARCHS[0])
        st = S.init_train_state(moe, gen(), t, device="cpu", mesh=mesh)
        _, ml, mn = run(moe, st, t, [pbatch(mcfg, 0)])
        plain = S.init_train_state(moe, gen(), t, device="cpu")
        _, pm = S.make_train_step(moe, t)(plain, {
            k: torch.as_tensor(v).long() for k, v in
            batch_np(mcfg, 0).items()})
        res["microbatches_moe"] = {"mesh": [ml[0], mn[0]],
                                   "plain": [float(pm["loss"]),
                                             float(pm["grad_norm"])]}
        # the checkpoint: saved a leaf at a time, a large leaf in blocks
        # (here of SAVE_BLOCK elements), then one more step
        block, ckpt._SAVE_BLOCK = getattr(ckpt, "_SAVE_BLOCK", None), \
            SAVE_BLOCK
        try:
            with _GatherWatch() as w:
                ckpt.save(os.path.join(root, "ckpt"), 1, qstate)
        finally:
            ckpt._SAVE_BLOCK = block
        res["save"] = {"most_bytes_alive": w.most,
                       "largest_gathered_bytes": w.largest,
                       "largest_leaf_bytes": max(
                           x.numel() * x.element_size()
                           for x in tree_leaves(qstate) if x is not None),
                       "gathered": len(w.refs)}
        whole = {k: _whole(x) for k, x in ckpt._leaf_paths(qstate)}
        if rank == 0:
            torch.save(whole, os.path.join(root, "saved_state.pt"))
        _, res["after_save_loss"], _ = run(q, qstate, qt, [pbatch(qcfg, 1)])
    else:
        # the (2, 2) checkpoint onto this mesh
        q = get_model(train_config(configs, "qwen2-1.5b"))
        qcfg = train_config(configs, "qwen2-1.5b")
        qt = S.TrainConfig(opt=opt, microbatches=2)
        like = S.abstract_train_state(q, qt)
        sh = shardings_for_shaped(mesh, like, S.train_state_specs(q, qt))
        st = ckpt.restore(os.path.join(root, "ckpt"), 1, like, shardings=sh)
        S.trainable(st.params)
        want = torch.load(os.path.join(root, "saved_state.pt"))
        got = dict(ckpt._leaf_paths(st))
        res["restored"] = {
            "bit_equal": sorted(got) == sorted(want) and all(
                torch.equal(_whole(g), want[k]) and g.dtype == want[k].dtype
                for k, g in got.items()),
            "laid_out": all(g.placements == s.placements for (_, g), (_, s)
                            in zip(ckpt._leaf_paths(st),
                                   ckpt._leaf_paths(sh), strict=True)),
            "leaves": len(got)}
        _, res["after_restore_loss"], _ = run(q, st, qt, [pbatch(qcfg, 1)])
    if rank == 0:
        print(json.dumps(res), flush=True)
    M.shutdown()


def _spawn(name: str, root: str) -> list:
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_mesh_train as t; "
         f"t._worker({name!r}, {r}, {root!r})"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]


def _wait(procs) -> dict:
    # every rank's pipes drained at once: a rank that fills a pipe no one
    # reads blocks, and the others then wait for it in a collective
    with ThreadPoolExecutor(len(procs)) as pool:
        outs = list(pool.map(
            lambda p: p.communicate(timeout=300) + (p.returncode,), procs))
    for out, err, rc in outs:
        assert rc == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


def _jax_states(root: str) -> dict:
    """The reference's initial train state of each JAX case, its weights
    written for the workers."""
    import jax
    import repro.configs as jconfigs
    from repro.models.registry import get_model as j_get_model
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    from repro_torch.models.layers import flatten
    out = {}
    for arch in sorted(set(JAX_CASES.values())):
        cfg = train_config(jconfigs, arch)
        model = j_get_model(cfg)
        tcfg = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT))
        st = jstep.init_train_state(model, jax.random.PRNGKey(0), tcfg)
        np.savez(os.path.join(root, f"jax_{arch}.npz"), **{
            "|".join(k): v for k, v in
            flatten(jax.tree.map(np.asarray, st.params)).items()})
        out[arch] = (cfg, jax.jit(jstep.make_train_step(model, tcfg)), st)
    return out


def _jax_losses(states: dict) -> dict:
    """The reference's unmeshed jitted losses of STEPS steps."""
    out = {}
    for arch, (cfg, fn, st) in states.items():
        losses = []
        for i in range(STEPS):
            st, m = fn(st, batch_np(cfg, i))
            losses.append(float(m["loss"]))
        out[arch] = losses
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's results, the worlds one after another (4 processes at
    a time), and the reference's losses, taken while the first world
    runs."""
    root = str(tmp_path_factory.mktemp("mesh_train"))
    states = _jax_states(root)
    first = _spawn("2x2", root)
    ref = _jax_losses(states)
    out = {"reference": ref, "2x2": _wait(first)}
    out["1x4"] = _wait(_spawn("1x4", root))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moments_and_residuals_laid_out_as_parameters(runs, mesh):
    """new_train_state / init_opt_state / init_ef_state on DTensor
    parameters: zero f32 DTensors in each parameter's placements."""
    r = runs[mesh]["zeros"]
    assert "error" not in r, r
    assert all(r.values()), r


@pytest.mark.parametrize("mesh", list(MESHES))
def test_init_train_state_on_the_mesh(runs, mesh):
    """init_train_state(..., mesh=): each rank's shards are those of the
    one-card draws placed by the specs, trainable, the moments and
    residuals laid out alike."""
    r = runs[mesh]["init_on_mesh"]
    assert "error" not in r, r
    assert r["equal"] and r["trainable"] and r["moments"], r


def test_save_holds_one_whole_leaf_at_a_time(runs):
    """checkpoint.save on (2, 2): no rank ever holds more gathered bytes
    than one whole leaf (here one block of a leaf: the blocks of
    SAVE_BLOCK elements are cut along the layer axis, one layer at
    least), where gathering every leaf before writing held them all."""
    r = runs["2x2"]["save"]
    assert r["gathered"] > 1, r
    assert 0 < r["most_bytes_alive"] <= r["largest_gathered_bytes"], r
    assert r["largest_gathered_bytes"] < r["largest_leaf_bytes"], r


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_on_the_mesh_as_unmeshed(runs, mesh, arch):
    r = runs[mesh]["grads"][arch]
    plain, got = r["loss"]
    assert abs(got - plain) <= GRAD_RTOL * abs(plain), r["loss"]
    assert max(r["errs"].values()) <= GRAD_RTOL, r["errs"]
    assert r["zero_leaves_zero"]
    assert r["sharded_leaves"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_gradients_laid_out_as_parameters(runs, mesh, arch):
    """No partial sum is left: each gradient is in its parameter's
    placements, the reductions counted as collectives."""
    r = runs[mesh]["grads"][arch]
    assert r["partial"] == [] and r["layout"], r["partial"]
    assert r["counts"].get("all-reduce", 0) > 0, r["counts"]


def test_fsdp_gradients_are_reduce_scattered(runs):
    """A partial sum over an axis that splits the parameter is
    reduce-scattered: on (1, 4) the head-split projections' over `model`;
    on (2, 2) the MoE's experts and embeddings are also split over `data`
    (FSDP), and their partial sums there add reduce-scatters."""
    rs = {m: runs[m]["grads"][ARCHS[0]]["counts"].get("reduce-scatter", 0)
          for m in MESHES}
    assert rs["2x2"] > rs["1x4"] > 0, rs


@pytest.mark.parametrize("mesh", list(MESHES))
def test_steps_match_the_jax_package(runs, mesh):
    arch = JAX_CASES[mesh]
    got, want = runs[mesh]["jax_case_losses"], runs["reference"][arch]
    assert len(got) == len(want) == STEPS
    for x, y in zip(got, want):
        assert abs(x - y) < LOSS_TOL, (arch, got, want)


def test_microbatches_on_the_mesh(runs):
    """On (2, 2): qwen2's first step over 2 microbatches (the accumulator a
    DTensor laid out as each parameter) is the whole batch's; the MoE's is
    the unmeshed port's 2-microbatch step."""
    mb = runs["2x2"]["microbatches_qwen2"]
    for k in ("loss", "grad_norm"):
        assert abs(mb["2"][k] - mb["1"][k]) <= GRAD_RTOL * abs(mb["1"][k]), mb
    m = runs["2x2"]["microbatches_moe"]
    for got, want in zip(m["mesh"], m["plain"]):
        assert abs(got - want) <= GRAD_RTOL * abs(want), m


def test_checkpoint_restored_onto_another_mesh(runs):
    """The (2, 2) checkpoint restored onto (1, 4): every leaf bit-equal to
    the state saved and laid out by the (1, 4) specs; the next step's loss
    the (2, 2) state's."""
    r = runs["1x4"]["restored"]
    assert r["bit_equal"] and r["laid_out"] and r["leaves"] > 0, r
    want = runs["2x2"]["after_save_loss"][0]
    got = runs["1x4"]["after_restore_loss"][0]
    assert abs(got - want) <= GRAD_RTOL * abs(want), (got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_backward_in_another_thread_keeps_the_mesh(runs, mesh):
    """A checkpointed layer recomputed in the backward's own thread runs
    under the forward's mesh (its `constrain`s), so the MoE's gradients
    are those of a backward in the forward's thread."""
    r = runs[mesh]["threaded_backward"]
    assert r == {"equal": True}, r


def test_recorded_routes_leave_the_checkpointed_layers_alone():
    """`moe.record_routes` around a checkpointed MoE loss, its backward
    outside the block (on the card autograd recomputes a layer in a thread
    of its own, where no log is open): the recompute saves what the
    forward saved, and the gradients are those of the unrecorded loss."""
    from repro_torch import configs
    from repro_torch.models import get_model, moe
    from repro_torch.models.layers import flatten
    from repro_torch.train import step as S
    cfg = train_config(configs, ARCHS[0])
    model = get_model(cfg)
    params = S.trainable(model.init(torch.Generator().manual_seed(0),
                                    device="cpu"))
    batch = {k: torch.as_tensor(v).long() for k, v in
             batch_np(cfg, 0).items()}
    leaves = list(flatten(params).values())
    with moe.record_routes() as routes:
        loss = model.loss(params, batch)
    got = torch.autograd.grad(loss, leaves)
    want = torch.autograd.grad(model.loss(params, batch), leaves)
    assert len(routes) == cfg.n_layers
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_mesh_train_script_imports_no_jax():
    """scripts/mesh_train_cards.py and what it imports load without JAX
    or the JAX package."""
    code = ("import sys\n"
            f"sys.path.insert(0, {os.path.join(ROOT, 'scripts')!r})\n"
            "import mesh_train_cards\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert 'repro_torch.train.step' in sys.modules\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
