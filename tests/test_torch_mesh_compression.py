"""Gradient compression on a mesh of 4 gloo ranks, on the CPU.

`train/compression.py` on DTensor gradients, held to the reference's
semantics (its blocks are 128 consecutive elements of the whole leaf's
row-major flattening, the tail zero-padded; `cross_pod_allreduce_
compressed` quantises each leaf whole, then takes the mean over `pod`):

  * `blocks_aligned` (when a rank may quantise its shard alone) against a
    brute-force walk of every rank's shard, without a process group;
  * `apply_error_feedback` on DTensors of every placement the port's spec
    trees give (reduced qwen3-moe, deepseek-v2 and qwen2-1.5b on each
    mesh), and of a 3-D leaf split on its last axis, an uneven split and
    leaves whose shards are and are not block-aligned: the compressed
    gradient and the residual bit-equal to the unmeshed call's on the
    whole leaves, and laid out as the gradient; a tree of aligned leaves
    compressed with no collective;
  * a compressed train step (`TrainConfig(grad_compression=True)`) of
    reduced qwen2-1.5b on (2, 2), (1, 4) and (2, 1, 2) from the
    reference's initial weights (carried across by `models/convert.py`):
    the residuals and moments stay in their parameters' placements, and
    STEPS losses are within LOSS_TOL of the JAX package's unmeshed jitted
    compressed `make_train_step` on the same batches;
  * `cross_pod_allreduce_compressed` on (2, 1, 2) over leaves split over
    `model`, each pod holding its own gradient: bit-equal to the mean of
    the two pods' whole-leaf round trips;
  * the dry run's compressed train cell (`run_cell(...,
    grad_compression=True)` on 8 fake ranks): the residuals laid out as
    the parameters.

Each world is 4 processes on a `file://` store under the test's temporary
directory, the worlds one after the other; each process holds one default
process group, as `torchrun` starts them.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_mesh_train import _guard, _wait, batch_np

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# (pod, data, model)
MESHES = {"2x2": (1, 2, 2), "1x4": (1, 1, 4), "2x1x2": (2, 1, 2)}
SPEC_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "qwen2-1.5b")
STEP_ARCH = "qwen2-1.5b"
LOSS_TOL = 5e-3
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ROWS = ("pod", "data")
# (name, shape, spec) of the leaves beside the spec trees'
EXTRA = (("last_axis_aligned", (4, 6, 256), (None, None, "model")),
         ("last_axis_unaligned", (4, 6, 64), (None, None, "model")),
         ("uneven", (5, 256), ("model", None)),
         ("uneven_last", (7, 3), (None, "model")),
         ("aligned_2d", (8, 512), ("data", "model")),
         ("unaligned_rows", (6, 40), ("model", None)),
         ("aligned_rows", (8, 128), ("model", None)))


def train_config(configs, arch: str):
    """The reduced config of `arch` from `configs` (either package's):
    checkpointed layers, 8-row attention blocks; for qwen3-moe 16 query
    and 4 KV heads (so the specs split them), routing groups of 8."""
    cfg = configs.reduced(arch).replace(remat=True, attn_block=8)
    if cfg.family == "moe":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router_group=8))
    if arch == "qwen3-moe-235b-a22b":
        cfg = cfg.replace(n_heads=16, n_kv_heads=4)
    return cfg


def _leaf_cases(mesh) -> dict:
    """{name: (shape, spec)} of every parameter leaf of SPEC_ARCHS' reduced
    configs and of EXTRA (dimensions the spec's axes do not divide
    replicated, as the parameters are placed)."""
    from repro_torch import configs
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import _divisible_spec
    from repro_torch.models import get_model
    from repro_torch.models.layers import flatten
    names = set(ctx.axis_names(mesh))
    out = {}
    for arch in SPEC_ARCHS:
        model = get_model(train_config(configs, arch))
        specs = flatten(model.param_specs())
        for k, t in flatten(model.abstract_params()).items():
            out[arch + ":" + "/".join(k)] = (tuple(t.shape), specs[k])
    for name, shape, spec in EXTRA:
        out[name] = (shape, ctx.P(*spec))
    return {k: (shape, _divisible_spec(ctx._filter_spec(s, names), shape,
                                       mesh))
            for k, (shape, s) in out.items()}


def _leaf_value(i: int, shape, scale: float = 1.0) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(i).standard_normal(
        shape).astype(np.float32) * scale)


def _feedback_on_leaves(mesh) -> dict:
    """apply_error_feedback on DTensor leaves (each rank keeping its shard
    of the same whole tensors) against the call on the whole tensors."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import ctx
    from repro_torch.launch import op_analysis
    from repro_torch.train import compression as C
    cases = _leaf_cases(mesh)
    g, e, pl = {}, {}, {}
    for i, (k, (shape, spec)) in enumerate(sorted(cases.items())):
        pl[k] = ctx.placements(spec, mesh)
        g[k] = _leaf_value(2 * i, shape)
        # a residual of the size quantisation leaves
        e[k] = _leaf_value(2 * i + 1, shape, 1e-2)
    placed = lambda t: {k: distribute_tensor(  # noqa: E731
        v, mesh, pl[k], src_data_rank=None) for k, v in t.items()}
    dg, de = placed(g), placed(e)
    want_s, want_r = C.apply_error_feedback(g, e)
    got_s, got_r = C.apply_error_feedback(dg, de)
    leaves = {}
    for k in sorted(cases):
        shape = cases[k][0]
        leaves[k] = {
            "placements": str(pl[k]),
            "aligned": C.blocks_aligned(shape, pl[k], tuple(mesh.shape)),
            "split": any(p.is_shard() for p in pl[k]),
            "sent_equal": torch.equal(got_s[k].full_tensor(), want_s[k]),
            "resid_equal": torch.equal(got_r[k].full_tensor(), want_r[k]),
            "laid_out": got_s[k].placements == pl[k]
            and got_r[k].placements == pl[k]}
    # the split leaves whose shards are aligned: compressed with no
    # collective
    aligned = [k for k, v in leaves.items() if v["aligned"] and v["split"]]
    _, totals, _ = op_analysis.count(
        C.apply_error_feedback, {k: dg[k] for k in aligned},
        {k: de[k] for k in aligned})
    return {"leaves": leaves, "aligned_split": len(aligned),
            "aligned_collective_bytes": sum(totals.coll.values())}


def _cross_pod(mesh) -> dict:
    """cross_pod_allreduce_compressed over DTensor leaves, each pod holding
    its own whole gradients (pod p's drawn from seed p), against the mean
    of the two pods' round trips of the whole leaves."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.distributed import ctx
    from repro_torch.train import compression as C
    cases = _leaf_cases(mesh)
    pod = mesh.get_coordinate()[0]
    out = {}
    grads, want = {}, {}
    for i, (k, (shape, spec)) in enumerate(sorted(cases.items())):
        mine = _leaf_value(1000 * pod + i, shape)
        grads[k] = distribute_tensor(mine, mesh, ctx.placements(spec, mesh),
                                     src_data_rank=None)
        rt = [C.compress_roundtrip(_leaf_value(1000 * p + i, shape))
              for p in range(2)]
        want[k] = (rt[0] + rt[1]) * 0.5
    got = C.cross_pod_allreduce_compressed(grads, mesh)
    for k in sorted(cases):
        out[k] = {"equal": torch.equal(got[k].full_tensor(), want[k]),
                  "laid_out": got[k].placements == grads[k].placements,
                  "model_split": any(
                      p.is_shard() and n == "model" for p, n in zip(
                          grads[k].placements, ctx.axis_names(mesh)))}
    return out


def _compressed_steps(mesh, root: str) -> dict:
    """STEPS compressed train steps of reduced qwen2-1.5b on `mesh` from
    the reference's initial weights."""
    from repro_torch import configs
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import flatten, unflatten
    from repro_torch.train import step as S
    from repro_torch.train.optimizer import AdamWConfig
    cfg = train_config(configs, STEP_ARCH)
    model = get_model(cfg)
    with np.load(os.path.join(root, f"jax_{STEP_ARCH}.npz")) as f:
        jparams = params_from_numpy(unflatten(
            {tuple(k.split("|")): f[k] for k in f.files}), "cpu")
    tcfg = S.TrainConfig(opt=AdamWConfig(**OPT), grad_compression=True)
    state = S.new_train_state(place(mesh, jparams, model.param_specs()),
                              tcfg)
    step, losses = S.make_train_step(model, tcfg), []
    rows = {k: ctx.P(ROWS, None) for k in ("tokens", "labels")}
    with ctx.use_mesh(mesh):
        for i in range(STEPS):
            b = place(mesh, {k: torch.as_tensor(v).long() for k, v in
                             batch_np(cfg, i).items()}, rows)
            state, m = step(state, b)
            losses.append(float(m["loss"].full_tensor()
                                if type(m["loss"]).__name__ == "DTensor"
                                else m["loss"]))
    fp = flatten(state.params)
    lay = lambda t: all(x.placements == fp[k].placements  # noqa: E731
                        for k, x in flatten(t).items())
    return {"losses": losses, "ef_laid_out": lay(state.ef),
            "moments_laid_out": lay(state.opt.m) and lay(state.opt.v),
            "ef_nonzero": any(bool(x.to_local().any())
                              for x in flatten(state.ef).values()),
            "split_leaves": sum(any(p.is_shard() for p in x.placements)
                                for x in fp.values())}


def _worker(name: str, rank: int, root: str):
    """One rank of the 4-rank world `name`; rank 0 prints JSON."""
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_distributed("cpu", world_size=4, rank=rank,
                       store_dir=os.path.join(root, "pg_" + name))
    pod, data, model = MESHES[name]
    mesh = M.make_test_mesh(data, model, pod, device_type="cpu")
    res = {"feedback": _guard(lambda: _feedback_on_leaves(mesh)),
           "steps": _guard(lambda: _compressed_steps(mesh, root))}
    if pod > 1:
        res["cross_pod"] = _guard(lambda: _cross_pod(mesh))
    if rank == 0:
        print(json.dumps(res), flush=True)
    M.shutdown()


def _spawn(name: str, root: str) -> list:
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_mesh_compression as t; "
         f"t._worker({name!r}, {r}, {root!r})"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]


DRYRUN_CELL = """
import json
import torch
from repro_torch.launch import dryrun as D
from repro_torch.launch import op_analysis
from repro_torch.models.layers import flatten
seen = {}
count = op_analysis.count
def spy(fn, *args, **kw):
    out = count(fn, *args, **kw)
    state = out[0][0]
    pl = lambda t: {k: x.placements for k, x in flatten(t).items()}
    seen["ef_as_params"] = pl(state.ef) == pl(state.params)
    seen["moments_as_params"] = (pl(state.opt.m) == pl(state.params)
                                 == pl(state.opt.v))
    seen["split"] = sum(any(p.is_shard() for p in x)
                        for x in pl(state.ef).values())
    return out
op_analysis.count = spy
D._fake_world(8)
from repro_torch.launch.mesh import make_test_mesh
mesh = make_test_mesh(2, 2, 2, device_type="cpu")
rec = D.run_cell("qwen2-1.5b", "train_4k", False, grad_compression=True,
                 overrides=D.small_overrides("qwen2-1.5b"), mesh=mesh,
                 shape=D.SMALL_SHAPES["train"])
print(json.dumps({"status": rec["status"], **seen}))
"""


def _jax_losses(root: str) -> list:
    """The reference's unmeshed jitted compressed losses of STEPS steps of
    STEP_ARCH, its initial weights written for the workers."""
    import jax
    import repro.configs as jconfigs
    from repro.models.registry import get_model as j_get_model
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    from repro_torch.models.layers import flatten
    cfg = train_config(jconfigs, STEP_ARCH)
    model = j_get_model(cfg)
    tcfg = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT),
                             grad_compression=True)
    st = jstep.init_train_state(model, jax.random.PRNGKey(0), tcfg)
    np.savez(os.path.join(root, f"jax_{STEP_ARCH}.npz"), **{
        "|".join(k): v for k, v in
        flatten(jax.tree.map(np.asarray, st.params)).items()})
    fn, losses = jax.jit(jstep.make_train_step(model, tcfg)), []
    for i in range(STEPS):
        st, m = fn(st, batch_np(cfg, i))
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's results, the worlds one after another (4 processes at
    a time); the reference's losses taken first (their weights feed the
    workers), the dry-run cell in a process of its own beside the
    worlds."""
    root = str(tmp_path_factory.mktemp("mesh_compression"))
    out = {"reference": _jax_losses(root)}
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.environ.get("PYTHONPATH", "")]))
    dry = subprocess.Popen([sys.executable, "-c", DRYRUN_CELL], env=env,
                           stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    for name in MESHES:
        out[name] = _wait(_spawn(name, root))
    out["dryrun"] = _wait([dry])
    return out


def _brute_aligned(shape, pl, mesh_shape) -> bool:
    """Whether every rank's shard (DTensor's chunks) flattens into whole
    blocks of the global padded flattening, each at a multiple of BLOCK of
    the shard's own flattening."""
    from repro_torch.train.compression import BLOCK
    n = int(np.prod(shape))
    idx = np.arange(n).reshape(shape)
    for coord in itertools.product(*(range(m) for m in mesh_shape)):
        box = [[0, d] for d in shape]
        for i, p in enumerate(pl):
            if p.is_shard():
                off, d = box[p.dim]
                size = -(-d // mesh_shape[i])
                start = min(coord[i] * size, d)
                box[p.dim] = [off + start, min(size, d - start)]
        loc = idx[tuple(slice(a, a + m) for a, m in box)].reshape(-1)
        if loc.size == 0:
            continue
        loc = np.concatenate([loc, np.full((-loc.size) % BLOCK, -1)])
        for row in loc.reshape(-1, BLOCK):
            want = np.arange(row[0], row[0] + BLOCK)
            want[want >= n] = -1
            if row[0] % BLOCK or not np.array_equal(row, want):
                return False
    return True


def test_block_rule_against_brute_force():
    """blocks_aligned on random shapes and placements: never aligned where
    a shard breaks a block (uneven splits refused), and exact wherever
    every split divides its dimension."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.train.compression import blocks_aligned
    rng = np.random.default_rng(0)
    sizes = (1, 2, 3, 4, 5, 6, 8, 12, 16, 32, 64, 96, 128, 256)
    seen = {True: 0, False: 0}
    for _ in range(1500):
        nd = int(rng.integers(1, 4))
        shape = tuple(int(rng.choice(sizes)) for _ in range(nd))
        mesh_shape = tuple(int(rng.choice((1, 2, 2, 4)))
                           for _ in range(int(rng.integers(1, 4))))
        options = [Replicate()] + [Shard(d) for d in range(nd)]
        pl = tuple(options[int(rng.integers(len(options)))]
                   for _ in mesh_shape)
        ways: dict = {}
        for p, m in zip(pl, mesh_shape):
            if p.is_shard() and m > 1:
                ways[p.dim] = ways.get(p.dim, 1) * m
        even = all(shape[d] % w == 0 for d, w in ways.items())
        rule = blocks_aligned(shape, pl, mesh_shape)
        brute = _brute_aligned(shape, pl, mesh_shape)
        assert brute or not rule, (shape, pl, mesh_shape)
        if even:
            assert rule == brute, (shape, pl, mesh_shape)
        seen[rule] += 1
    assert min(seen.values()) > 100, seen


@pytest.mark.parametrize("mesh", list(MESHES))
def test_error_feedback_on_dtensors_equals_unmeshed(runs, mesh):
    """The compressed gradient and the residual of every leaf bit-equal to
    the unmeshed call's and laid out as the gradient; both kinds of
    leaf (shards aligned, quantised alone, and not) among them."""
    r = runs[mesh]["feedback"]
    assert "error" not in r, r
    bad = {k: v for k, v in r["leaves"].items()
           if not (v["sent_equal"] and v["resid_equal"] and v["laid_out"])}
    assert not bad, bad
    kinds = {(v["split"], v["aligned"]) for v in r["leaves"].values()}
    assert {(True, True), (True, False)} <= kinds, kinds
    for name, _, _ in EXTRA:
        assert name in r["leaves"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_aligned_leaves_compress_without_collectives(runs, mesh):
    """Leaves whose shards hold whole blocks are quantised on each rank's
    shard: no collective runs."""
    r = runs[mesh]["feedback"]
    assert "error" not in r, r
    assert r["aligned_split"] > 0
    assert r["aligned_collective_bytes"] == 0, r


@pytest.mark.parametrize("mesh", list(MESHES))
def test_compressed_steps_match_the_jax_package(runs, mesh):
    """STEPS compressed steps on the mesh within LOSS_TOL of the JAX
    package's unmeshed jitted compressed steps, the residuals and moments
    in their parameters' placements."""
    r = runs[mesh]["steps"]
    assert "error" not in r, r
    want = runs["reference"]
    assert len(r["losses"]) == len(want) == STEPS
    for x, y in zip(r["losses"], want):
        assert abs(x - y) < LOSS_TOL, (r["losses"], want)
    assert r["ef_laid_out"] and r["moments_laid_out"], r
    assert r["ef_nonzero"] and r["split_leaves"] > 0, r


def test_cross_pod_mean_of_whole_leaf_round_trips(runs):
    """cross_pod_allreduce_compressed on (2, 1, 2) over leaves split over
    `model`, each pod its own gradients: every leaf bit-equal to the mean
    of the two pods' round trips of the whole leaf, laid out as it
    came."""
    r = runs["2x1x2"]["cross_pod"]
    assert "error" not in r, r
    bad = {k: v for k, v in r.items() if not (v["equal"] and v["laid_out"])}
    assert not bad, bad
    assert sum(v["model_split"] for v in r.values()) > 10


def test_dryrun_compressed_cell_keeps_residuals_laid_out(runs):
    """run_cell(..., grad_compression=True) on a (2, 2, 2) mesh of 8 fake
    ranks: the step's new residuals and moments in their parameters'
    placements."""
    r = runs["dryrun"]
    assert r["status"] == "ok", r
    assert r["ef_as_params"] and r["moments_as_params"], r
    assert r["split"] > 0, r
