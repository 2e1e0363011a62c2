"""deepseek-v2 trained on a mesh of 4 gloo ranks, on the CPU.

Reduced deepseek-v2 (MLA with 4 heads and 8 routed experts, so `model`
splits both on either mesh; one shared expert; the dense first layer),
checkpointed with blockwise attention of 8-row blocks and routing groups
of 8 tokens, on a (2, 2) and a (1, 4) ("data", "model") mesh:

  * the loss and every gradient leaf of `step.value_and_grad` within
    GRAD_RTOL of the leaf's largest magnitude of the unmeshed port's on the
    same weights and batch, every gradient in its parameter's placements
    (MLA's low-rank projections `wq_a` / `wkv_a`, replicated over
    `model`, take the heads' partial sums, the rope key's among them; the
    shared experts' and the dense layer's FSDP splits are reduce-
    scattered);
  * STEPS AdamW steps on the mesh from the reference's initial weights
    (carried across by `models/convert.py`) within LOSS_TOL of the JAX
    package's unmeshed jitted `make_train_step` on the same batches, run
    in the test's own process;
  * the checkpointed loss's backward in a thread of its own (as autograd
    runs it on the card) bit-equal to the backward in the forward's
    thread: the recompute keeps the forward's mesh;
  * `moe.routes_agree` comparing a token's experts as a set (deepseek-v2's
    160 experts at published widths put near-ties inside the top 6).

The harness is tests/test_torch_mesh_train.py's: each world is 4
processes on a `file://` store, the worlds one after the other.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from test_torch_mesh_train import _wait

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
ARCH = "deepseek-v2-236b"
GRAD_RTOL = 1e-5
LOSS_TOL = 5e-3
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, total_steps=10)
ROWS = ("pod", "data")


def train_config(configs):
    """Reduced deepseek-v2 from `configs` (either package's): checkpointed
    layers, 8-row attention blocks, routing groups of 8 tokens."""
    cfg = configs.reduced(ARCH).replace(remat=True, attn_block=8)
    return cfg.replace(moe=dataclasses.replace(cfg.moe, router_group=8))


def _worker(name: str, rank: int, root: str):
    """One rank of the 4-rank world `name`; rank 0 prints JSON."""
    import test_torch_mesh_train as H
    from repro_torch import configs
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place
    from repro_torch.launch import mesh as M
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import unflatten
    from repro_torch.train import step as S
    from repro_torch.train.optimizer import AdamWConfig
    torch.set_num_threads(1)
    M.init_distributed("cpu", world_size=4, rank=rank,
                       store_dir=os.path.join(root, "pg_" + name))
    mesh = M.make_test_mesh(*MESHES[name], device_type="cpu")
    gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
    cfg = train_config(configs)
    model = get_model(cfg)
    res = {"grads": H._guard(lambda: H._grads_against_plain(
        model, cfg, mesh, gen)),
        "threaded_backward": H._guard(lambda: H._threaded_backward(
            model, cfg, mesh, gen))}

    def steps():
        with np.load(os.path.join(root, "jax_params.npz")) as f:
            jparams = params_from_numpy(unflatten(
                {tuple(k.split("|")): f[k] for k in f.files}), "cpu")
        tcfg = S.TrainConfig(opt=AdamWConfig(**OPT))
        state = S.new_train_state(place(mesh, jparams, model.param_specs()),
                                  tcfg)
        step, losses = S.make_train_step(model, tcfg), []
        rows = {k: ctx.P(ROWS, None) for k in ("tokens", "labels")}
        with ctx.use_mesh(mesh):
            for i in range(STEPS):
                b = place(mesh, {k: torch.as_tensor(v).long() for k, v in
                                 H.batch_np(cfg, i).items()}, rows)
                state, m = step(state, b)
                losses.append(float(H._whole(m["loss"])))
        return losses
    res["losses"] = H._guard(steps)
    if rank == 0:
        print(json.dumps(res), flush=True)
    M.shutdown()


def _spawn(name: str, root: str) -> list:
    src = os.path.join(ROOT, "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_mesh_train_mla as t; "
         f"t._worker({name!r}, {r}, {root!r})"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]


def _jax_state(root: str):
    """The reference's initial train state, its weights written for the
    workers, and its jitted step."""
    import jax
    import repro.configs as jconfigs
    from repro.models.registry import get_model as j_get_model
    from repro.train import optimizer as jopt
    from repro.train import step as jstep
    from repro_torch.models.layers import flatten
    cfg = train_config(jconfigs)
    model = j_get_model(cfg)
    tcfg = jstep.TrainConfig(opt=jopt.AdamWConfig(**OPT))
    st = jstep.init_train_state(model, jax.random.PRNGKey(0), tcfg)
    np.savez(os.path.join(root, "jax_params.npz"), **{
        "|".join(k): v for k, v in
        flatten(jax.tree.map(np.asarray, st.params)).items()})
    return cfg, jax.jit(jstep.make_train_step(model, tcfg)), st


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's results, the worlds one after another, and the
    reference's losses, taken while the first world runs."""
    import test_torch_mesh_train as H
    root = str(tmp_path_factory.mktemp("mesh_train_mla"))
    cfg, fn, st = _jax_state(root)
    first = _spawn("2x2", root)
    ref = []
    for i in range(STEPS):
        st, m = fn(st, H.batch_np(cfg, i))
        ref.append(float(m["loss"]))
    out = {"reference": ref, "2x2": _wait(first)}
    out["1x4"] = _wait(_spawn("1x4", root))
    return out


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_gradients_on_the_mesh_as_unmeshed(runs, mesh):
    """The loss and every leaf (MLA's projections, the shared expert, the
    dense first layer, the routed experts) within GRAD_RTOL of the
    unmeshed port's; leaves split over the mesh among them."""
    r = runs[mesh]["grads"]
    assert "error" not in r, r
    plain, got = r["loss"]
    assert abs(got - plain) <= GRAD_RTOL * abs(plain), r["loss"]
    assert max(r["errs"].values()) <= GRAD_RTOL, r["errs"]
    assert r["zero_leaves_zero"]
    assert r["sharded_leaves"] > 0
    for leaf in ("layers/attn/wq_a", "layers/attn/wkv_a",
                 "layers/attn/wkv_b", "layers/moe/shared/w_gate",
                 "dense_layers/mlp/w_down", "dense_layers/attn/wo"):
        assert leaf in r["errs"], sorted(r["errs"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_gradients_laid_out_as_parameters(runs, mesh):
    """No partial sum left; the layouts come from all-reduces (the
    low-rank projections over `model`) and reduce-scatters (FSDP and
    head splits)."""
    r = runs[mesh]["grads"]
    assert "error" not in r, r
    assert r["partial"] == [] and r["layout"], r["partial"]
    assert r["counts"].get("all-reduce", 0) > 0, r["counts"]
    assert r["counts"].get("reduce-scatter", 0) > 0, r["counts"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_steps_match_the_jax_package(runs, mesh):
    got, want = runs[mesh]["losses"], runs["reference"]
    assert isinstance(got, list), got
    assert len(got) == len(want) == STEPS
    for x, y in zip(got, want):
        assert abs(x - y) < LOSS_TOL, (got, want)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_mla_backward_in_another_thread_keeps_the_mesh(runs, mesh):
    """MLA's `to_layout` of the rope key and the shared experts'
    `constrain`s hold in a recompute run in the backward's own thread."""
    r = runs[mesh]["threaded_backward"]
    assert r == {"equal": True}, r


def test_routes_agree_compares_sets_of_experts():
    """Two runs' expert choices agree when a token's k experts are the same
    set in another order (two of them nearly tied inside the top k), and
    differ when the set differs, for the tokens whose k-th and (k+1)-th
    probabilities are apart by more than the margin."""
    from repro_torch.models import moe
    top = torch.tensor([[0.30, 0.20, 0.20, 0.10],    # decided (0.2 > 0.1)
                        [0.30, 0.20, 0.20, 0.10],    # decided
                        [0.40, 0.20, 0.15, 0.15]])   # k = 3: a tie, left out
    want = torch.tensor([[1, 2, 3], [1, 2, 3], [0, 1, 2]])
    got = torch.tensor([[1, 3, 2], [1, 2, 4], [0, 1, 3]])
    r = moe.routes_agree([(None, got)], [(top, want)], 3, 1e-6)
    assert r == {"compared": 2, "left_out": 1, "differ": 1, "reordered": 1}
