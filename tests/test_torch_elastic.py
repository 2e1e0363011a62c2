"""Training on a mesh, checkpointed and restored onto meshes of other sizes,
and a reduced model served on a mesh: gloo ranks on the CPU.

The reference's elastic test (tests/test_elastic.py) on the port: reduced
stablelm trains 3 steps on a (2, 2) ("data", "model") mesh of 4 ranks (the
train state placed by `train_state_specs`, the batch split over `data`),
is checkpointed (`train.checkpoint.save` gathers the DTensors whole, rank
0 writes), and trains 2 more steps on the same mesh: the reference
trajectory.  The checkpoint is restored with `restore(shardings=)` onto a
(2, 1) mesh of 2 ranks and a (1, 1) mesh of one, and each trains the same
2 steps: their losses must be within the reference's 5e-3 of the (2, 2)
trajectory, which must itself be within 5e-3 of the same 5 steps run
without a mesh; and the loss on the first batch at the end below the
first step's.  Each world is its own processes (one default process group a
process) on a `file://` store under the test's temporary directory.

Beside it: `cross_pod_allreduce_compressed` on a (2, 1, 1) ("pod", "data",
"model") mesh of 2 ranks against the single-rank compress round trip (the
mean of the two ranks' round trips), and the same reduced model served on
the (2, 2) mesh (a prefill and 4 decode steps with DTensor caches) against
the unmeshed run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
MESHES = {"a": ((2, 2), 4), "b": ((2, 1), 2), "c": ((1, 1), 1)}
LOSS_TOL = 5e-3          # the reference's (tests/test_elastic.py)
SERVE_ATOL = 1e-4


def _worker(phase: str, rank: int, root: str):
    """One rank of world `phase`: train (a: 3 steps, save, 2 more; b, c:
    restore, 2 steps, the loss on batch 0), and on a the serving check,
    on b the cross-pod check; rank 0 prints the results as JSON."""
    from repro_torch.configs import reduced
    from repro_torch.distributed import ctx
    from repro_torch.distributed.ctx import P
    from repro_torch.distributed.sharding import (place, put,
                                                  shardings_for_shaped,
                                                  tree_map)
    from repro_torch.launch import mesh as M
    from repro_torch.models import get_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import compression
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.step import (TrainConfig, init_train_state,
                                        make_train_step, train_state_specs,
                                        trainable)
    torch.set_num_threads(1)
    shape, world = MESHES[phase]
    M.init_distributed("cpu", world_size=world, rank=rank,
                       store_dir=os.path.join(root, "pg_" + phase))
    mesh = M.make_test_mesh(*shape, device_type="cpu")
    cfg = reduced("stablelm-1.6b")
    model = get_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(lr=1e-3, warmup_steps=1,
                                       total_steps=20))
    base = init_train_state(model, torch.Generator().manual_seed(0), tcfg,
                            device="cpu")
    shardings = shardings_for_shaped(mesh, base, train_state_specs(model,
                                                                   tcfg))
    rows = {"tokens": P(("pod", "data"), None),
            "labels": P(("pod", "data"), None)}

    def batch(i):
        t = torch.randint(0, cfg.vocab, (8, 65),
                          generator=torch.Generator().manual_seed(100 + i))
        return place(mesh, {"tokens": t[:, :-1], "labels": t[:, 1:]}, rows)

    def whole(x):
        return x.full_tensor() if type(x).__name__ == "DTensor" else x

    def run(state, n, start):
        step, losses = make_train_step(model, tcfg), []
        with ctx.use_mesh(mesh):
            for i in range(n):
                state, m = step(state, batch(start + i))
                losses.append(float(whole(m["loss"])))
        return state, losses

    res = {}
    ckdir = os.path.join(root, "ckpt")
    if phase == "a":
        # serving: a prefill and 4 decode steps, meshed against unmeshed
        params = model.compute_params(model.init(
            torch.Generator().manual_seed(1), device="cpu"))
        tok = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(2))
        want = [model.prefill(params, {"tokens": tok})]
        cache = model.init_cache(2, 16, device="cpu")
        for t in range(4):
            lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
            want.append(lg)
        pp = place(mesh, params, model.param_specs())
        got = []
        with ctx.use_mesh(mesh):
            ptok = place(mesh, {"tokens": tok}, {"tokens": rows["tokens"]})
            got.append(whole(model.prefill(pp, ptok)))
            pc = place(mesh, model.init_cache(2, 16, device="cpu"),
                       model.cache_spec())
            for t in range(4):
                lg, pc = model.decode_step(pp, pc, ptok["tokens"][:, t:t + 1],
                                           t)
                got.append(whole(lg))
        res["serve_max_abs"] = max(float((g - w).abs().max())
                                   for g, w in zip(got, want))
        res["cache_placements"] = str(pc["k"].placements)
        state = tree_map(put, base, shardings)
        trainable(state.params)
        state, res["phase_a"] = run(state, 3, 0)
        ckpt.save(ckdir, 3, state)
        _, res["continued"] = run(state, 2, 3)
    else:
        if phase == "c":
            # the same 5 steps without a mesh, from the same state
            step, res["unmeshed"] = make_train_step(model, tcfg), []
            plain = init_train_state(model, torch.Generator().manual_seed(0),
                                     tcfg, device="cpu")
            for i in range(5):
                t = torch.randint(0, cfg.vocab, (8, 65),
                                  generator=torch.Generator().manual_seed(
                                      100 + i))
                plain, m = step(plain, {"tokens": t[:, :-1],
                                        "labels": t[:, 1:]})
                res["unmeshed"].append(float(m["loss"]))
        state = ckpt.restore(ckdir, 3, base, shardings=shardings)
        res["restored_type"] = type(state.params["embed"]["tok"]).__name__
        state, res["continued"] = run(state, 2, 3)
        with ctx.use_mesh(mesh):
            _, m = make_train_step(model, tcfg)(state, batch(0))
        res["final_loss_batch0"] = float(whole(m["loss"]))
    if phase == "b":
        pods = M.make_mesh((2, 1, 1), ("pod", "data", "model"),
                           device_type="cpu")
        g = {r: torch.randn(5, 300, generator=torch.Generator().manual_seed(
            7 + r)) for r in range(2)}
        got = compression.cross_pod_allreduce_compressed({"w": g[rank]},
                                                         pods)["w"]
        rt = [compression.compress_roundtrip(g[r]) for r in range(2)]
        want = (rt[0] + rt[1]) * 0.5
        res["cross_pod_equal"] = bool(torch.equal(got, want))
        same = compression.cross_pod_allreduce_compressed({"w": g[rank]},
                                                          mesh)
        res["no_pod_identity"] = same["w"] is g[rank]
    if rank == 0:
        print(json.dumps(res), flush=True)
    M.shutdown()


def _spawn(phase: str, root: str) -> list:
    src = os.path.join(HERE, "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_elastic as t; "
         f"t._worker({phase!r}, {r}, {root!r})"], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(MESHES[phase][1])]


def _wait(procs) -> dict:
    # every rank's pipes drained at once: a rank that fills a pipe no one
    # reads blocks, and the others then wait for it in a collective
    with ThreadPoolExecutor(len(procs)) as pool:
        outs = list(pool.map(
            lambda p: p.communicate(timeout=300) + (p.returncode,), procs))
    for out, err, rc in outs:
        assert rc == 0, err[-3000:]
    return json.loads(outs[0][0].strip().splitlines()[-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("elastic"))
    a = _wait(_spawn("a", root))
    b, c = _spawn("b", root), _spawn("c", root)
    return {"a": a, "b": _wait(b), "c": _wait(c)}


def test_elastic_restore_across_mesh_sizes(runs):
    ref = runs["a"]["continued"]
    # the (2, 2) trajectory is the unmeshed one, within the same bound
    for x, y in zip(runs["a"]["phase_a"] + ref, runs["c"]["unmeshed"]):
        assert abs(x - y) < LOSS_TOL, (runs["a"], runs["c"]["unmeshed"])
    assert runs["a"]["phase_a"][-1] < runs["a"]["phase_a"][0]
    for name in ("b", "c"):
        got = runs[name]["continued"]
        assert runs[name]["restored_type"] == "DTensor"
        assert len(got) == len(ref) == 2
        for x, y in zip(ref, got):
            assert abs(x - y) < LOSS_TOL, (name, ref, got)
        assert runs[name]["final_loss_batch0"] < runs["a"]["phase_a"][0]


def test_cross_pod_allreduce_compressed_on_two_pods(runs):
    assert runs["b"]["cross_pod_equal"]
    assert runs["b"]["no_pod_identity"]


def test_reduced_model_served_on_a_mesh(runs):
    assert runs["a"]["serve_max_abs"] < SERVE_ATOL
    assert "Shard(dim=2)" in runs["a"]["cache_placements"]
