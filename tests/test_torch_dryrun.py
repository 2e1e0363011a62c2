"""The port's dry run against the reference's, on the CPU.

The four cells of tests/test_dryrun_small.py (one dense, one MoE train
cell, an MLA decode and an SSM decode), with its overrides and shrunken
shapes, on a (2, 2, 2) ("pod", "data", "model") mesh: the port traces each
on the `fake` backend's world of 8 under `FakeTensorMode`
(`launch.dryrun.run_small_cells`), the reference compiles each in a
process with 8 host devices.  Under JAX 0.9 `jax.make_mesh` makes
`Explicit` axes, which the reference's `with_sharding_constraint` refuses,
so the reference's process builds the mesh with `Auto` axes (the JAX
package is not edited).  Each side runs in a process of its own: one
default process group, one JAX device count, a process.

The reference's records are committed (FIXTURE), so the port is held to
them without a JAX process, here and on a machine without JAX
(chip_smoke.py's phase 4f, on that machine's PyTorch).  One test holds the
live reference to the fixture.  Remake it with

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_dryrun.py --write-fixture

Held (`launch.dryrun.check_small`): the model FLOPs and the per-device
parameter bytes exactly; the per-device matrix-product FLOPs within 10 %
(a larger miss would mean the port shards differently from the
reference); a train cell's gradient reduction among the collectives.
Also `op_analysis` on a known product and a known all-gather (exact), and
`--list` against the reference's.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
FIXTURE = os.path.join(HERE, "data", "torch_dryrun_reference.json")
CELLS = [("qwen2-1.5b", "train"), ("qwen3-moe-235b-a22b", "train"),
         ("deepseek-v2-236b", "decode"), ("mamba2-2.7b", "decode")]
WRITE_FIXTURE = ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
                 "tests/test_torch_dryrun.py --write-fixture")

_COUNTS = r"""
import json, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import distribute_tensor
from repro_torch.distributed.ctx import P, placements
from repro_torch.launch import mesh as M, op_analysis as O
M.init_distributed(fake=True, world_size=8)
mesh = M.make_test_mesh(2, 2, 2, device_type="cpu")
with FakeTensorMode():
    a, b = torch.empty(64, 4096), torch.empty(4096, 4096)
    da = distribute_tensor(a, mesh, placements(P(("pod", "data"), None), mesh),
                           src_data_rank=None)
    db = distribute_tensor(b, mesh, placements(P(None, "model"), mesh),
                           src_data_rank=None)
    _, t, _ = O.count(lambda: (da @ db).redistribute(
        mesh, placements(P(("pod", "data"), None), mesh)))
    _, plain, _ = O.count(lambda: a @ b)
M.shutdown()
print(json.dumps({"sharded": O.analyze(t), "plain": O.analyze(plain)}))
"""


# tests/test_dryrun_small.py's overrides and shapes, for either package
_SETUP = r"""
import dataclasses, json, sys
pkg = sys.argv[1]
cfgmod = __import__(pkg + ".configs", fromlist=["get_config"])
mc = __import__(pkg + ".models.config", fromlist=["ShapeCell"])
def overrides(arch):
    cfg = cfgmod.get_config(arch)
    o = dict(n_layers=2, d_model=64, d_ff=128, vocab=512, head_dim=16,
             n_heads=4, n_kv_heads=2)
    if cfg.family == "ssm":
        o = dict(n_layers=2, d_model=64, vocab=512,
                 ssm=dataclasses.replace(cfg.ssm, d_state=16, head_dim=16))
    if cfg.family == "moe":
        o = dict(n_layers=2, d_model=64, d_ff=64, vocab=512, head_dim=16,
                 n_heads=4, n_kv_heads=2,
                 moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                         d_ff_expert=32, router_group=64))
        if cfg.mla is not None:
            o["mla"] = mc.MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                    rope_head_dim=8, nope_head_dim=16,
                                    v_head_dim=16)
            o.update(head_dim=24, n_heads=4, n_kv_heads=4)
    return o
mc.SHAPES["train_4k"] = mc.ShapeCell("train_4k", 128, 8, "train")
mc.SHAPES["decode_32k"] = mc.ShapeCell("decode_32k", 128, 8, "decode")
SHAPE = {"train": "train_4k", "decode": "decode_32k"}
CELLS = [tuple(c.split(":")) for c in sys.argv[2:]]
"""

_REFERENCE = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import math
import jax
""" + _SETUP + r"""
from repro.distributed import ctx
from repro.launch import hlo_analysis
from repro.launch.dryrun import build_cell_fn
mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
out = {}
for arch, kind in CELLS:
    with ctx.use_mesh(mesh):
        fn, args, in_sh, out_sh, cfg, shape = build_cell_fn(
            arch, SHAPE[kind], mesh, overrides=overrides(arch))
        compiled = jax.jit(fn, in_shardings=in_sh,
                           out_shardings=out_sh).lower(*args).compile()
    res = hlo_analysis.analyze(compiled.as_text())
    params, psh = ((args[0].params, in_sh[0].params) if kind == "train"
                   else (args[0], in_sh[0]))
    pbytes = sum(math.prod(s.shard_shape(a.shape)) * a.dtype.itemsize
                 for a, s in zip(jax.tree.leaves(params),
                                 jax.tree.leaves(psh)))
    tokens = shape.global_batch * (shape.seq_len if kind != "decode" else 1)
    out[arch] = {"flops": res["flops"], "coll": res["collectives"],
                 "param_bytes": int(pbytes),
                 "model_flops": float((6 if kind == "train" else 2)
                                      * cfg.n_active_params() * tokens)}
print(json.dumps(out))
"""

_PORT = r"""
import json, sys
import torch
torch.set_num_threads(1)
from repro_torch.launch import dryrun
cells = [tuple(c.split(":")) for c in sys.argv[2:]]
print(json.dumps(dryrun.run_small_cells(cells)))
"""


def _start(script: str, pkg: str, cells) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
               JAX_PLATFORMS="cpu")
    return subprocess.Popen(
        [sys.executable, "-c", script, pkg, *(f"{a}:{k}" for a, k in cells)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)


def _result(p: subprocess.Popen) -> dict:
    out, err = p.communicate(timeout=600)
    assert p.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def _fixture() -> dict:
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def procs():
    """Every process of this file, started at once: the reference's four
    cells in one, the port's one a cell, the counting check, and the two
    `--list`s."""
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return {"ref": _start(_REFERENCE, "repro", CELLS),
            "port": [_start(_PORT, "repro_torch", [c]) for c in CELLS],
            "counts": _start(_COUNTS, "repro_torch", []),
            "list": [subprocess.Popen(
                [sys.executable, "-m", f"{pkg}.launch.dryrun", "--list"],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                env=env) for pkg in ("repro", "repro_torch")]}


@pytest.fixture(scope="module")
def records(procs):
    """(the committed reference records, port's) per-cell results."""
    got = {}
    for p in procs["port"]:
        got.update(_result(p))
    return _fixture()["records"], got


@pytest.mark.parametrize("arch,kind", CELLS)
def test_dryrun_cells_match_reference(records, arch, kind):
    from repro_torch.launch.dryrun import check_small
    ref, port = records[0][arch], records[1][arch]
    assert port["status"] == "ok" and port["use_kernels"] is False
    assert port["chips"] == 8
    got = check_small(port, ref)
    assert got["ok"], got
    assert port["roofline"]["model_flops"] == ref["model_flops"]
    assert port["per_device"]["param_bytes"] == ref["param_bytes"]
    rel = port["per_device"]["flops"] / ref["flops"] - 1.0
    assert abs(rel) <= 0.10, (port["per_device"]["flops"], ref["flops"])
    if kind == "train":
        # the gradients' reduction over the batch's devices
        assert ref["coll"].get("all-reduce", 0) > 0
        coll = port["collectives"]
        assert coll.get("all-reduce", 0) + coll.get("reduce-scatter", 0) > 0
        assert port["per_device"]["collective_bytes"] > 0
    r = port["roofline"]
    assert r["dominant"] in ("compute", "memory", "collective")
    assert port["per_device"]["peak_bytes"] >= \
        port["per_device"]["argument_bytes"] > 0


@pytest.mark.parametrize("arch,kind", CELLS)
def test_live_reference_gives_the_fixture(procs, arch, kind):
    """The reference's process, run now, gives the committed records (XLA
    compiles the same program to the same counts), so the fixture stands
    for the reference."""
    live = _result(procs["ref"])[arch]
    fixed = _fixture()["records"][arch]
    assert live == fixed, (live, fixed)


def test_fixture_names_its_origin():
    fix = _fixture()
    assert fix["command"] == WRITE_FIXTURE
    assert fix["jax"] and fix["cells"] == [list(c) for c in CELLS]
    assert set(fix["records"]) == {a for a, _ in CELLS}


def test_op_analysis_counts_a_product_and_a_gather(procs):
    """[64, 4096] x [4096, 4096] with rows over pod x data (4) and columns
    over model (2): one rank's product is [16, 4096] x [4096, 2048], and
    gathering the columns back is one all-gather of a [16, 4096] f32
    result; unsharded, the whole product counts."""
    res = _result(procs["counts"])
    s, p = res["sharded"], res["plain"]
    assert s["flops"] == 2 * 16 * 4096 * 2048
    assert s["collectives"] == {"all-gather": 16 * 4096 * 4}
    assert s["counts"] == {"all-gather": 1}
    assert p["flops"] == 2 * 64 * 4096 * 4096
    assert p["bytes"] == 4 * (64 * 4096 + 4096 * 4096 + 64 * 4096)
    assert p["collective_bytes"] == 0


def test_list_matches_reference(procs):
    from repro_torch.configs import SHAPES
    outs = [p.communicate(timeout=120) + (p.returncode,)
            for p in procs["list"]]
    for out, err, rc in outs:
        assert rc == 0, err[-2000:]
    assert outs[1][0] == outs[0][0]
    assert len(outs[1][0].splitlines()) == 10 * len(SHAPES)


def write_fixture() -> None:
    """Run the reference's process over the four cells and write its
    records, the JAX version and this command to FIXTURE."""
    import jax
    rec = _result(_start(_REFERENCE, "repro", CELLS))
    os.makedirs(os.path.dirname(FIXTURE), exist_ok=True)
    with open(FIXTURE, "w") as f:
        json.dump({"command": WRITE_FIXTURE, "jax": jax.__version__,
                   "mesh": "(2, 2, 2) ('pod', 'data', 'model'), Auto axes, "
                           "8 host devices",
                   "cells": [list(c) for c in CELLS], "records": rec},
                  f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    if sys.argv[1:] == ["--write-fixture"]:
        write_fixture()
    else:
        raise SystemExit(f"usage: {WRITE_FIXTURE}")
