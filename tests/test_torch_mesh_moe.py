"""The MoE decoders served on a mesh of 4 gloo ranks, on the CPU.

qwen3-moe and deepseek-v2 at reduced widths with 16 query heads (so the
heads divide the reference's 16-way `model` axis and their specs split
them, as at the published widths: qwen3-moe's 4 KV heads and deepseek's
MLA heads go to the ranks with their query heads), routing groups of 8
tokens (so a prefill's groups split over `data`), each on a (1, 4) and a
(2, 2) ("data", "model") mesh: the parameters made on the mesh
(`Model.init(..., mesh=)`, each rank drawing its own shards), a prefill
and 4 decode steps on caches made on the mesh (`init_cache(..., mesh=)`),
through both dispatch modes, held to the port's unmeshed run of the same weights on the CPU within
SERVE_ATOL (tests/test_torch_elastic.py's), and the experts chosen equal
wherever a token's k-th and (k+1)-th router probabilities are more than
TIE_MARGIN apart (tests/test_torch_moe.py's rule).  Each rank's shards of
the meshed init equal its shards of the unmeshed init placed by the specs
(`sharding.place`), in f32 and in bf16 drawn a slab at a time.  One python
a rank on a `file://` store under the test's temporary directory, as
`torchrun` starts them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest
import torch

from repro_torch.distributed.ctx import P

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
SERVE_ATOL = 1e-4
TIE_MARGIN = 1e-6
BATCH, SEQ, DECODE = 2, 16, 4
# (shape, spec) of tensors made on a mesh, split evenly, unevenly (6 over
# 4: chunks 2, 2, 2, 0), over both axes, over an axis of size 1 and over
# an axis the mesh lacks
BOX_CASES = {
    "rows_data": ((8, 3), P("data", None)),
    "rows_model": ((8, 3), P("model", None)),
    "uneven_model": ((6, 5), P(None, "model")),
    "uneven_data": ((6, 5), P("data", None)),
    "both": ((4, 8, 2), P("data", "model", None)),
    "joint": ((8, 3), P(("data", "model"), None)),
    "absent_axis": ((4, 4), P("pod", "model")),
}


def mesh_config(arch: str):
    """The reduced config with 16 query heads (qwen3-moe: 4 KV heads) and
    routing groups of 8 tokens."""
    from repro_torch.configs import reduced
    cfg = reduced(arch)
    kv = 4 if cfg.mla is None else 16
    return cfg.replace(n_heads=16, n_kv_heads=kv, moe=dataclasses.replace(
        cfg.moe, router_group=8))


def _whole(x):
    return x.full_tensor() if type(x).__name__ == "DTensor" else x


def _serve(model, params, tok, mesh=None):
    """(prefill logits, each decode step's logits, routes) on `mesh` (None:
    unmeshed), the caches made there."""
    from repro_torch.distributed import ctx
    from repro_torch.models import moe
    with ctx.use_mesh(mesh), moe.record_routes() as routes:
        out = [_whole(model.prefill(params, {"tokens": tok}))]
        cache = model.init_cache(BATCH, SEQ, device="cpu", mesh=mesh)
        for t in range(DECODE):
            lg, cache = model.decode_step(params, cache, tok[:, t:t + 1], t)
            out.append(_whole(lg))
        routes = [(_whole(a), _whole(b)) for a, b in routes]
    return out, routes, cache


def _worker(name: str, rank: int, root: str):
    """One rank of the 4-rank world `name`: for each architecture the init
    check and the meshed serve against the unmeshed; rank 0 prints JSON."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place, tree_leaves
    from repro_torch.launch import mesh as M
    from repro_torch.launch import op_analysis
    from repro_torch.models import get_model, layers as L, moe
    torch.set_num_threads(1)
    M.init_distributed("cpu", world_size=4, rank=rank,
                       store_dir=os.path.join(root, "pg_" + name))
    mesh = M.make_test_mesh(*MESHES[name], device_type="cpu")
    res = {}
    for arch in ARCHS:
        cfg = mesh_config(arch)
        model = get_model(cfg)
        gen = lambda: torch.Generator().manual_seed(0)  # noqa: E731
        params = model.init(gen(), device="cpu")
        meshed = model.init(gen(), device="cpu", mesh=mesh)
        # the same draws, each rank's shards
        want = tree_leaves(place(mesh, params, model.param_specs()))
        got = tree_leaves(meshed)
        init_equal = all(g.placements == w.placements
                         and torch.equal(g.to_local(), w.to_local())
                         for g, w in zip(got, want, strict=True))
        # bf16, drawn a slab of one row at a time
        chunk, L._INIT_CHUNK = L._INIT_CHUNK, 16
        try:
            bf = get_model(cfg.replace(param_dtype="bfloat16"))
            want16 = tree_leaves(place(mesh, bf.init(gen(), device="cpu"),
                                       bf.param_specs()))
            got16 = tree_leaves(bf.init(gen(), device="cpu", mesh=mesh))
        finally:
            L._INIT_CHUNK = chunk
        init16_equal = all(torch.equal(g.to_local(), w.to_local())
                           for g, w in zip(got16, want16, strict=True))
        tok = torch.randint(0, cfg.vocab, (BATCH, SEQ),
                            generator=torch.Generator().manual_seed(2))
        plain, plain_routes, _ = _serve(model, params, tok)
        out, routes, cache = _serve(model, meshed, tok, mesh)
        # the sort dispatch on the same weights
        srt = get_model(cfg.replace(moe=dataclasses.replace(
            cfg.moe, dispatch="sort")))
        sort_plain, _, _ = _serve(srt, params, tok)
        sort_out, _, _ = _serve(srt, meshed, tok, mesh)
        # counting a prefill's collectives inside the mesh's block leaves
        # the block usable (plain tensors still taken as replicated)
        with ctx.use_mesh(mesh):
            _, totals, _ = op_analysis.count(model.prefill, meshed,
                                             {"tokens": tok})
            again = _whole(model.prefill(meshed, {"tokens": tok}))
        # a decode step's collectives at two cache lengths: the cache
        # stays split over its positions, so what moves does not grow
        # with it
        dec = []
        for n in (SEQ, 4 * SEQ):
            c = model.init_cache(BATCH, n, device="cpu", mesh=mesh)
            with ctx.use_mesh(mesh):
                _, t, _ = op_analysis.count(model.decode_step, meshed, c,
                                            tok[:, :1], 0)
            dec.append(dict(t.coll))
        res[arch] = {
            "init_equal": init_equal, "init_bf16_equal": init16_equal,
            "leaves": len(got),
            "sharded_leaves": sum(any(p.is_shard() for p in g.placements)
                                  for g in got),
            "max_abs": [float((g - w).abs().max())
                        for g, w in zip(out, plain)],
            "sort_max_abs": [float((g - w).abs().max())
                             for g, w in zip(sort_out, sort_plain)],
            "counted": dict(totals.counts),
            "after_count_equal": bool(torch.equal(again, out[0])),
            "finite": all(bool(torch.isfinite(g[..., :cfg.vocab]).all())
                          for g in out),
            "routes": moe.routes_agree(routes, plain_routes, cfg.moe.top_k,
                                       TIE_MARGIN),
            "n_routes": len(routes), "decode_coll": dec,
            "cache": {k: str(v.placements) for k, v in cache.items()}}
    res["boxes"] = {n: _boxes(m) for n, m in
                    ((name, mesh),
                     ("4x1", M.make_test_mesh(4, 1, device_type="cpu")))}
    if rank == 0:
        print(json.dumps(res), flush=True)
    M.shutdown()


def _boxes(mesh) -> dict:
    """For each of BOX_CASES, whether this rank's shard made alone
    (`ctx.made_on_mesh`, from the block `ctx.shard_box` names) equals its
    shard of the whole tensor placed by the spec (`sharding.place`), values
    and placements."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place
    out = {}
    for key, (shape, spec) in BOX_CASES.items():
        whole = torch.arange(float(torch.Size(shape).numel())).reshape(shape)
        got = ctx.made_on_mesh(
            lambda box: whole[tuple(slice(a, a + n) for a, n in box)]
            .clone(), shape, spec, mesh)
        want = place(mesh, {"x": whole}, {"x": spec})["x"]
        out[key] = (got.placements == want.placements
                    and torch.equal(got.to_local(), want.to_local()))
    return out


def _spawn(name: str, root: str) -> list:
    src = os.path.join(HERE, "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_mesh_moe as t; "
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


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each world's results, the worlds one after another (4 processes at
    a time)."""
    root = str(tmp_path_factory.mktemp("mesh_moe"))
    return {name: _wait(_spawn(name, root)) for name in MESHES}


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_init_on_the_mesh_is_the_placed_init(runs, mesh, arch):
    r = runs[mesh][arch]
    assert r["init_equal"] and r["init_bf16_equal"]
    assert r["sharded_leaves"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_served_on_the_mesh_as_unmeshed(runs, mesh, arch):
    r = runs[mesh][arch]
    assert r["finite"]
    assert len(r["max_abs"]) == 1 + DECODE
    assert max(r["max_abs"]) < SERVE_ATOL, r["max_abs"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_sort_dispatch_on_the_mesh_as_unmeshed(runs, mesh, arch):
    """The sort dispatch (`dispatch="sort"`: global capacity, a gather into
    each expert's buffer, the combine in expert order) on the same
    weights."""
    r = runs[mesh][arch]
    assert len(r["sort_max_abs"]) == 1 + DECODE
    assert max(r["sort_max_abs"]) < SERVE_ATOL, r["sort_max_abs"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_counted_prefill_keeps_the_mesh_block(runs, mesh, arch):
    """`op_analysis.count` of a meshed prefill inside `use_mesh` counts its
    collectives (the combine's partial sums reduced over `model`), and a
    prefill after it in the same block gives the same logits."""
    r = runs[mesh][arch]
    assert r["counted"].get("all-reduce", 0) > 0, r["counted"]
    assert r["after_count_equal"]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_expert_choices_equal(runs, mesh, arch):
    r = runs[mesh][arch]
    cfg = mesh_config(arch)
    assert r["n_routes"] == (1 + DECODE) * (cfg.n_layers
                                            - cfg.moe.first_dense)
    assert r["routes"]["differ"] == 0, r["routes"]
    assert r["routes"]["compared"] > 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_caches_split_positions_over_model(runs, mesh, arch):
    """The caches' positions over `model` (and on (2, 2) the batch over
    `data`), as `cache_spec` lays them out."""
    for pl in runs[mesh][arch]["cache"].values():
        assert "Shard(dim=2)" in pl, pl
        if mesh == "2x2":
            assert "Shard(dim=1)" in pl, pl


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_decode_keeps_the_cache_split(runs, mesh, arch):
    """A decode step attends on each rank's positions of the cache (GQA's
    keys and values, MLA's latents and rope keys) and combines the ranks'
    outputs by their logsumexp (`ctx.on_key_shards`): its collectives are
    the same at a 4x longer cache (gathering the cache, or the scores
    over it, would move more)."""
    short, long = runs[mesh][arch]["decode_coll"]
    assert short and short == long, (short, long)


@pytest.mark.parametrize("case", list(BOX_CASES))
@pytest.mark.parametrize("mesh", [*MESHES, "4x1"])
def test_made_on_mesh_is_placed(runs, mesh, case):
    """`ctx.made_on_mesh` on a (1, 4), (2, 2) and (4, 1) mesh (an axis of
    size 1 splits nothing) gives each rank the shard `sharding.place`
    gives it."""
    world = "1x4" if mesh == "4x1" else mesh
    assert runs[world]["boxes"][mesh][case]
