"""The long-context serving cells' paths (prefill_32k, decode_32k,
long_500k) against the reference, on the CPU at narrow widths.

(a) the rotary table of every (rope_theta, rotary dim) the ten configs
use, over long_500k's 524288 positions: frequencies and angles bit-equal
to the reference's jitted ones, cos and sin within 1 ulp; (b) a dense
decode step at position 32767 (decode_32k's last) of qwen2's head dim 128
and theta 1e6 on a seeded cache; (c) the reduced zamba2's decode step at
position 524287 over a seeded 524288-position cache; (d) the SSD scan over
128 chunks; (e) reduced prefills of 8192 tokens, last-token logits; each
against the reference package on one set of weights (PRNGKey(0) through
`models/convert.py`) and numpy draws, within 1e-4 (the reference's own
tolerance between its kernels and its jnp paths; (b) within 1e-5, where
one ulp of a frequency shows); (f) on 4
gloo ranks, the meshed prefills (the SSD scan on each rank's heads and
batch rows, a rank's heads in one of zamba2's two groups on (1, 4)) and
decode steps near the end of a long seeded cache on (2, 2) and (1, 4),
equal to the unmeshed run of the same weights within 1e-4; (g) the smoke
test's plain versions over row and chunk blocks equal to the whole ones.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import layers as JL
from repro.models import ssm as jssm
from repro.models.registry import get_model as j_get_model
import repro_torch.configs as pconfigs
from repro_torch.models import get_model, layers as PL, ssm as pssm
from repro_torch.models.convert import params_from_numpy

torch.set_num_threads(1)
T = torch.tensor
HERE = os.path.dirname(os.path.abspath(__file__))
LONG_500K = 524288
DECODE_32K = 32768
TOL = 1e-4


def _rope_pairs() -> list:
    out = set()
    for cfg in pconfigs.ARCHS.values():
        if cfg.mla is not None:
            out.add((cfg.rope_theta, cfg.mla.rope_head_dim))
        elif cfg.family in ("dense", "vlm", "hybrid", "moe"):
            out.add((cfg.rope_theta, cfg.hd))
    return sorted(out)


def _ulps(a, b) -> int:
    def key(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.abs(key(a) - key(b)).max())


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _weights(arch_id: str, **changes):
    """(reference config, port config, reference params as numpy) of the
    reduced config with `changes`, from PRNGKey(0)."""
    jcfg = jconfigs.reduced(arch_id).replace(**changes)
    pcfg = pconfigs.reduced(arch_id).replace(**changes)
    return jcfg, pcfg, _np_tree(j_get_model(jcfg).init(jax.random.PRNGKey(0)))


def _seeded_cache(shapes: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
            for k, s in shapes.items()}


# ---------------------------------------------------------------------------
# (a) the rotary table
# ---------------------------------------------------------------------------

def test_rope_pairs_cover_the_configs():
    assert (1e6, 128) in _rope_pairs() and (1e4, 64) in _rope_pairs()
    assert (1e4, 112) in _rope_pairs() and len(_rope_pairs()) == 5


@pytest.mark.parametrize("theta,dim", _rope_pairs())
def test_rope_table_is_the_references(theta, dim):
    """The reference's expressions (`layers.rope_angles`) under jit, as its
    models run them: frequencies and angles bit-equal, cos / sin within
    one ulp, at every position of long_500k."""
    pos = np.arange(LONG_500K, dtype=np.int32)

    @jax.jit
    def ref(p):
        freqs = theta ** (-jnp.arange(0, dim, 2, jnp.float32) / dim)
        return freqs, p.astype(jnp.float32)[..., None] * freqs
    jf, jang = ref(jnp.asarray(pos))
    jcos, jsin = jax.jit(lambda p: JL.rope_angles(p, dim, theta))(
        jnp.asarray(pos))
    tpos = torch.from_numpy(pos.astype(np.int64))
    assert np.array_equal(PL.rope_freqs(dim, theta).numpy(), np.asarray(jf))
    assert np.array_equal(PL.rope_table(tpos, dim, theta).numpy(),
                          np.asarray(jang))
    cos, sin = PL.rope_angles(tpos, dim, theta)
    assert _ulps(cos.numpy(), jcos) <= 1
    assert _ulps(sin.numpy(), jsin) <= 1


# ---------------------------------------------------------------------------
# (b), (c) decode at the last position of a long seeded cache
# ---------------------------------------------------------------------------

def _decode_both(arch_id: str, changes: dict, seq: int, seed: int):
    """One decode step at position seq - 1 through both packages on one
    seeded cache: (port logits, reference logits, port cache, reference
    cache)."""
    jcfg, pcfg, jp = _weights(arch_id, **changes)
    jmodel, model = j_get_model(jcfg), get_model(pcfg)
    cache = _seeded_cache(model.cache_shape(1, seq), seed)
    tok = np.array([[7]], dtype=np.int32)
    want, jcache = jax.jit(jmodel.decode_step)(
        jp, {k: jnp.asarray(v) for k, v in cache.items()}, tok,
        jnp.int32(seq - 1))
    pcache = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    got, pcache = model.decode_step(params_from_numpy(jp, device="cpu"),
                                    pcache, T(tok, dtype=torch.int64),
                                    seq - 1)
    return got, np.asarray(want), pcache, _np_tree(jcache)


def test_dense_decode_at_32767_matches_reference():
    """qwen2's rotary (head dim 128, theta 1e6) at decode_32k's last
    position: the logits within 1e-5 of their largest magnitude, and the K
    and V written there within 1e-5 (with a frequency one ulp off, as
    torch's f32 `pow` made it, the written K is 1.9e-3 off)."""
    got, want, pcache, jcache = _decode_both(
        "qwen2-1.5b", {"head_dim": 128}, DECODE_32K, 11)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= 1e-5 * float(np.abs(want).max()), err
    for k in ("k", "v"):
        np.testing.assert_allclose(pcache[k][:, :, -1].numpy(),
                                   jcache[k][:, :, -1], rtol=1e-5, atol=1e-5)


def test_hybrid_decode_at_524287_matches_reference():
    """The reduced zamba2 (two shared-attention sites) at long_500k's last
    position over a seeded cache of 524288 positions: logits and every
    state leaf within 1e-4."""
    got, want, pcache, jcache = _decode_both("zamba2-7b", {}, LONG_500K, 12)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    for k, v in jcache.items():
        g = pcache[k][:, :, -1] if k.startswith("shared") else pcache[k]
        w = v[:, :, -1] if k.startswith("shared") else v
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# (d), (e) the SSD scan over 128 chunks; prefills of 8192 tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
def test_ssd_scan_over_128_chunks_matches_reference(use_kernels):
    rng = np.random.default_rng(13)
    b, s, h, p, g, n, chunk = 2, 1024, 4, 8, 2, 16, 8
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)) - 2)).astype(
        np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    cm = (rng.standard_normal((b, s, g, n)) * 0.3).astype(np.float32)
    y_ref, st_ref = jax.jit(functools.partial(
        jssm.ssd_scan, chunk=chunk, use_pallas=False))(x, dt, a, bm, cm)
    y, st = pssm.ssd_scan(*(T(v) for v in (x, dt, a, bm, cm)), chunk=chunk,
                          use_kernels=use_kernels)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("arch_id", ["qwen2-1.5b", "mamba2-2.7b",
                                     "zamba2-7b"])
def test_prefill_of_8192_matches_reference(arch_id):
    """Last-token logits of one 8192-token sequence (256 SSD chunks of the
    reduced configs' 32; flash's plain version over 8192 rows)."""
    jcfg, pcfg, jp = _weights(arch_id)
    tok = np.random.default_rng(14).integers(0, jcfg.vocab, (1, 8192),
                                             dtype=np.int32)
    want = jax.jit(j_get_model(jcfg).prefill)(jp, {"tokens": tok})
    got = get_model(pcfg).prefill(params_from_numpy(jp, device="cpu"),
                                  {"tokens": T(tok, dtype=torch.int64)})
    assert got.shape == (1, 1, pcfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# (f) the meshed prefill and long-cache decode on 4 gloo ranks
# ---------------------------------------------------------------------------

MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
MESH_ARCHS = ("qwen2-1.5b", "mamba2-2.7b", "zamba2-7b")
MESH_BATCH, MESH_SEQ, MESH_CACHE, MESH_STEPS = 4, 128, 4096, 3


def mesh_config(arch: str):
    """The reduced config; zamba2's attention with 16 heads (its specs
    split them over `model`, as the published 32) and its SSD in 2 groups
    (on (1, 4) each rank's heads lie in one)."""
    cfg = pconfigs.reduced(arch)
    if arch == "zamba2-7b":
        cfg = cfg.replace(n_heads=16, n_kv_heads=16, ssm=dataclasses.replace(
            cfg.ssm, n_groups=2))
    return cfg


def _whole(x):
    return x.full_tensor() if type(x).__name__ == "DTensor" else x


def _worker(name: str, rank: int, root: str):
    """One rank of the 4-rank world `name`: for each architecture the
    meshed prefill and MESH_STEPS decode steps at the end of a seeded
    MESH_CACHE-position cache (each rank's shards copied from the whole
    one), against the unmeshed run; rank 0 prints JSON."""
    from repro_torch.distributed import ctx
    from repro_torch.distributed.sharding import place
    from repro_torch.launch import mesh as M
    torch.set_num_threads(1)
    M.init_distributed("cpu", world_size=4, rank=rank,
                       store_dir=os.path.join(root, "pg_" + name))
    mesh = M.make_test_mesh(*MESHES[name], device_type="cpu")
    rows = {"tokens": ctx.P(("pod", "data"), None)}
    res = {}
    for arch in MESH_ARCHS:
        cfg = mesh_config(arch)
        model = get_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), device="cpu")
        meshed = model.init(torch.Generator().manual_seed(0), device="cpu",
                            mesh=mesh)
        tok = torch.randint(0, cfg.vocab, (MESH_BATCH, MESH_SEQ),
                            generator=torch.Generator().manual_seed(1))
        want = model.prefill(params, {"tokens": tok})
        with ctx.use_mesh(mesh):
            got = _whole(model.prefill(meshed, place(mesh, {"tokens": tok},
                                                     rows)))
        cache = {k: torch.from_numpy(v) for k, v in _seeded_cache(
            model.cache_shape(MESH_BATCH, MESH_CACHE), 2).items()}
        mcache = {k: ctx.from_local(t.to_local().clone(), mesh,
                                    t.placements, t.shape)
                  for k, t in place(mesh, cache,
                                    model.cache_spec()).items()}
        dec = []
        for t in range(MESH_STEPS):
            pos = MESH_CACHE - MESH_STEPS + t
            w, cache = model.decode_step(params, cache, tok[:, t:t + 1], pos)
            with ctx.use_mesh(mesh):
                g, mcache = model.decode_step(
                    meshed, mcache,
                    place(mesh, {"tokens": tok[:, t:t + 1]}, rows)["tokens"],
                    pos)
            dec.append(float((_whole(g) - w).abs().max()))
        res[arch] = {
            "prefill": float((got - want).abs().max()), "decode": dec,
            "state": {k: float((_whole(mcache[k]) - cache[k]).abs().max())
                      for k in cache},
            "cache": {k: str(v.placements) for k, v in mcache.items()}}
    if rank == 0:
        print(json.dumps(res), flush=True)
    M.shutdown()


def _spawn(name: str, root: str) -> list:
    src = os.path.join(HERE, "..", "src")
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [src, HERE, os.environ.get("PYTHONPATH", "")]))
    return [subprocess.Popen(
        [sys.executable, "-c", f"import test_torch_long_context as t; "
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
    root = str(tmp_path_factory.mktemp("long_context"))
    return {name: _wait(_spawn(name, root)) for name in MESHES}


@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_meshed_prefill_as_unmeshed(runs, mesh, arch):
    assert runs[mesh][arch]["prefill"] < TOL, runs[mesh][arch]


@pytest.mark.parametrize("arch", MESH_ARCHS)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_meshed_long_cache_decode_as_unmeshed(runs, mesh, arch):
    """The cache's positions split over `model` (the recurrent states'
    heads), each step at the end of it written on the rank that holds the
    position: logits and every state leaf as the unmeshed run's."""
    r = runs[mesh][arch]
    assert len(r["decode"]) == MESH_STEPS
    assert max(r["decode"]) < TOL, r
    assert max(r["state"].values()) < TOL, r
    kv = [k for k in r["cache"] if k in ("k", "v", "shared_k", "shared_v")]
    assert all("Shard(dim=2)" in r["cache"][k] for k in kv), r["cache"]


# ---------------------------------------------------------------------------
# (g) the smoke test's blocked plain versions
# ---------------------------------------------------------------------------

def _smoke():
    """The repo root's chip_smoke.py (which needs no card to import)."""
    root = os.path.dirname(HERE)
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke
    return chip_smoke


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_over_row_blocks_equals_whole(causal):
    from repro_torch.kernels import ref
    S = _smoke()
    g = torch.Generator().manual_seed(15)
    q = torch.randn((2, 100, 6, 16), generator=g)
    k, v = (torch.randn((2, 100, 2, 16), generator=g) for _ in range(2))
    want = ref.flash_attention(q, k, v, scale=0.25, causal=causal)
    got = S._flash_plain(q, k, v, 0.25, causal, max_scores=2 * 6 * 100 * 7)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_ssd_plain_over_chunk_blocks_equals_whole():
    from repro_torch.kernels import ref
    S = _smoke()
    args = S._ssd_inputs(torch.Generator().manual_seed(16),
                         (2, 5, 8, 4, 3, 2, 5), torch.device("cpu"))
    np.testing.assert_allclose(S._ssd_plain(*args, max_chunks=3).numpy(),
                               ref.ssd_intra_chunk(*args).numpy(), rtol=1e-6,
                               atol=1e-6)


def test_long_context_script_imports_no_jax():
    """scripts/long_context_cards.py and what it imports (chip_smoke.py,
    the port) load without JAX or the JAX package."""
    root = os.path.dirname(HERE)
    code = ("import sys\n"
            f"sys.path.insert(0, {os.path.join(root, 'scripts')!r})\n"
            "import long_context_cards\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
            "assert 'repro_torch.models.ssm' in sys.modules\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(root, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
