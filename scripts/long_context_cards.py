#!/usr/bin/env python3
"""The reference's long-context serving cells across the cards of one host.

    torchrun --nproc-per-node 4 scripts/long_context_cards.py
    torchrun --nproc-per-node 4 scripts/long_context_cards.py --device cpu
    torchrun --nproc-per-node 4 scripts/long_context_cards.py --parts decode

(the second a rehearsal on gloo ranks at reduced widths; `--parts` a
comma-separated subset of PARTS).

One process a card, NCCL (`launch.mesh.init_distributed`; the loopback for
NCCL's bootstrap unless NCCL_SOCKET_IFNAME is set).  qwen2-1.5b (dense, GQA
12:2 at D 128), mamba2-2.7b (SSD, 80 heads of 64, N 128) and zamba2-7b (81
SSD layers of 112 heads, N 64, 2 groups; a shared attention block of 32
heads of 112 at 13 sites) at their published widths, random weights from a
seed, each rank drawing only its shards (`Model.init(..., mesh=)`), on
("data", "model") meshes whose `model` ranks split the heads as the
models' spec trees say:

  kernels  -- flash and SSD at the shapes a rank of (2, 2) gives them in
              prefill_32k's prefills (16 sequences of 32768; qwen2's 12
              query heads, which the specs keep whole, zamba2's 16 of 32;
              SSD in 2048 chunks of 256), held to their plain versions
              and timed (`chip_smoke.long_kernel_shapes`), the shapes
              spread over the ranks;
  contract -- the f32 prefill (`chip_smoke.contract_config`) of
              CONTRACT_BATCH x 32768 tokens at CONTRACT_LAYERS (zamba2:
              one group of mamba layers and its shared-attention site) on
              (2, 2) and (4, 1): the last logits within
              chip_smoke.CONTRACT_RTOL of their largest magnitude of the
              one-card unmeshed prefill's (every rank runs that on its own
              card), one SSD launch a mamba layer and one flash launch an
              attention layer on every rank;
  prefill  -- prefill_32k: 32 x 32768 seeded tokens on (2, 2), 16
              sequences a `data` rank, in the configs' types (f32
              parameters cast once to bf16), at the most layers (at most
              the configured count) whose bf16 parameters a card, the
              working memory measured at CONTRACT_LAYERS and HEADROOM stay
              under PEAK_CAP (depth is cut, never width or batch): one
              warm-up and one timed prefill with exact launch counts on
              every rank, tokens/s over the 4 cards, peak memory a card,
              and one more prefill under the profiler (busy time as the
              union of the kernels' intervals, idle share, NCCL by kind,
              device ms of flash, SSD and matrix products);
  decode   -- decode_32k of qwen2-1.5b on (2, 2) (batch over `data`, the
              cache's positions over `model`) and long_500k of zamba2-7b
              on (1, 4): the cache filled by a seeded draw at the scale of
              K and V (`fill_cache`; the reference has no call that fills
              a cache from a prompt), then DECODE_TOKENS steps from
              position seq_len - DECODE_TOKENS, each writing its token on
              the rank that holds the position.  First the f32 contract at
              CONTRACT_LAYERS (decode_32k at DECODE_CONTRACT_BATCH of its
              128 sequences, long_500k whole) against one card on the same
              seeded cache, within CONTRACT_RTOL of each step's logits'
              largest magnitude; then the cell at full depth in bf16:
              greedy tokens, ms a token, peak memory a card, one profiled
              step.

Rank 0 prints the cards' name and power limit, one JSON line a part, and
last `{"ok": ..., "device": ...}`; the exit code is 0 only if every gate
held on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import zlib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.configs import SHAPES, get_config, reduced  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed.sharding import (bytes_per_device,  # noqa: E402
                                              place, tree_leaves)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.models import get_model  # noqa: E402

PARTS = ("kernels", "contract", "prefill", "decode")
ARCHS = ("qwen2-1.5b", "mamba2-2.7b", "zamba2-7b")
MESHES = {"(2, 2)": (2, 2), "(4, 1)": (4, 1), "(1, 4)": (1, 4)}
CONTRACT_MESHES = ("(2, 2)", "(4, 1)")
PREFILL_MESH = "(2, 2)"
DECODE_CELLS = {"decode_32k": ("qwen2-1.5b", "(2, 2)"),
                "long_500k": ("zamba2-7b", "(1, 4)")}
CONTRACT_BATCH = 4
DECODE_CONTRACT_BATCH = 8
DECODE_TOKENS = 4
PEAK_CAP = 72e9          # bytes of device memory a card may hold at peak
HEADROOM = 4e9           # kept free beyond the measured working memory
TOKENS = {"tokens": ctx.P(("pod", "data"), None)}
KV_LEAVES = ("k", "v", "shared_k", "shared_v")
# the rehearsal's sizes (--device cpu): the cells' positions, and the
# batch of its prefills and caches
CPU_SIZES = {"prefill_32k": 256, "decode_32k": 512, "long_500k": 2048}
CPU_BATCH = 8


def cpu_config(arch: str):
    """The rehearsal's config: reduced; zamba2's attention with 16 heads
    (so the specs split them, as its 32 at the published width) and its
    SSD in 2 groups (so a rank's heads lie in one group on (1, 4))."""
    cfg = reduced(arch)
    if arch == "zamba2-7b":
        cfg = cfg.replace(n_heads=16, n_kv_heads=16, ssm=dataclasses.replace(
            cfg.ssm, n_groups=2))
    return cfg


def contract_layers(cfg) -> int:
    """The contract's depth: 2 layers; the hybrid's first group of mamba
    layers and its shared-attention site."""
    return cfg.attn_every if cfg.family == "hybrid" else 2


def whole(x):
    return x.full_tensor() if type(x).__name__ == "DTensor" else x


def gen(dev, seed: int = 0):
    return torch.Generator(device=dev).manual_seed(seed)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()


def peak(dev):
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else None


def local_bytes(tree) -> int:
    return sum(t.to_local().numel() * t.element_size()
               if type(t).__name__ == "DTensor" else t.numel()
               * t.element_size() for t in tree_leaves(tree))


def gathered(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def launches_ok(counts: dict, cfg, dev) -> bool:
    """One SSD launch a mamba layer and one flash launch an attention layer
    on the card (`chip_smoke.expected_launches`); none on the CPU."""
    return counts == (S.expected_launches(cfg) if dev.type == "cuda" else {})


def prefill(model, params, tok, dev, mesh=None) -> tuple:
    """(last logits as a whole tensor, wall s, launch counts) of one
    prefill of `tok` on `mesh` (None: unmeshed)."""
    batch = {"tokens": tok} if mesh is None else place(mesh, {"tokens": tok},
                                                       TOKENS)
    with ctx.use_mesh(mesh):
        if mesh is not None:
            dist.barrier()
        sync(dev)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits = model.prefill(params, batch)
        sync(dev)
        wall = time.perf_counter() - t0
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        logits = whole(logits)
    return logits, wall, counts


# --------------------------------------------------------------------------
# kernels: flash and SSD at a rank's shapes
# --------------------------------------------------------------------------

def rank_shapes(b: int, s: int, n_model: int) -> tuple[dict, dict]:
    """(flash, SSD) shapes a rank of a (b_ranks, n_model) mesh gives the
    kernels in a prefill of `b` sequences a `data` rank, `s` positions:
    flash (b, s, heads, KV heads, D) with the heads split where the spec
    tree splits them (`layers.head_spec`: 16 divides them), SSD (B, C, Q,
    H, P, G, N) with the heads split over `model` and the groups the
    rank's heads read."""
    from repro_torch.models.layers import _model_divisible
    flash, ssd = {}, {}
    for arch in ARCHS:
        cfg = get_config(arch)
        if cfg.n_heads:
            h, kv = cfg.n_heads, cfg.n_kv_heads
            if _model_divisible(h):
                h, kv = h // n_model, kv // n_model
            flash[f"{arch}, a rank of (2, 2)"] = (b, s, h, kv, cfg.hd)
        if cfg.ssm is not None:
            sc = cfg.ssm
            heads = sc.expand * cfg.d_model // sc.head_dim
            local = heads // n_model
            groups = max(sc.n_groups * local // heads, 1)
            ssd[f"{arch}, a rank of (2, 2)"] = (
                b, s // sc.chunk, sc.chunk, local, sc.head_dim, groups,
                sc.d_state)
    return flash, ssd


def kernels_part(dev, rank: int, world: int) -> dict:
    """Each rank checks and times its share of the rank shapes; rank 0's
    line holds them all."""
    b = SHAPES["prefill_32k"].global_batch // MESHES[PREFILL_MESH][0]
    flash, ssd = rank_shapes(b, SHAPES["prefill_32k"].seq_len,
                             MESHES[PREFILL_MESH][1])
    jobs = [("flash", k) for k in flash] + [("ssd", k) for k in ssd]
    mine = jobs[rank::world]
    res = S.long_kernel_shapes(
        dev, {k: flash[k] for kind, k in mine if kind == "flash"},
        {k: ssd[k] for kind, k in mine if kind == "ssd"})
    out: dict = {"flash_attention": {}, "ssd_intra_chunk": {}}
    for r in gathered(res):
        for kind in out:
            out[kind].update(r[kind])
    return {"part": "kernels", **out, "ok": True}


# --------------------------------------------------------------------------
# contract: the f32 prefill on a mesh against one card
# --------------------------------------------------------------------------

def contract(arch: str, cfg, meshes: dict, dev, batch: int, seq: int):
    """A line a mesh of CONTRACT_MESHES, each yielded when its run ends."""
    ccfg = S.contract_config(cfg.replace(n_layers=contract_layers(cfg)))
    model = get_model(ccfg)
    tok = torch.randint(0, ccfg.vocab, (batch, seq), generator=gen(dev, 1),
                        device=dev)
    reset_peak(dev)
    params = model.init(gen(dev), device=dev)
    want, one_wall, counts0 = prefill(model, params, tok, dev)
    want = want[..., :ccfg.vocab]
    one_peak = peak(dev)
    del params
    for name in CONTRACT_MESHES:
        reset_peak(dev)
        params = model.init(gen(dev), device=dev, mesh=meshes[name])
        got, wall, counts = prefill(model, params, tok, dev, meshes[name])
        got = got[..., :ccfg.vocab]
        err = float((got - want).abs().max())
        tol = S.CONTRACT_RTOL * float(want.abs().max())
        del params
        yield {"part": "contract", "model": arch, "mesh": name,
               "n_layers": ccfg.n_layers, "compute_dtype": "float32",
               "batch": batch, "seq": seq,
               "prefill_vs_one_card": {"max_abs_err": err, "tol": tol},
               "launches": counts, "one_card_launches": counts0,
               "prefill_s": wall, "one_card_prefill_s": one_wall,
               "one_card_max_memory_allocated": one_peak,
               "max_memory_allocated": peak(dev),
               "ok": err <= tol and bool(torch.isfinite(got).all())
               and launches_ok(counts, ccfg, dev)
               and launches_ok(counts0, ccfg, dev)}


# --------------------------------------------------------------------------
# prefill: prefill_32k at the most layers a card holds
# --------------------------------------------------------------------------

def held_bytes(cfg, mesh, n: int) -> int:
    """Bytes a card holds of the first `n` layers' parameters once cast to
    the compute type (`Model.compute_params`; norms and gains stay f32, a
    few MB)."""
    m = get_model(cfg.replace(n_layers=n, param_dtype=cfg.compute_dtype))
    return bytes_per_device(m.abstract_params(), mesh, m.param_specs())


def working_bytes(cfg, mesh, dev, tok) -> int:
    """The working memory a card of one prefill of `tok` at the contract's
    depth in the config's types: its peak beyond the parameters a card."""
    model = get_model(cfg.replace(n_layers=contract_layers(cfg)))
    reset_peak(dev)
    params = model.compute_params(model.init(gen(dev), device=dev,
                                             mesh=mesh))
    held = local_bytes(params)
    prefill(model, params, tok, dev, mesh)
    top = peak(dev)
    del params
    return max(gathered(top - held))


def pick_depth(cfg, mesh, working: int) -> int:
    """The most layers, at most the configured count, whose parameters a
    card in f32 while they are drawn (and their compute-type copy made) and
    in the compute type beside `working` and HEADROOM stay under PEAK_CAP;
    the hybrid's depth a whole number of groups plus its trailing layers
    where all fit."""
    for n in range(cfg.n_layers, 0, -1):
        m = get_model(cfg.replace(n_layers=n))
        f32 = bytes_per_device(m.abstract_params(), mesh, m.param_specs())
        low = held_bytes(cfg, mesh, n)
        if max(f32 + low, low + working) + HEADROOM <= PEAK_CAP:
            return n
    raise ValueError("not even one layer fits")


def deep_prefill(arch: str, cfg, mesh, dev, batch: int, seq: int) -> dict:
    tok = torch.randint(0, cfg.vocab, (batch, seq), generator=gen(dev, 1),
                        device=dev)
    working = None
    n = cfg.n_layers
    if dev.type == "cuda":
        working = working_bytes(cfg, mesh, dev, tok)
        n = pick_depth(cfg, mesh, working)
    cfg = cfg.replace(n_layers=n)
    model = get_model(cfg)
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.compute_params(model.init(gen(dev), device=dev,
                                             mesh=mesh))
    sync(dev)
    init_s = time.perf_counter() - t0
    prefill(model, params, tok, dev, mesh)                    # warm-up
    logits, wall, counts = prefill(model, params, tok, dev, mesh)
    walls = gathered(wall)
    v = cfg.vocab
    finite = bool(torch.isfinite(logits[..., :v]).all())
    top = peak(dev)
    placed = place(mesh, {"tokens": tok}, TOKENS)

    def run():
        with ctx.use_mesh(mesh):
            model.prefill(params, placed)
    prof = profile_call(run, dev)
    peaks = gathered(top)
    return {"part": "prefill", "cell": "prefill_32k", "model": arch,
            "mesh": PREFILL_MESH, "n_layers": n,
            "n_layers_configured": get_config(arch).n_layers,
            "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "batch": batch, "seq": seq,
            "working_bytes_a_card": working,
            "param_bytes_a_card": local_bytes(params), "init_s": init_s,
            "prefill_s": wall, "slowest_rank_prefill_s": max(walls),
            "prefill_tokens_per_s": batch * seq / max(walls),
            "launches": counts, "profile": prof,
            "max_memory_allocated": top,
            "max_memory_allocated_every_rank": peaks,
            "ok": launches_ok(counts, cfg, dev) and finite
            and tuple(logits.shape) == (batch, 1, cfg.padded_vocab)
            and (dev.type != "cuda" or max(peaks) <= PEAK_CAP)}


def profile_call(fn, dev) -> dict | None:
    """One more call of `fn` under the profiler on every rank (its
    collectives need them all), rank 0's numbers: wall; the device's busy
    time as the union of its kernels' intervals (NCCL's kernels run on a
    stream of their own, and one lasts from its rank's arrival to the last
    rank's, so it is mostly waiting), with and without NCCL's kernels, and
    the idle shares they leave; NCCL by kind; summed device ms of flash,
    SSD, matrix products and the rest; None on the CPU."""
    if dev.type != "cuda":
        return None
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dist.barrier()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith("nccl:")]
    nccl: dict = {}
    classes = {"flash": 0.0, "ssd": 0.0, "gemm": 0.0, "other": 0.0}
    for e in kernels:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        name = e.name.lower()
        if "nccl" in name:
            kind = next((k for k in S.NCCL_KINDS if k.lower() in name),
                        "other")
            d = nccl.setdefault(kind, {"device_ms": 0.0, "count": 0})
            d["device_ms"] += ms
            d["count"] += 1
            continue
        label = next((c for c, parts in (
            ("flash", ("flash",)), ("ssd", ("ssd_intra_kernel",)),
            ("gemm", S.GEMM_PARTS)) if any(p in name for p in parts)),
            "other")
        classes[label] += ms
    busy = S.busy_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    compute = S.busy_ms([(e.time_range.start, e.time_range.end)
                         for e in kernels if "nccl" not in e.name.lower()])
    idle = gathered(1.0 - busy / wall_ms)
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": idle[0],
            "device_idle_share_every_rank": idle,
            "compute_busy_ms": compute,
            "compute_idle_share": 1.0 - compute / wall_ms,
            "nccl_by_kind": nccl,
            "nccl_ms": sum(d["device_ms"] for d in nccl.values()),
            "kernel_ms_by_class": classes}


# --------------------------------------------------------------------------
# decode: decode_32k and long_500k on a seeded cache
# --------------------------------------------------------------------------

def fill_cache(model, params, cache: dict, dev, mesh, seed: int) -> dict:
    """Every leaf of `cache` (made on `mesh`, or whole) drawn from a seed:
    each rank draws its own shard a layer at a time, from a generator
    seeded by the leaf and the shard's place (replicas draw alike), the
    standard normal times the leaf's scale: the root mean square of what
    one decode step at position 0 wrote there (K and V at position 0, the
    recurrent states whole; summed over the ranks)."""
    b = next(iter(cache.values())).shape[1]
    tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    if mesh is not None:
        tok = place(mesh, {"tokens": tok}, TOKENS)["tokens"]
    with ctx.use_mesh(mesh):
        model.decode_step(params, cache, tok, 0)
    for name, leaf in cache.items():
        local = leaf.to_local() if mesh is not None else leaf
        box = (ctx.shard_box(leaf.shape, leaf.placements, mesh)
               if mesh is not None else [(0, n) for n in leaf.shape])
        part = local if name not in KV_LEAVES else \
            local[:, :, :1] if box[2][0] == 0 else local[:, :, :0]
        sums = torch.tensor([float(part.float().square().sum()),
                             part.numel()], dtype=torch.float64, device=dev)
        if mesh is not None:
            dist.all_reduce(sums)
        scale = math.sqrt(float(sums[0]) / max(float(sums[1]), 1.0))
        g = gen(dev, zlib.crc32(repr((seed, name, box)).encode()))
        for i in range(local.shape[0]):
            local[i].copy_(torch.randn(local.shape[1:], generator=g,
                                       device=dev) * scale)
    return cache


def decode_run(model, params, cache, tok, pos0: int, steps: int, dev,
               mesh, greedy: bool = False) -> tuple[list, float]:
    """(each step's logits as whole tensors, wall s) of `steps` decode steps
    from position `pos0`: the tokens of `tok` [B, >= steps], or with
    `greedy` its first then each step's argmax."""
    out = []
    nxt = tok[:, :1]
    if mesh is not None:
        dist.barrier()
    sync(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with ctx.use_mesh(mesh):
        for t in range(steps):
            cur = nxt if greedy else tok[:, t:t + 1]
            if mesh is not None:
                cur = place(mesh, {"tokens": whole(cur)}, TOKENS)["tokens"]
            lg, cache = model.decode_step(params, cache, cur, pos0 + t)
            out.append(whole(lg))
            nxt = out[-1][:, -1].argmax(-1, keepdim=True)
    sync(dev)
    wall = time.perf_counter() - t0
    if any(ops.launch_counts().values()):
        raise AssertionError("decode launched a kernel")
    return out, wall


def decode_contract(cell: str, arch: str, cfg, mesh_name: str, mesh, dev,
                    batch: int, seq: int) -> dict:
    """The f32 decode at the contract's depth on `mesh` against one card,
    on one seeded cache of `seq` positions: each step's logits within
    CONTRACT_RTOL of their largest magnitude."""
    ccfg = S.contract_config(cfg.replace(n_layers=contract_layers(cfg)))
    model = get_model(ccfg)
    tok = torch.randint(0, ccfg.vocab, (batch, DECODE_TOKENS),
                        generator=gen(dev, 2), device=dev)
    reset_peak(dev)
    params = model.init(gen(dev), device=dev)
    cache = fill_cache(model, params, model.init_cache(batch, seq,
                                                       device=dev),
                       dev, None, 3)
    # each rank's shards copied out of the whole cache, which the one-card
    # run then writes in place
    meshed = {k: ctx.from_local(t.to_local().clone(), mesh, t.placements,
                                t.shape)
              for k, t in place(mesh, cache, model.cache_spec()).items()}
    pos0 = seq - DECODE_TOKENS
    want, one_wall = decode_run(model, params, cache, tok, pos0,
                                DECODE_TOKENS, dev, None)
    one_peak = peak(dev)
    del params, cache
    reset_peak(dev)
    params = model.init(gen(dev), device=dev, mesh=mesh)
    got, wall = decode_run(model, params, meshed, tok, pos0, DECODE_TOKENS,
                           dev, mesh)
    v = ccfg.vocab
    errs = [float((g[..., :v] - w[..., :v]).abs().max())
            for g, w in zip(got, want)]
    tols = [S.CONTRACT_RTOL * float(w[..., :v].abs().max()) for w in want]
    line = {"part": "decode_contract", "cell": cell, "model": arch,
            "mesh": mesh_name, "n_layers": ccfg.n_layers,
            "compute_dtype": "float32", "batch": batch, "positions": seq,
            "first_position": pos0, "steps": DECODE_TOKENS,
            "max_abs_err": errs, "tol": tols,
            "cache": {k: str(t.placements) for k, t in meshed.items()},
            "ms_per_token": wall / DECODE_TOKENS * 1e3,
            "one_card_ms_per_token": one_wall / DECODE_TOKENS * 1e3,
            "one_card_max_memory_allocated": one_peak,
            "max_memory_allocated": peak(dev),
            "ok": all(e <= t for e, t in zip(errs, tols))
            and all(bool(torch.isfinite(g[..., :v]).all()) for g in got)}
    del params, meshed
    return line


def deep_decode(cell: str, arch: str, cfg, mesh_name: str, mesh, dev,
                batch: int, seq: int) -> dict:
    """The cell at full depth in the config's types: greedy tokens from
    position seq - DECODE_TOKENS on a seeded cache made on the mesh; the
    peak memory of the decode steps (the parameters and cache held), and
    apart that of making and filling them."""
    model = get_model(cfg)
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.compute_params(model.init(gen(dev), device=dev,
                                             mesh=mesh))
    cache = fill_cache(model, params, model.init_cache(batch, seq,
                                                       device=dev,
                                                       mesh=mesh),
                       dev, mesh, 4)
    sync(dev)
    init_s = time.perf_counter() - t0
    fill_peak = peak(dev)
    reset_peak(dev)
    tok = torch.randint(0, cfg.vocab, (batch, 1), generator=gen(dev, 2),
                        device=dev)
    pos0 = seq - DECODE_TOKENS - 1
    decode_run(model, params, cache, tok, pos0, 1, dev, mesh)   # warm-up
    logits, wall = decode_run(model, params, cache, tok, pos0 + 1,
                              DECODE_TOKENS - 1, dev, mesh, greedy=True)
    walls = gathered(wall)
    toks = torch.cat([lg[:, -1].argmax(-1, keepdim=True) for lg in logits],
                     dim=1)
    nxt = place(mesh, {"tokens": toks[:, -1:]}, TOKENS)["tokens"]

    def step():
        with ctx.use_mesh(mesh):
            model.decode_step(params, cache, nxt, seq - 1)
    top = peak(dev)
    prof = profile_call(step, dev)
    peaks = gathered(top)
    kv = sum(local_bytes({k: cache[k]}) for k in KV_LEAVES if k in cache)
    return {"part": "decode", "cell": cell, "model": arch,
            "mesh": mesh_name, "n_layers": cfg.n_layers,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "batch": batch,
            "positions": seq, "first_position": pos0,
            "cache_bytes_a_card": local_bytes(cache), "kv_bytes_a_card": kv,
            "param_bytes_a_card": local_bytes(params), "init_s": init_s,
            "tokens": DECODE_TOKENS - 1,
            "ms_per_token": max(walls) / (DECODE_TOKENS - 1) * 1e3,
            "profile": prof, "fill_max_memory_allocated": fill_peak,
            "max_memory_allocated": top,
            "max_memory_allocated_every_rank": peaks,
            "ok": all(bool(torch.isfinite(lg[..., :cfg.vocab]).all())
                      for lg in logits)
            and bool(((toks >= 0) & (toks < cfg.vocab)).all())
            and (dev.type != "cuda" or max(peaks) <= PEAK_CAP)}


def main() -> int:
    cpu = "--device" in sys.argv and sys.argv[sys.argv.index(
        "--device") + 1] == "cpu"
    parts = sys.argv[sys.argv.index("--parts") + 1].split(",") \
        if "--parts" in sys.argv else PARTS
    if not set(parts) <= set(PARTS):
        raise SystemExit(f"--parts: a comma-separated subset of {PARTS}")
    if not cpu and not (torch.cuda.is_available()
                        and torch.cuda.device_count() >= 4
                        and dist.is_nccl_available()):
        raise SystemExit("long_context_cards: needs 4 CUDA devices and NCCL "
                         "(--device cpu rehearses it on gloo ranks)")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rank, world = M.init_distributed("cpu" if cpu else "cuda")
    if world != 4:
        raise SystemExit(f"needs a world of 4 ranks, not {world}")
    dev = (torch.device("cpu") if cpu
           else torch.device("cuda", torch.cuda.current_device()))
    torch.manual_seed(0)
    t_start = time.perf_counter()
    if rank == 0:
        if not cpu:
            build.build_all()
        smi = None if cpu else subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        print(json.dumps({"nvidia_smi": smi, "world": world,
                          "torch": torch.__version__}), flush=True)
    dist.barrier()
    meshes = {name: M.make_test_mesh(*shape, device_type=dev.type)
              for name, shape in MESHES.items()}
    ok = True

    def emit(line: dict) -> None:
        nonlocal ok
        flags = gathered(bool(line.get("ok", True)))
        ok &= all(flags)
        if rank == 0:
            print(json.dumps({**line, "ok_every_rank": all(flags),
                              "elapsed_s": time.perf_counter() - t_start}),
                  flush=True)

    def config(arch: str):
        return cpu_config(arch) if cpu else get_config(arch)

    size = {cell: CPU_SIZES[cell] if cpu else SHAPES[cell].seq_len
            for cell in CPU_SIZES}
    if "kernels" in parts and not cpu:
        emit(kernels_part(dev, rank, world))
    if "contract" in parts:
        for arch in ARCHS:
            for line in contract(arch, config(arch), meshes, dev,
                                 CONTRACT_BATCH, size["prefill_32k"]):
                emit(line)
    if "prefill" in parts:
        batch = CPU_BATCH if cpu else SHAPES["prefill_32k"].global_batch
        for arch in ARCHS:
            emit(deep_prefill(arch, config(arch), meshes[PREFILL_MESH], dev,
                              batch, size["prefill_32k"]))
    if "decode" in parts:
        for cell, (arch, mesh_name) in DECODE_CELLS.items():
            cb = min(DECODE_CONTRACT_BATCH, SHAPES[cell].global_batch)
            emit(decode_contract(cell, arch, config(arch), mesh_name,
                                 meshes[mesh_name], dev, cb, size[cell]))
            batch = min(CPU_BATCH, SHAPES[cell].global_batch) if cpu \
                else SHAPES[cell].global_batch
            emit(deep_decode(cell, arch, config(arch), mesh_name,
                             meshes[mesh_name], dev, batch, size[cell]))
    M.shutdown()
    if rank == 0:
        print(json.dumps({"ok": bool(ok), "device": None if cpu else {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
