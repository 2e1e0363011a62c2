#!/usr/bin/env python3
"""The MoE decoders served across the cards of one host.

    torchrun --nproc-per-node 4 scripts/mesh_models_cards.py
    torchrun --nproc-per-node 4 scripts/mesh_models_cards.py --device cpu

(the second a rehearsal on gloo ranks at reduced widths).

One process a card, NCCL (`launch.mesh.init_distributed`; the loopback for
NCCL's bootstrap unless NCCL_SOCKET_IFNAME is set).  qwen3-moe-235b-a22b
and deepseek-v2-236b at their published widths, random bf16 weights from
a seed, each rank drawing only its shards (`Model.init(..., mesh=)`: the
slices of the one-card draws), their experts and heads split over the
`model` ranks of a ("data", "model") mesh:

1. the f32 decode-vs-prefill contract of chip_smoke.py's MoE phase (f32
   compute, the first MOE_CONTRACT_LAYERS layers, CONTRACT_LEN tokens, the
   capacity factor that drops nothing) on a (1, 4) and a (2, 2) mesh: the
   meshed prefill's last logits within CONTRACT_RTOL of their largest
   magnitude of the one-card unmeshed prefill's (every rank runs that on
   its own card), the experts chosen equal wherever the one-card run's
   k-th and (k+1)-th router probabilities are more than 1e-6 apart, and
   the meshed decode (caches made on the mesh, positions split over
   `model`) within CONTRACT_RTOL of the meshed prefill; on (2, 2), where
   the routing groups split over `data` and the experts over `model`, the
   collectives of a prefill by kind (`launch.op_analysis`) and the NCCL
   kernels' names (the profiler);
2. the depth one card holds (chip_smoke.py's MOE_LAYERS) in bf16: the
   2 x 4096 prefill on (1, 4) against the one-card prefill, the largest
   difference relative to the logits' largest magnitude (not a gate:
   random weights amplify rounding with depth), and the working memory a
   card beyond the parameters;
3. the deep run on (1, 4): the largest depth whose parameters a card and
   that working memory (plus HEADROOM) stay under PEAK_CAP (depth is cut,
   never width), one warm-up and one timed 2 x 4096 prefill with one flash
   launch a layer on every rank, and GREEDY_TOKENS greedy decode tokens;
   prefill tokens/s, decode ms a token, peak memory a card, and one more
   decode step under the profiler (device busy time and idle share, NCCL
   and matrix-product time).

Rank 0 prints the card's name and power limit, flash at the (1, 4) ranks'
shard shapes (held to its plain version; ms, device ms, bound, SDPA), one
JSON line a part, and last `{"ok": ..., "device": ...}`; the exit code is
0 only if every gate held on every rank.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as S  # noqa: E402
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed.sharding import (bytes_per_device,  # noqa: E402
                                              place, tree_leaves)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402

MESHES = {"(1, 4)": (1, 4), "(2, 2)": (2, 2)}
DEEP_MESH = "(1, 4)"
PEAK_CAP = 72e9          # bytes of device memory a card may hold at peak
HEADROOM = 2e9           # kept free beyond the measured working memory
TIE_MARGIN = 1e-6        # tests/test_torch_moe.py's routing margin
TOKENS = {"tokens": ctx.P(("pod", "data"), None)}


def cpu_config(arch: str):
    """The rehearsal's config: reduced, with 16 query heads (qwen3-moe: 4
    KV heads) so the specs split the heads, and routing groups of 8."""
    import dataclasses
    cfg = reduced(arch)
    return cfg.replace(n_heads=16, n_kv_heads=4 if cfg.mla is None else 16,
                       moe=dataclasses.replace(cfg.moe, router_group=8))


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


def local_bytes(params) -> int:
    return sum(whole_local(t).numel() * t.element_size()
               for t in tree_leaves(params))


def whole_local(t):
    return t.to_local() if type(t).__name__ == "DTensor" else t


def gathered(obj) -> list:
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def prefill(model, params, tok, dev, mesh=None) -> tuple:
    """(last logits as a whole tensor, wall s, launch counts, routes) of
    one prefill of `tok` on `mesh` (None: unmeshed)."""
    batch = {"tokens": tok} if mesh is None else place(mesh, {"tokens": tok},
                                                       TOKENS)
    with ctx.use_mesh(mesh), moe.record_routes() as routes:
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
        routes = [(whole(a), whole(b)) for a, b in routes]
    return logits, wall, counts, routes


def flash_ok(counts: dict, n_layers: int, dev) -> bool:
    want = {"flash_attention": n_layers} if dev.type == "cuda" else {}
    return counts == want


def contract(arch: str, cfg, meshes: dict, dev, n_tok: int):
    """Part 1 for one architecture: a line a mesh, each yielded when its
    run ends."""
    ccfg = S.contract_config(cfg.replace(n_layers=S.MOE_CONTRACT_LAYERS))
    model = get_model(ccfg)
    vocab = ccfg.vocab
    tok = torch.randint(0, vocab, (S.SERVE_BATCH, n_tok), generator=gen(
        dev, 1), device=dev)
    reset_peak(dev)
    params = model.init(gen(dev), device=dev)
    want, _, counts0, want_routes = prefill(model, params, tok, dev)
    want = want[..., :vocab]
    del params
    for name, mesh in meshes.items():
        reset_peak(dev)
        params = model.init(gen(dev), device=dev, mesh=mesh)
        got, wall, counts, routes = prefill(model, params, tok, dev, mesh)
        got = got[..., :vocab]
        err = float((got - want).abs().max())
        tol = S.CONTRACT_RTOL * float(want.abs().max())
        agree = moe.routes_agree(routes, want_routes, ccfg.moe.top_k,
                                 TIE_MARGIN)
        ptok = place(mesh, {"tokens": tok}, TOKENS)["tokens"]
        cache = model.init_cache(S.SERVE_BATCH, n_tok, device=dev, mesh=mesh)
        dist.barrier()
        t0 = time.perf_counter()
        with ctx.use_mesh(mesh):
            ops.reset_launch_counts()
            for t in range(n_tok):
                logits, cache = model.decode_step(params, cache,
                                                  ptok[:, t:t + 1], t)
            dec = whole(logits)[..., :vocab]
        sync(dev)
        dec_wall = time.perf_counter() - t0
        dec_launches = sum(ops.launch_counts().values())
        derr = float((dec - got).abs().max())
        dtol = S.CONTRACT_RTOL * float(got.abs().max())
        line = {"part": "contract", "model": arch, "mesh": name,
                "n_layers": ccfg.n_layers, "compute_dtype": "float32",
                "capacity_factor": ccfg.moe.capacity_factor,
                "batch": S.SERVE_BATCH, "positions": n_tok,
                "prefill_vs_one_card": {"max_abs_err": err, "tol": tol},
                "routes": agree,
                "decode_vs_prefill": {"max_abs_err": derr, "tol": dtol},
                "prefill_launches": counts,
                "one_card_launches": counts0,
                "prefill_s": wall, "decode_ms_per_token": dec_wall / n_tok
                * 1e3, "decode_launches": dec_launches,
                "cache": {k: str(v.placements) for k, v in cache.items()},
                "max_memory_allocated": peak(dev)}
        line["ok"] = (err <= tol and derr <= dtol and agree["differ"] == 0
                      and agree["compared"] > 0 and dec_launches == 0
                      and flash_ok(counts, ccfg.n_layers, dev)
                      and flash_ok(counts0, ccfg.n_layers, dev))
        if name == "(2, 2)":
            line["collectives"] = collectives(model, params, tok, dev, mesh)
        del params, cache, logits
        yield line


def collectives(model, params, tok, dev, mesh) -> dict:
    """The collectives of one prefill on `mesh`: by kind, bytes and count
    a rank (`op_analysis`), and on the card the NCCL kernels the profiler
    saw (name: launches)."""
    batch = place(mesh, {"tokens": tok}, TOKENS)
    out = {}
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile
        dist.barrier()
        with ctx.use_mesh(mesh), profile(
                activities=[ProfilerActivity.CUDA]) as prof:
            model.prefill(params, batch)
            sync(dev)
        out["nccl_kernels"] = {e.key: e.count for e in prof.key_averages()
                               if "nccl" in e.key.lower()}
    with ctx.use_mesh(mesh):
        _, totals, _ = op_analysis.count(model.prefill, params, batch)
    out.update(bytes=dict(totals.coll), counts=dict(totals.counts))
    return out


def one_card_depth(arch: str, cfg, mesh, dev, seq: int) -> dict:
    """Part 2: the depth one card holds, one card against (1, 4)."""
    model = get_model(cfg)
    tok = torch.randint(0, cfg.vocab, (S.SERVE_BATCH, seq),
                        generator=gen(dev, 1), device=dev)
    reset_peak(dev)
    params = model.compute_params(model.init(gen(dev), device=dev))
    want, one_wall, counts0, _ = prefill(model, params, tok, dev)
    one_peak = peak(dev)
    del params
    reset_peak(dev)
    params = model.compute_params(model.init(gen(dev), device=dev,
                                             mesh=mesh))
    pbytes = local_bytes(params)
    got, wall, counts, _ = prefill(model, params, tok, dev, mesh)
    top = peak(dev)
    v = cfg.vocab
    rel = float((got[..., :v].float() - want[..., :v].float()).abs().max()
                / want[..., :v].float().abs().max())
    del params
    return {"part": "one_card_depth", "model": arch, "mesh": DEEP_MESH,
            "n_layers": cfg.n_layers, "batch": S.SERVE_BATCH, "seq": seq,
            "max_rel_diff_vs_one_card": rel,
            "one_card_prefill_s": one_wall, "prefill_s": wall,
            "one_card_max_memory_allocated": one_peak,
            "param_bytes_a_card": pbytes, "max_memory_allocated": top,
            "working_bytes": None if top is None else top - pbytes,
            "launches": counts, "one_card_launches": counts0,
            "ok": flash_ok(counts, cfg.n_layers, dev)
            and flash_ok(counts0, cfg.n_layers, dev)
            and bool(torch.isfinite(got[..., :v]).all())}


def pick_depth(cfg, mesh, working: int) -> tuple[int, int]:
    """(depth, parameter bytes a card): the most layers, at most the
    configured count, whose parameters a card plus `working` and HEADROOM
    stay under PEAK_CAP."""
    for n in range(cfg.n_layers, 0, -1):
        c = cfg.replace(n_layers=n)
        m = get_model(c)
        b = bytes_per_device(m.abstract_params(), mesh, m.param_specs())
        if b + working + HEADROOM <= PEAK_CAP:
            return n, b
    raise ValueError("not even one layer fits")


def deep(arch: str, cfg, mesh, dev, seq: int, greedy: int) -> dict:
    """Part 3: the deep run on (1, 4)."""
    model = get_model(cfg)
    tok = torch.randint(0, cfg.vocab, (S.SERVE_BATCH, seq),
                        generator=gen(dev, 1), device=dev)
    reset_peak(dev)
    t0 = time.perf_counter()
    params = model.compute_params(model.init(gen(dev), device=dev,
                                             mesh=mesh))
    sync(dev)
    init_s = time.perf_counter() - t0
    prefill(model, params, tok, dev, mesh)                    # warm-up
    logits, wall, counts, _ = prefill(model, params, tok, dev, mesh)
    walls = gathered(wall)
    v = cfg.vocab
    finite = bool(torch.isfinite(logits[..., :v]).all())
    cache = model.init_cache(S.SERVE_BATCH, seq + greedy, device=dev,
                             mesh=mesh)
    nxt = place(mesh, {"tokens": tok[:, -1:]}, TOKENS)["tokens"]
    out = []
    dist.barrier()
    sync(dev)
    t0 = time.perf_counter()
    with ctx.use_mesh(mesh):
        for t in range(greedy):
            lg, cache = model.decode_step(params, cache, nxt, t)
            nxt = lg[:, -1].argmax(-1, keepdim=True)
            out.append(nxt)
        toks = whole(torch.cat(out, dim=1))
    sync(dev)
    dec = time.perf_counter() - t0
    prof = decode_profile(model, params, cache, nxt, greedy, dev, mesh)
    n_tok = S.SERVE_BATCH * seq
    return {"part": "deep", "model": arch, "mesh": DEEP_MESH,
            "n_layers": cfg.n_layers,
            "n_layers_configured": get_config(arch).n_layers,
            "d_model": cfg.d_model, "param_dtype": cfg.param_dtype,
            "param_bytes_a_card": local_bytes(params), "init_s": init_s,
            "batch": S.SERVE_BATCH, "seq": seq, "prefill_s": wall,
            "slowest_rank_prefill_s": max(walls),
            "prefill_tokens_per_s": n_tok / max(walls),
            "launches": counts, "greedy_tokens": greedy,
            "decode_ms_per_token": dec / greedy * 1e3,
            "decode_profile": prof,
            "max_memory_allocated": peak(dev),
            "ok": flash_ok(counts, cfg.n_layers, dev) and finite
            and toks.shape == (S.SERVE_BATCH, greedy)
            and bool(((toks >= 0) & (toks < v)).all())}


def decode_profile(model, params, cache, nxt, pos: int, dev, mesh):
    """One more decode step (at `pos`) under the profiler on the card
    (chip_smoke.py's `profiled`): wall, the kernels' summed device time
    (NCCL's on their own stream included: a NCCL kernel runs from its
    rank's arrival to the last rank's, so its time is mostly waiting) and
    the idle share, that time by class (NCCL, matrix products, the rest)
    and the top kernels; None on the CPU."""
    if dev.type != "cuda":
        return None
    dist.barrier()

    def step():
        with ctx.use_mesh(mesh):
            model.decode_step(params, cache, nxt, pos)
    return S.profiled(step, top_n=6, classes=(
        ("nccl", ("nccl",)),
        ("gemm", ("gemm", "gemv", "nvjet", "cutlass", "xmma"))))


def rank_flash_shapes() -> dict:
    """Flash at the shapes each rank of (1, 4) gives it in the deep runs'
    prefills: qwen3-moe's 16 query heads and 1 KV head of 128, MLA's 32
    heads at q / k 192 with v of 128 padded to it."""
    q = get_config("qwen3-moe-235b-a22b")
    d = get_config("deepseek-v2-236b")
    n = MESHES[DEEP_MESH][1]
    b, s = S.SERVE_BATCH, S.PREFILL_LEN
    bf, rt, at = torch.bfloat16, 2.0 ** -7, 1e-4
    return {"qwen3-moe-235b-a22b, a rank of (1, 4)": (
                b, s, s, q.n_heads // n, q.n_kv_heads // n, q.hd, True, bf,
                rt, at),
            "deepseek-v2-236b MLA (v padded), a rank of (1, 4)": (
                b, s, s, d.n_heads // n, d.n_heads // n, S.MLA_QK, True, bf,
                rt, at)}


def main() -> int:
    cpu = "--device" in sys.argv and sys.argv[sys.argv.index(
        "--device") + 1] == "cpu"
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    rank, world = M.init_distributed("cpu" if cpu else "cuda")
    if world != 4:
        raise SystemExit(f"needs a world of 4 ranks, not {world}")
    dev = (torch.device("cpu") if cpu
           else torch.device("cuda", torch.cuda.current_device()))
    torch.manual_seed(0)
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
            print(json.dumps({**line, "ok_every_rank": all(flags)}),
                  flush=True)

    if not cpu and rank == 0:
        shapes = rank_flash_shapes()
        errs = S.check_flash_shapes(dev, shapes)
        times = S.time_flash_shapes(dev, shapes, seed=10)
        print(json.dumps({"part": "flash_rank_shapes",
                          **{k: {**times[k], "max_abs_err": errs[k]}
                             for k in shapes}}), flush=True)
    dist.barrier()
    n_con = 32 if cpu else S.CONTRACT_LEN
    seq = 64 if cpu else S.PREFILL_LEN
    greedy = 4 if cpu else S.GREEDY_TOKENS
    for arch in S.MOE_ARCHS:
        t0 = time.perf_counter()
        cfg = cpu_config(arch) if cpu else get_config(arch)
        for line in contract(arch, cfg, meshes, dev, n_con):
            emit(line)
        one = cfg if cpu else cfg.replace(n_layers=S.MOE_LAYERS[arch])
        line = one_card_depth(arch, one, meshes[DEEP_MESH], dev, seq)
        emit(line)
        if cpu:
            n, pbytes = 4, None
        else:
            working = max(gathered(line["working_bytes"]))
            n, pbytes = pick_depth(cfg, meshes[DEEP_MESH], working)
        line = deep(arch, cfg.replace(n_layers=n), meshes[DEEP_MESH], dev,
                    seq, greedy)
        line["predicted_param_bytes_a_card"] = pbytes
        peaks = gathered(line["max_memory_allocated"])
        line["max_memory_allocated_every_rank"] = peaks
        line["ok"] &= cpu or max(peaks) <= PEAK_CAP
        line["part_s"] = time.perf_counter() - t0
        emit(line)
    M.shutdown()
    if rank == 0:
        print(json.dumps({"ok": bool(ok), "device": None if cpu else {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
