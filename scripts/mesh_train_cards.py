#!/usr/bin/env python3
"""Training across the cards of one host.

    torchrun --nproc-per-node 4 scripts/mesh_train_cards.py
    torchrun --nproc-per-node 4 scripts/mesh_train_cards.py --device cpu

(the second a rehearsal on gloo ranks at reduced widths; without
`--device cpu` the script refuses to start unless it has 4 CUDA devices
and NCCL).  `--parts compression,elastic` runs only those of PARTS
(every one by default).

One process a card, NCCL (`launch.mesh.init_distributed`; the loopback
for NCCL's bootstrap unless NCCL_SOCKET_IFNAME is set), the train step of
`train/step.py` on a ("data", "model") mesh: the state laid out by
`train_state_specs` and drawn shard by shard (`init_train_state(...,
mesh=)`: the slices of the one-card draws), the batch split over ("pod",
"data"), autograd through the losses' plain paths (attention and the
MoE's dispatch on each rank's shards, the experts' FSDP split over `data`
gathered), every gradient laid out as its parameter (all-reduced where
the parameter is replicated over `data`, reduce-scattered where it is
split) and AdamW on each rank's shards.  No kernel launches in a train
step: the reference trains on its jnp paths.  The attention projections
are drawn at their input's fan-in (`fan_in`: chip_smoke.py's
`input_fan_in`, and MLA's up-projections), as the one-card training of
chip_smoke.py's phase 7c is.

(a) The f32 gradient contract against one card: qwen3-moe-235b-a22b,
    qwen2-1.5b and deepseek-v2-236b (MLA, 2 shared experts, the dense
    first layer) at their published widths, f32 parameters and compute,
    CONTRACT_LAYERS layers, SERVE_BATCH x CONTRACT_LEN tokens, the MoE at
    the capacity factor that drops nothing (chip_smoke.py's
    `contract_config`), on (1, 4) and (2, 2).  Every rank takes the
    unmeshed `value_and_grad` on its own card (parameters and gradients
    only, ~48 GB for qwen3-moe, ~43 GB for deepseek-v2), then the meshed
    one.  Gates: the loss
    within LOSS_RTOL of one card's; each gradient leaf's shard within
    GRAD_RTOL of the leaf's largest magnitude on one card (a leaf that is
    0 there is 0 on the mesh); no expert choice differing where the
    one-card router's k-th and (k+1)-th probabilities are more than
    TIE_MARGIN apart (the tokens inside the margin counted); every
    gradient in its parameter's placements; 0 kernel launches.  On
    (2, 2) the collectives of one train step by kind and bytes
    (`launch.op_analysis`).  deepseek-v2 also takes one compressed train
    step on (2, 2) at this depth, held as in (d).
(b) The deep runs on (2, 2): qwen3-moe and deepseek-v2 at published
    widths in bf16, depth cut to the most layers (deepseek-v2's dense
    first layer always kept) whose state a card (parameters, gradients,
    moments, the microbatch accumulator, the residuals where compressing,
    and one stacked leaf's gradient temporary, `held_bytes`) plus the
    working memory measured at CALIBRATION_LAYERS and HEADROOM stays
    under PEAK_CAP; global batch
    DEEP_BATCH x DEEP_SEQ in DEEP_MICRO microbatches (a data rank's
    microbatch is the one-card training's 2 x 4096).  One warm-up step on
    the first batch and DEEP_TIMED timed ones on the same batch: step ms,
    training tokens/s, MFU (6 x `active_params` of the cut config x
    tokens over the step time, over 4 x 989 TFLOP/s), peak memory a card,
    the loss on the first batch after the steps below its first value,
    0 launches, AdamW at the reference's defaults; then one step under the
    profiler (device busy time and idle share, NCCL by kind, GEMM, the
    `attention` and `optimizer` ranges, the rest).
(c) Elastic across cards: qwen2-1.5b at published widths and full depth
    (cut only if the disk cannot take the checkpoint) on (2, 2), global
    batch ELASTIC_BATCH x DEEP_SEQ: 2 steps, `checkpoint.save`, a third
    step (the trajectory); the checkpoint restored onto (1, 4)
    (`restore(shardings=)`) takes the third step again, its loss within
    ELASTIC_TOL (the reference's, tests/test_elastic.py) of the (2, 2)
    one.  Save and restore seconds, the bytes written, and the peak
    memory a card during `save`, gated at the card's shards of the state
    plus the largest whole leaf plus SAVE_SLACK.
(d) Gradient compression on NCCL: qwen2-1.5b at published widths and
    full depth, f32 parameters and compute, one `grad_compression=True`
    train step of SERVE_BATCH x CONTRACT_LEN tokens on (2, 2) and on a
    (2, 1, 2) ("pod", "data", "model") mesh, composed of the train step's
    parts.  Gates: every compressed gradient and residual in its
    parameter's placements; both bit-equal, shard by shard, to the
    unmeshed compression of the step's own gradients and residuals
    gathered whole on the card; against the same weights' and batch's
    one-card gradient compressed on the card, each compressed element
    within its block's scale (max|x| / 127, one card's) plus GRAD_RTOL of
    the leaf's largest one-card magnitude; the residual identity
    `corrected = sent + residual` within the rounding of the two f32
    values; the loss within LOSS_RTOL; 0 launches.  On (2, 1, 2)
    `cross_pod_allreduce_compressed` over the `pod` group, pod 0 sending
    the step's gradients and pod 1 the one-card gradients: every leaf
    bit-equal to the mean of the two whole-leaf round trips computed on
    the card.  Then the walls: qwen2-1.5b as configured (part (c)'s
    model and batch, ELASTIC_BATCH x DEEP_SEQ) on (2, 2), the plain and
    the compressed train step COMPRESSION_TURNS times each in turns after
    a warm-up turn, each step's wall and peak a card.

Rank 0 prints the card's name and power limit, one JSON line a part, and
last `{"ok": ..., "device": ...}`; the exit code is 0 only if every gate
held on every rank.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import chip_smoke as S  # noqa: E402
from mesh_models_cards import (gathered, gen, peak, reset_peak,  # noqa: E402
                               sync, whole)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, TokenPipeline,  # noqa: E402
                                       to_device)
from repro_torch.distributed import ctx  # noqa: E402
from repro_torch.distributed.sharding import (bytes_per_device,  # noqa: E402
                                              place, shardings_for_shaped,
                                              tree_leaves)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import mesh as M  # noqa: E402
from repro_torch.launch import op_analysis  # noqa: E402
from repro_torch.models import get_model, moe  # noqa: E402
from repro_torch.models.layers import flatten  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import compression as C  # noqa: E402
from repro_torch.train import step as T  # noqa: E402
from repro_torch.train.optimizer import (AdamWConfig,  # noqa: E402
                                         adamw_update)

# (pod, data, model)
MESHES = {"(1, 4)": (1, 1, 4), "(2, 2)": (1, 2, 2), "(2, 1, 2)": (2, 1, 2)}
CONTRACT_MESHES = ("(1, 4)", "(2, 2)")
DEEP_MESH, ELASTIC_FROM, ELASTIC_TO = "(2, 2)", "(2, 2)", "(1, 4)"
CONTRACT_ARCHS = ("qwen3-moe-235b-a22b", "qwen2-1.5b", "deepseek-v2-236b")
DEEP_ARCHS = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
ELASTIC_ARCH, COMPRESSION_ARCH = "qwen2-1.5b", "qwen2-1.5b"
COMPRESSION_MESHES = ("(2, 2)", "(2, 1, 2)")
# a compressed step at the contract's depth, on this mesh
COMPRESSED_CONTRACT = {"deepseek-v2-236b": "(2, 2)"}
COMPRESSION_TURNS = 8          # the plain and compressed steps timed in turns
FEEDBACK_CALLS = 5             # `apply_error_feedback` alone, timed
PARTS = ("contract", "deep", "elastic", "compression")
CONTRACT_LAYERS = 2            # chip_smoke.py's MOE / DENSE_CONTRACT_LAYERS
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
TIE_MARGIN = 1e-6              # tests/test_torch_moe.py's routing margin
ELASTIC_TOL = 5e-3
DEEP_BATCH, DEEP_SEQ, DEEP_MICRO = 8, 4096, 2
DEEP_TIMED = 3
CALIBRATION_LAYERS = 2
ELASTIC_BATCH = 4
PEAK_CAP = 72e9                # bytes of device memory a card may hold
HEADROOM = 2e9                 # kept free beyond the measured working memory
SAVE_SLACK = 1e9
PEAK_BF16 = M.PEAK_FLOPS_BF16
CKPT_DIR = os.path.join(ROOT, "results", "mesh_train", "ckpt")
ROWS = ctx.P(("pod", "data"), None)


def cpu_config(arch: str):
    """The rehearsal's config: reduced, checkpointed, attention in blocks
    of 8 rows; the MoE with routing groups of 8 and, without MLA, 16 query
    and 4 KV heads, so the specs split them (tests/test_torch_mesh_train.py's
    and tests/test_torch_mesh_train_mla.py's)."""
    cfg = reduced(arch).replace(remat=True, attn_block=8)
    if cfg.family == "moe":
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, router_group=8))
        if cfg.mla is None:
            cfg = cfg.replace(n_heads=16, n_kv_heads=4)
    return cfg


def local(x):
    return x.to_local() if type(x).__name__ == "DTensor" else x


def batch_of(cfg, b: int, s: int, dev, step: int = 0) -> dict:
    """Batch `step` of the port's pipeline (b x s), on `dev`."""
    return to_device(TokenPipeline(DataConfig(
        vocab=cfg.vocab, seq_len=s, global_batch=b)).batch_at(step), dev)


def placed(mesh, batch: dict) -> dict:
    return place(mesh, batch, {k: ROWS for k in batch})


def fan_in(params: dict) -> dict:
    """`params` (in place) with the attention projections at their input's
    fan-in: chip_smoke.py's `input_fan_in`, and MLA's up-projections
    `wq_b` / `wkv_b` [..., r, H, k], which `Model.init` draws at a fan-in
    of H where their input is the latent of width r."""
    S.input_fan_in(params)
    with torch.no_grad():
        for path, t in flatten(params).items():
            if path[-1] in ("wq_b", "wkv_b"):
                t.mul_(math.sqrt(t.shape[-2] / t.shape[-3]))
    return params


def drawn(model, dev, mesh=None) -> dict:
    """Trainable parameters from seed 0 (on `mesh`: each rank's shards),
    the attention projections at their input's fan-in (`fan_in`)."""
    return T.trainable(fan_in(model.init(gen(dev), device=dev, mesh=mesh)))


def launches() -> int:
    return sum(ops.launch_counts().values())


def timed(dev, fn):
    """(fn's result, wall seconds) after a barrier, synchronised."""
    dist.barrier()
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def contract_config(arch: str, cpu: bool):
    if cpu:
        return S.contract_config(cpu_config(arch))
    return S.contract_config(get_config(arch).replace(
        n_layers=CONTRACT_LAYERS, param_dtype="float32"))


def leaf_errors(grads: dict, want: dict, mesh) -> dict:
    """For each gradient leaf: this rank's shard's largest difference
    from the same block of the one-card gradient, the one-card leaf's
    largest magnitude, whether a leaf that is 0 there is 0 here, and its
    placements."""
    out = {}
    for k, g in flatten(grads).items():
        w = want[k]
        box = ctx.shard_box(g.shape, g.placements, mesh)
        wl = w[tuple(slice(a, a + n) for a, n in box)]
        gl = g.to_local()
        scale = float(w.abs().max())
        out["/".join(k)] = {
            "err": float((gl.double() - wl.double()).abs().max())
            if gl.numel() else 0.0,
            "scale": scale, "zero_ok": scale != 0 or not bool(gl.any()),
            "placements": str(g.placements)}
    return out


def contract(arch: str, meshes: dict, dev, cpu: bool):
    """Part (a) for one model: a line a mesh, each yielded when its run
    ends; then, for COMPRESSED_CONTRACT's models, the compressed step's
    line (`compressed_step`)."""
    cfg = contract_config(arch, cpu)
    model = get_model(cfg)
    n_tok = 32 if cpu else S.CONTRACT_LEN
    batch = batch_of(cfg, S.SERVE_BATCH, n_tok, dev)
    reset_peak(dev)
    params = drawn(model, dev)
    ops.reset_launch_counts()
    with moe.record_routes() as want_routes:
        (loss0, g0), wall0 = timed(dev, lambda: T.value_and_grad(
            model, params, batch))
    launches0 = launches()
    loss0, g0 = float(loss0), flatten(g0)
    one_peak = peak(dev)
    del params
    for name in CONTRACT_MESHES:
        mesh = meshes[name]
        reset_peak(dev)
        params = drawn(model, dev, mesh)
        pb = placed(mesh, batch)
        ops.reset_launch_counts()
        with ctx.use_mesh(mesh), moe.record_routes() as routes:
            (loss, grads), wall = timed(dev, lambda: T.value_and_grad(
                model, params, pb))
            routes = [(whole(a), whole(b)) for a, b in routes]
        n_launch = launches()
        loss = float(whole(loss))
        errs = leaf_errors(grads, g0, mesh)
        layout = all(g.placements == p.placements for g, p in zip(
            tree_leaves(grads), tree_leaves(params), strict=True))
        partial = [k for k, g in flatten(grads).items()
                   if any(p.is_partial() for p in g.placements)]
        del grads
        # every rank's shards: the largest error of each leaf
        every = gathered(errs)
        worst = {k: max(e[k]["err"] for e in every) for k in errs}
        rel = {k: worst[k] / max(errs[k]["scale"], 1e-30) for k in errs}
        zero_ok = all(e[k]["zero_ok"] for e in every for k in errs)
        line = {"part": "contract", "model": arch, "mesh": name,
                "n_layers": cfg.n_layers, "param_dtype": cfg.param_dtype,
                "compute_dtype": cfg.compute_dtype, "batch": S.SERVE_BATCH,
                "positions": n_tok, "loss": loss, "one_card_loss": loss0,
                "loss_rel_err": abs(loss - loss0) / abs(loss0),
                "max_leaf_err_over_scale": max(rel.values()),
                "worst_leaf": max(rel, key=rel.get),
                "n_leaves": len(rel), "zero_leaves_zero": zero_ok,
                "grads_laid_out_as_params": layout, "partial_left": partial,
                "launches": n_launch, "one_card_launches": launches0,
                "grad_s": wall, "one_card_grad_s": wall0,
                "one_card_max_memory_allocated": one_peak,
                "max_memory_allocated": peak(dev)}
        if cfg.family == "moe":
            line["capacity_factor"] = cfg.moe.capacity_factor
            line["routes"] = moe.routes_agree(routes, want_routes,
                                              cfg.moe.top_k, TIE_MARGIN)
        line["ok"] = (line["loss_rel_err"] <= LOSS_RTOL
                      and line["max_leaf_err_over_scale"] <= GRAD_RTOL
                      and zero_ok and layout and not partial
                      and n_launch == 0 and launches0 == 0
                      and (cfg.family != "moe"
                           or (line["routes"]["differ"] == 0
                               and line["routes"]["compared"] > 0)))
        if name == "(2, 2)":
            line["collectives"] = step_collectives(model, params, pb, mesh)
        del params, pb
        yield line
    if arch in COMPRESSED_CONTRACT:
        name = COMPRESSED_CONTRACT[arch]
        yield compressed_step(model, meshes[name], name, batch, g0, loss0,
                              dev)
    del g0


def step_collectives(model, params, batch, mesh) -> dict:
    """The collectives of one train step (AdamW included) on `mesh` by
    kind: bytes and calls a rank (`op_analysis.count`)."""
    tcfg = T.TrainConfig(opt=AdamWConfig(**S.TRAIN_OPT))
    state = T.new_train_state(params, tcfg)
    with ctx.use_mesh(mesh):
        _, totals, seconds = op_analysis.count(
            T.make_train_step(model, tcfg), state, batch)
    return {"bytes": dict(totals.coll), "calls": dict(totals.counts),
            "counted_s": seconds}


def _box(box) -> tuple:
    return tuple(slice(a, a + n) for a, n in box)


def _chunked_max(fn, *ts, chunk: int = 1 << 25) -> float:
    """The largest element of `fn` over the flattened tensors `ts` (one
    shape), taken a chunk at a time so that its f64 temporaries stay
    small; -inf for empty tensors."""
    flat = [t.reshape(-1) for t in ts]
    best = float("-inf")
    for i in range(0, flat[0].numel(), chunk):
        best = max(best, float(fn(*(f[i:i + chunk] for f in flat)).max()))
    return best


def feedback_errors(trees: dict, placements: dict, g0: dict, mesh) -> dict:
    """For each leaf of a meshed step's compression (`trees`: its
    gradients `grads` and residuals `ef_in` in, the compressed gradients
    `sent` and new residuals `ef` out) on this rank's shard: the one-card
    gradient `g0` compressed on the card over the blocks the shard's rank
    quantised (`block_placements`: whole blocks), the largest excess of
    |sent - one card's sent| over the one-card block's scale, relative to
    the leaf's largest one-card magnitude; the uncompressed gradient's
    error alike; the residual identity's largest miss beyond the rounding
    of the two f32 values (2^-24 of each magnitude, the least normal f32
    besides); and whether the compressed gradient and the residual are in
    the parameter's `placements`."""
    fg, fs, fr, fe = (flatten(trees[k]) for k in ("grads", "sent", "ef",
                                                   "ef_in"))
    d = torch.float64
    out = {}
    for k, pl in placements.items():
        g, sent, resid, e = fg[k], fs[k], fr[k], fe[k]
        shape = tuple(g.shape)
        bbox = ctx.shard_box(shape, C.block_placements(
            shape, pl, tuple(mesh.shape)), mesh)
        pbox = ctx.shard_box(shape, sent.placements, mesh)
        part = g0[k][_box(bbox)]
        one, _ = C.apply_error_feedback({"x": part}, {
            "x": torch.zeros(part.shape, dtype=torch.float32,
                             device=part.device)})
        _, scale, _ = C.quantize_int8(part)
        scale = scale.expand(-1, C.BLOCK).reshape(-1)[:part.numel()] \
            .reshape(part.shape)
        inner = tuple(slice(a - b, a - b + n)
                      for (a, n), (b, _) in zip(pbox, bbox))
        top = max(float(g0[k].abs().max()), 1e-30)
        sl, rl, gl, el = (x.to_local() for x in (sent, resid, g, e))
        out["/".join(k)] = {
            "excess": _chunked_max(
                lambda s, o, c: (s.to(d) - o.to(d)).abs() - c.to(d),
                sl, one["x"][inner], scale[inner]) / top,
            "raw": _chunked_max(lambda a, b: (a.to(d) - b.to(d)).abs(),
                                gl, g0[k][_box(pbox)]) / top,
            "identity_miss": _chunked_max(
                lambda g, e, s, r: (g.to(d) + e.to(d) - s.to(d) - r.to(d))
                .abs() - 2.0 ** -24 * (s.to(d).abs() + r.to(d).abs())
                - 2.0 ** -126, gl, el, sl, rl),
            "laid_out": sent.placements == pl and resid.placements == pl}
        del part, one, scale
    return out


def feedback_exact(trees: dict, mesh) -> dict:
    """For each leaf of a meshed step's compression (`trees` as in
    `feedback_errors`): whether this rank's shards of `sent` and `ef` are
    bit-equal to the unmeshed `apply_error_feedback` of the whole leaf,
    its gradient and incoming residual gathered, on the card.  The whole
    leaf is taken in contiguous runs of C._CHUNK elements of its row-major
    flattening (a multiple of BLOCK, so the runs hold the whole leaf's
    blocks), which bounds the temporaries to the gathered leaves and two
    outputs.  A rank that quantised other blocks than the whole leaf's
    differs here."""
    fg, fe, fs, fr = (flatten(trees[k]) for k in ("grads", "ef_in", "sent",
                                                   "ef"))
    out = {}
    for k, g in fg.items():
        gw, ew = g.full_tensor().reshape(-1), fe[k].full_tensor().reshape(-1)
        sw, rw = torch.empty_like(gw), torch.empty_like(ew)
        for i in range(0, gw.numel(), C._CHUNK):
            run = slice(i, i + C._CHUNK)
            a, b = C.apply_error_feedback({"x": gw[run]}, {"x": ew[run]})
            sw[run], rw[run] = a["x"], b["x"]
        del gw, ew
        out["/".join(k)] = all(
            torch.equal(x.to_local(), w.view(g.shape)[_box(
                ctx.shard_box(g.shape, x.placements, mesh))])
            for x, w in ((fs[k], sw), (fr[k], rw)))
        del sw, rw
    return out


def cross_pod(grads: dict, g0: dict, mesh) -> dict:
    """`cross_pod_allreduce_compressed` over the `pod` group of `mesh`, a
    leaf at a time: pod 0 sends the meshed step's gradient `grads`, pod 1
    the one-card gradient `g0` (this rank's shard of it), each a DTensor
    in the gradient's placements; against the mean of the two whole
    leaves' round trips computed on the card."""
    pod = mesh.get_coordinate()[ctx.axis_names(mesh).index("pod")]
    equal, laid_out, split = [], [], 0
    for k, g in flatten(grads).items():
        full = g.full_tensor()
        mine = g.to_local() if pod == 0 else \
            g0[k][_box(ctx.shard_box(g.shape, g.placements, mesh))]
        leaf = ctx.from_local(mine, mesh, g.placements, g.shape)
        got = C.cross_pod_allreduce_compressed({"x": leaf}, mesh)["x"]
        want = (C.compress_roundtrip(full)
                + C.compress_roundtrip(g0[k])) * 0.5
        del full
        equal.append(torch.equal(got.to_local(), want[_box(
            ctx.shard_box(g.shape, got.placements, mesh))]))
        laid_out.append(got.placements == g.placements)
        split += any(p.is_shard() and n == "model" for p, n in zip(
            g.placements, ctx.axis_names(mesh)))
    return {"leaves": len(equal), "bit_equal": all(equal),
            "laid_out": all(laid_out), "split_over_model": split}


def compressed_step(model, mesh, name: str, batch: dict, g0: dict,
                    loss0: float, dev) -> dict:
    """One `grad_compression=True` train step on `mesh` from the one-card
    draws (the parameters' shards) on `batch`, composed of the train
    step's parts (`value_and_grad`, `apply_error_feedback` on the
    gradients and the zero residuals, `adamw_update`): its compression
    bit-equal to the unmeshed one of the step's own gathered gradients
    (`feedback_exact`) and held to the one-card gradient `g0` compressed
    on the card (`feedback_errors`), its loss to `loss0`; on a mesh with
    `pod`, `cross_pod`."""
    cfg = model.cfg
    tcfg = T.TrainConfig(opt=AdamWConfig(**S.TRAIN_OPT),
                         grad_compression=True)
    pb = placed(mesh, batch)
    reset_peak(dev)
    state = T.new_train_state(drawn(model, dev, mesh), tcfg)

    def step():
        loss, grads = T.value_and_grad(model, state.params, pb)
        sent, ef = C.apply_error_feedback(grads, state.ef)
        params, _, _ = adamw_update(tcfg.opt, state.params, sent, state.opt)
        return loss, {"grads": grads, "ef_in": state.ef, "sent": sent,
                      "ef": ef}, params

    ops.reset_launch_counts()
    with ctx.use_mesh(mesh):
        (loss, trees, params), wall = timed(dev, step)
    n_launch = launches()
    top = peak(dev)
    loss = float(whole(loss))
    placements = {k: p.placements for k, p in flatten(state.params).items()}
    updated = all(p.placements == placements[k]
                  for k, p in flatten(params).items())
    del state, params   # the one-card gradient `g0` is held beside them
    errs = feedback_errors(trees, placements, g0, mesh)
    exact = feedback_exact(trees, mesh)
    pods = cross_pod(trees["grads"], g0, mesh) \
        if "pod" in ctx.axis_names(mesh) else None
    del trees
    every = gathered(errs)
    worst = {f: max(max(e[k][f] for e in every) for k in errs)
             for f in ("excess", "raw", "identity_miss")}
    differ = sorted({k for e in gathered(exact) for k, v in e.items()
                     if not v})
    line = {"part": "compressed_step", "model": cfg.name, "mesh": name,
            "n_layers": cfg.n_layers, "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype, "batch": S.SERVE_BATCH,
            "positions": batch["tokens"].shape[1], "loss": loss,
            "one_card_loss": loss0,
            "loss_rel_err": abs(loss - loss0) / abs(loss0),
            "unmeshed_bit_equal": not differ, "unmeshed_differ": differ,
            "max_excess_over_block_scale": worst["excess"],
            "max_uncompressed_err": worst["raw"],
            "max_identity_miss": worst["identity_miss"],
            "n_leaves": len(errs),
            "laid_out_as_params": all(e[k]["laid_out"] for e in every
                                      for k in errs) and updated,
            "cross_pod": pods, "launches": n_launch, "step_s": wall,
            "max_memory_allocated": top}
    line["ok"] = (line["loss_rel_err"] <= LOSS_RTOL and not differ
                  and worst["excess"] <= GRAD_RTOL
                  and worst["identity_miss"] <= 0
                  and line["laid_out_as_params"] and n_launch == 0
                  and (pods is None or (pods["bit_equal"]
                                        and pods["laid_out"]
                                        and pods["split_over_model"] > 0)))
    return line


def compression_walls(mesh, dev, cpu: bool) -> dict:
    """Part (d)'s walls: qwen2-1.5b as configured at full depth (part (c)'s
    model and ELASTIC_BATCH x DEEP_SEQ batch) on DEEP_MESH, the plain and
    the compressed `make_train_step` in turns on the state they leave, one
    warm-up turn and COMPRESSION_TURNS timed ones: each step's wall (the
    largest over the ranks) and peak a card (the largest), and the paired
    differences (compressed less plain, turn by turn); then
    `apply_error_feedback` alone on one step's gradients and the
    residuals, FEEDBACK_CALLS times (the largest wall over the ranks)."""
    cfg = cpu_config(COMPRESSION_ARCH) if cpu else get_config(
        COMPRESSION_ARCH)
    seq = 32 if cpu else DEEP_SEQ
    model = get_model(cfg)
    opt = AdamWConfig(**S.TRAIN_OPT)
    steps = {kind: T.make_train_step(model, T.TrainConfig(
        opt=opt, grad_compression=kind == "compressed"))
        for kind in ("plain", "compressed")}
    state = T.init_train_state(model, gen(dev), T.TrainConfig(
        opt=opt, grad_compression=True), device=dev, mesh=mesh)
    S.input_fan_in(state.params)
    batch = placed(mesh, batch_of(cfg, ELASTIC_BATCH, seq, dev))
    walls = {kind: [] for kind in steps}
    peaks = {kind: [] for kind in steps}
    ops.reset_launch_counts()
    with ctx.use_mesh(mesh):
        for turn in range(1 + COMPRESSION_TURNS):
            for kind, step in steps.items():
                ef = state.ef
                given = state if kind == "compressed" else T.TrainState(
                    state.params, state.opt, None)
                reset_peak(dev)
                (state, m), wall = timed(dev, lambda: step(given, batch))
                if kind == "plain":
                    state = T.TrainState(state.params, state.opt, ef)
                if turn:
                    walls[kind].append(max(gathered(wall)))
                    top = gathered(peak(dev))
                    peaks[kind].append(None if None in top else max(top))
        loss = float(whole(m["loss"]))
    n_launch = launches()
    # the compression alone on a step's gradients and the residuals
    with ctx.use_mesh(mesh):
        _, grads = T.value_and_grad(model, state.params, batch)
        feedback = [max(gathered(timed(dev, lambda: C.apply_error_feedback(
            grads, state.ef))[1])) for _ in range(FEEDBACK_CALLS)]
    del grads, state
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    diffs = [c - p for p, c in zip(walls["plain"], walls["compressed"])]
    line = {"part": "compression_walls", "model": cfg.name,
            "mesh": DEEP_MESH, "n_layers": cfg.n_layers,
            "param_dtype": cfg.param_dtype,
            "compute_dtype": cfg.compute_dtype,
            "global_batch": ELASTIC_BATCH, "seq": seq,
            "turns": COMPRESSION_TURNS, "step_s": walls,
            "median_step_s": med,
            "paired_diff_s": diffs,
            "median_paired_diff_s": sorted(diffs)[len(diffs) // 2],
            "spread_s": {k: max(v) - min(v) for k, v in walls.items()},
            "max_memory_allocated": peaks,
            "feedback_s": feedback,
            "median_feedback_s": sorted(feedback)[len(feedback) // 2],
            "last_loss": loss,
            "launches": n_launch}
    line["ok"] = n_launch == 0 and math.isfinite(loss)
    return line


def compression(meshes: dict, dev, cpu: bool):
    """Part (d): a line a mesh of COMPRESSION_MESHES, then the walls."""
    arch = COMPRESSION_ARCH
    cfg = S.contract_config(cpu_config(arch) if cpu else get_config(
        arch).replace(param_dtype="float32"))
    model = get_model(cfg)
    batch = batch_of(cfg, S.SERVE_BATCH, 32 if cpu else S.CONTRACT_LEN, dev)
    params = drawn(model, dev)
    loss0, g0 = T.value_and_grad(model, params, batch)
    loss0, g0 = float(loss0), flatten(g0)
    del params
    for name in COMPRESSION_MESHES:
        yield compressed_step(model, meshes[name], name, batch, g0, loss0,
                              dev)
    del g0
    yield compression_walls(meshes[DEEP_MESH], dev, cpu)


def active_params(cfg) -> int:
    """Parameters a token uses: every leaf of the model's tree but the
    routed experts a token does not choose (n_experts - top_k of each MoE
    layer).  `ArchConfig.n_active_params` counts every layer as an MoE
    layer, a dense first layer too (deepseek-v2: 5.36e9 parameters at 2
    layers, where it counts 8.99e9)."""
    total = sum(t.numel() for t in flatten(
        get_model(cfg).abstract_params()).values())
    if cfg.family != "moe":
        return total
    m = cfg.moe
    per_expert = 3 * cfg.d_model * m.d_ff_expert
    return total - (cfg.n_layers - m.first_dense) * (
        m.n_experts - m.top_k) * per_expert


def held_bytes(cfg, mesh, tcfg) -> int:
    """Bytes a card of `cfg`'s train state on `mesh` and what a step holds
    beside it: the parameters (every leaf of the model's tree: a dense
    first layer and MLA's projections included), their f32 moments, the
    gradients, the f32 microbatch accumulator and, where compressing, the
    f32 residuals (`bytes_per_device` of the spec trees), and one more
    gradient-sized temporary of the largest stacked leaf (the backward of
    a layer's slice of it)."""
    model = get_model(cfg)
    abstract = model.abstract_params()
    specs = model.param_specs()
    pbytes = bytes_per_device(abstract, mesh, specs)
    f32 = {k: torch.empty(t.shape, dtype=torch.float32, device="meta")
           for k, t in flatten(abstract).items()}
    f32_bytes = bytes_per_device(f32, mesh, dict(flatten(specs)))
    largest = max(bytes_per_device({k: t}, mesh, {k: flatten(specs)[k]})
                  for k, t in flatten(abstract).items())
    acc = f32_bytes if tcfg.microbatches > 1 else 0
    ef = f32_bytes if tcfg.grad_compression else 0
    return 2 * pbytes + 2 * f32_bytes + acc + ef + largest


def pick_depth(cfg, mesh, tcfg, working: int) -> tuple[int, int]:
    """(depth, held bytes a card): the most layers, at most the configured
    count and at least one past an MoE model's dense first layers, whose
    `held_bytes` plus `working` and HEADROOM stay under PEAK_CAP."""
    first = cfg.moe.first_dense if cfg.family == "moe" else 0
    for n in range(cfg.n_layers, first, -1):
        b = held_bytes(cfg.replace(n_layers=n), mesh, tcfg)
        if b + working + HEADROOM <= PEAK_CAP:
            return n, b
    raise ValueError("not even one layer fits")


def calibrate(cfg, mesh, tcfg, batch: dict, dev) -> dict:
    """One step at CALIBRATION_LAYERS: the working memory a card beyond
    `held_bytes` (the largest over the ranks)."""
    c = cfg.replace(n_layers=CALIBRATION_LAYERS)
    model = get_model(c)
    reset_peak(dev)
    state = T.new_train_state(drawn(model, dev, mesh), tcfg)
    with ctx.use_mesh(mesh):
        wall = timed(dev, lambda: T.make_train_step(model, tcfg)(
            state, batch))[1]
    top = peak(dev)
    held = held_bytes(c, mesh, tcfg)
    del state
    reset_peak(dev)
    working = max(gathered(top - held))
    return {"n_layers": c.n_layers, "max_memory_allocated": top,
            "held_bytes": held, "working_bytes": working, "step_s": wall}


def eval_loss(model, params, batch: dict, mb: int) -> float:
    """The loss of `batch` at `params` without gradients, a microbatch at
    a time (the mean of the microbatches' losses, as a step takes it)."""
    step = T.make_eval_step(model)
    total = 0.0
    for i in range(mb):
        total += float(whole(step(params, {k: T.microbatch(v, i, mb)
                                           for k, v in batch.items()})))
    return total / mb


def deep(arch: str, mesh, dev, cpu: bool) -> dict:
    """Part (b) for one model."""
    cfg = cpu_config(arch).replace(n_layers=4) if cpu \
        else get_config(arch)
    seq = 32 if cpu else DEEP_SEQ
    # the reference's AdamW defaults (100 warm-up steps): at chip_smoke.py's
    # TRAIN_OPT (2 warm-up steps) the random-init MoE's loss rose on 4
    # cards, 12.0 to 25.2 in three steps (PERF.md, section 6)
    tcfg = T.TrainConfig(opt=AdamWConfig(), microbatches=DEEP_MICRO)
    batch = placed(mesh, batch_of(cfg, DEEP_BATCH, seq, dev))
    line = {"part": "deep", "model": arch, "mesh": DEEP_MESH}
    if cpu:
        n, held = cfg.n_layers, held_bytes(cfg, mesh, tcfg)
    else:
        line["calibration"] = calibrate(cfg, mesh, tcfg, batch, dev)
        n, held = pick_depth(cfg, mesh, tcfg,
                             line["calibration"]["working_bytes"])
    cut = cfg.replace(n_layers=n)
    model = get_model(cut)
    reset_peak(dev)
    t0 = time.perf_counter()
    state = T.init_train_state(model, gen(dev), tcfg, device=dev, mesh=mesh)
    fan_in(state.params)
    sync(dev)
    init_s = time.perf_counter() - t0
    step = T.make_train_step(model, tcfg)
    losses, norms, lrs, walls = [], [], [], []
    ops.reset_launch_counts()
    with ctx.use_mesh(mesh):
        for i in range(1 + DEEP_TIMED):
            (state, m), wall = timed(dev, lambda: step(state, batch))
            losses.append(float(whole(m["loss"])))
            norms.append(float(whole(m["grad_norm"])))
            lrs.append(float(whole(m["lr"])))
            if i:
                walls.append(max(gathered(wall)))
        n_launch = launches()
        after = eval_loss(model, state.params, batch, DEEP_MICRO)
    top = peak(dev)
    step_s = sum(walls) / len(walls)
    tokens = DEEP_BATCH * seq
    flops = 6.0 * active_params(cut) * tokens
    line.update({
        "n_layers": n, "n_layers_configured": get_config(arch).n_layers,
        "d_model": cut.d_model, "param_dtype": cut.param_dtype,
        "compute_dtype": cut.compute_dtype, "remat": cut.remat,
        "global_batch": DEEP_BATCH, "seq": seq, "microbatches": DEEP_MICRO,
        "reduced_from": {"global_batch": 256,
                         "n_layers": get_config(arch).n_layers},
        "predicted_held_bytes_a_card": held,
        "local_state_bytes": sum(local(t).numel() * t.element_size()
                                 for t in tree_leaves(state)
                                 if t is not None),
        "opt": dataclasses.asdict(tcfg.opt), "init_s": init_s,
        "losses": losses, "grad_norms": norms, "lrs": lrs,
        "loss_after_on_first_batch": after, "step_wall_s": walls, "step_ms": step_s * 1e3,
        "tokens_per_s": tokens / step_s,
        "n_active_params": active_params(cut),
        "n_active_params_analytic": cut.n_active_params(),
        "model_flops_per_step": flops,
        "mfu": flops / step_s / (dist.get_world_size() * PEAK_BF16),
        "launches": n_launch, "max_memory_allocated": top,
        "max_memory_allocated_every_rank": gathered(top)})
    line["profile"] = None if cpu else profile_step(step, state, batch, mesh,
                                                    arch)
    line["ok"] = (n_launch == 0 and all(math.isfinite(x) for x in losses)
                  and after < losses[0]
                  and (cpu or max(line["max_memory_allocated_every_rank"])
                       <= PEAK_CAP))
    del state
    return line


def profile_step(step, state, batch, mesh, arch: str) -> dict:
    """One more step under the profiler, in a telemetry session (so
    `attention`, `moe` and `optimizer` are profiler ranges), on rank 0's
    card: wall; the device's busy time as the union of its kernels'
    intervals (NCCL's kernels run on a stream of their own beside the
    compute, and a NCCL kernel lasts from its rank's arrival to the last
    rank's, so it is mostly waiting), with and without NCCL's kernels, and
    the idle shares they leave; NCCL by kind; and chip_smoke.py's split of
    the summed kernel time into GEMM, the `attention` range's other
    kernels, the `optimizer` range and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    dist.barrier()
    with telemetry.session(out_dir=os.path.join(
            ROOT, "results", "mesh_train",
            f"telemetry_{arch}_{dist.get_rank()}")):
        with ctx.use_mesh(mesh), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batch)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    split = S.profile_split(prof, 1)
    ranges = ("attention", "optimizer", "moe")
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.name not in ranges and not e.name.startswith("nccl:")]
    nccl: dict = {}
    for e in kernels:
        if "nccl" not in e.name.lower():
            continue
        kind = next((k for k in S.NCCL_KINDS if k.lower() in e.name.lower()),
                    "other")
        d = nccl.setdefault(kind, {"device_ms": 0.0, "count": 0})
        d["device_ms"] += (e.time_range.end - e.time_range.start) / 1e3
        d["count"] += 1
    busy = S.busy_ms([(e.time_range.start, e.time_range.end)
                      for e in kernels])
    compute = S.busy_ms([(e.time_range.start, e.time_range.end)
                         for e in kernels if "nccl" not in e.name.lower()])
    return {"wall_ms": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "compute_busy_ms": compute,
            "compute_idle_share": 1.0 - compute / wall_ms,
            "kernel_ms_summed": split["device_busy_ms_per_step"],
            "nccl_by_kind": nccl,
            "nccl_ms": sum(d["device_ms"] for d in nccl.values()),
            "kernel_ms_by_class": split["device_ms_per_step"],
            "processing_s": time.perf_counter() - t0}


def elastic(meshes: dict, dev, cpu: bool) -> dict:
    """Part (c)."""
    cfg = cpu_config(ELASTIC_ARCH) if cpu else get_config(ELASTIC_ARCH)
    seq = 32 if cpu else DEEP_SEQ
    tcfg = T.TrainConfig(opt=AdamWConfig(**S.TRAIN_OPT))
    src, dst = meshes[ELASTIC_FROM], meshes[ELASTIC_TO]
    # depth: the configured one, unless the disk cannot take the
    # checkpoint (parameters and both moments, with 10 % to spare)
    os.makedirs(CKPT_DIR, exist_ok=True)
    free = shutil.disk_usage(CKPT_DIR).free
    n = cfg.n_layers
    need = lambda c: 12 * c.n_params() * 1.1  # noqa: E731
    while n > 1 and need(cfg.replace(n_layers=n)) > free:
        n -= 1
    cfg = cfg.replace(n_layers=n)
    model = get_model(cfg)
    batches = [batch_of(cfg, ELASTIC_BATCH, seq, dev, i) for i in range(3)]
    state = T.init_train_state(model, gen(dev), tcfg, device=dev, mesh=src)
    S.input_fan_in(state.params)
    step = T.make_train_step(model, tcfg)
    losses = []
    with ctx.use_mesh(src):
        for b in batches[:2]:
            state, m = step(state, placed(src, b))
            losses.append(float(whole(m["loss"])))
    if dist.get_rank() == 0 and os.path.exists(CKPT_DIR):
        shutil.rmtree(CKPT_DIR)
    dist.barrier()
    leaves = [t for t in tree_leaves(state) if t is not None]
    shard_bytes = sum(local(t).numel() * t.element_size() for t in leaves)
    largest = max(t.numel() * t.element_size() for t in leaves)
    reset_peak(dev)
    before = (torch.cuda.memory_allocated() if dev.type == "cuda"
              else None)
    path, save_s = timed(dev, lambda: ckpt.save(CKPT_DIR, 2, state))
    save_peak = peak(dev)
    written = sum(os.path.getsize(os.path.join(path, f))
                  for f in os.listdir(path))
    with ctx.use_mesh(src):
        state, m = step(state, placed(src, batches[2]))
        trajectory = float(whole(m["loss"]))
    del state, m
    reset_peak(dev)
    like = T.abstract_train_state(model, tcfg)
    sh = shardings_for_shaped(dst, like, T.train_state_specs(model, tcfg))
    restored, restore_s = timed(dev, lambda: ckpt.restore(
        CKPT_DIR, 2, like, shardings=sh))
    T.trainable(restored.params)
    ops.reset_launch_counts()
    with ctx.use_mesh(dst):
        _, m = step(restored, placed(dst, batches[2]))
        again = float(whole(m["loss"]))
    n_launch = launches()
    peaks = gathered(save_peak)
    bound = shard_bytes + largest + SAVE_SLACK
    del restored, m
    dist.barrier()
    if dist.get_rank() == 0:
        shutil.rmtree(CKPT_DIR)
    line = {"part": "elastic", "model": ELASTIC_ARCH, "from": ELASTIC_FROM,
            "to": ELASTIC_TO, "n_layers": n,
            "n_layers_configured": get_config(ELASTIC_ARCH).n_layers,
            "param_dtype": cfg.param_dtype, "global_batch": ELASTIC_BATCH,
            "seq": seq, "disk_free_bytes": free, "losses": losses,
            "trajectory_loss": trajectory, "restored_loss": again,
            "loss_diff": abs(again - trajectory), "tol": ELASTIC_TOL,
            "save_s": save_s, "restore_s": restore_s,
            "bytes_written": written, "leaves": len(leaves),
            "shard_bytes_a_card": shard_bytes,
            "largest_leaf_bytes": largest,
            "allocated_before_save": before,
            "save_max_memory_allocated": save_peak,
            "save_max_memory_allocated_every_rank": peaks,
            "save_peak_bound": bound, "launches": n_launch}
    line["ok"] = (abs(again - trajectory) <= ELASTIC_TOL and n_launch == 0
                  and math.isfinite(again)
                  and (cpu or max(peaks) <= bound))
    return line


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
        raise SystemExit("mesh_train_cards: needs 4 CUDA devices and NCCL "
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
        smi = None if cpu else subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()
        print(json.dumps({"nvidia_smi": smi, "world": world,
                          "torch": torch.__version__}), flush=True)
    meshes = {name: M.make_test_mesh(data, model, pod,
                                     device_type=dev.type)
              for name, (pod, data, model) in MESHES.items()}
    ok = True

    def emit(line: dict) -> None:
        nonlocal ok
        flags = gathered(bool(line.get("ok", True)))
        ok &= all(flags)
        if rank == 0:
            print(json.dumps({**line, "ok_every_rank": all(flags),
                              "elapsed_s": time.perf_counter() - t_start}),
                  flush=True)

    if "contract" in parts:
        for arch in CONTRACT_ARCHS:
            for line in contract(arch, meshes, dev, cpu):
                emit(line)
    if "deep" in parts:
        for arch in DEEP_ARCHS:
            emit(deep(arch, meshes[DEEP_MESH], dev, cpu))
    if "elastic" in parts:
        emit(elastic(meshes, dev, cpu))
    if "compression" in parts:
        for line in compression(meshes, dev, cpu):
            emit(line)
    M.shutdown()
    if rank == 0:
        print(json.dumps({"ok": bool(ok), "device": None if cpu else {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
