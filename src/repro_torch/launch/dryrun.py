"""Multi-pod dry run: trace every (architecture x input-shape) cell against
the production meshes and record its roofline terms.

The port of the reference's `launch/dryrun.py`.  For each cell this
  1. makes the `fake` process group of 256 (single pod) or 512 (multi-pod)
     ranks, in this process only: no communication, every collective a
     no-op, no card (`launch.mesh.init_distributed(fake=True)`);
  2. builds the full-size config's train / prefill / decode step inputs
     as fake tensors (`FakeTensorMode`: shapes and types, nothing
     allocated) and places them on the mesh as DTensors by the model's
     partition-spec trees (dimensions the mesh does not divide
     replicated);
  3. runs the step once under `launch.op_analysis`, which counts one
     rank's matrix-product FLOPs, op-boundary bytes and collective bytes
     and tracks its live bytes;
  4. writes the record to results/dryrun/<cell>.json.

The models run with `use_kernels=False`, passed explicitly: fake tensors
give a kernel nothing to run on, so the dry run counts the plain paths
(the record says so).  Nothing is launched, as nothing runs in the
reference's dry run on XLA:CPU either.  The reference's lower and compile
times are one trace time here (`trace_s`).

The four small cells (`SMALL_CELLS`: the reference's
tests/test_dryrun_small.py, its overrides and shrunken shapes, on a
(2, 2, 2) ("pod", "data", "model") mesh of 8 fake ranks) are held to the
reference's records, committed as tests/data/torch_dryrun_reference.json,
by `check_small` (model FLOPs and parameter bytes exact, per-device matrix
FLOPs within 10 %); `--small` prints their records as one JSON line, which
tests/test_torch_dryrun.py and chip_smoke.py's phase 4f read on the
release of PyTorch they run.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --list
  python -m repro_torch.launch.dryrun --small
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import traceback

import torch

from ..configs import ARCH_IDS as ARCHS
from ..configs import SHAPES, cell_applicable, get_config
from ..distributed import ctx
from ..distributed.sharding import (put, shardings_for_shaped, tree_leaves,
                                    tree_map)
from ..models.config import MLAConfig, ShapeCell
from ..models.registry import get_model
from ..train.optimizer import AdamWConfig
from ..train.step import (TrainConfig, abstract_train_state, make_train_step,
                          train_state_specs)
from . import op_analysis
from .mesh import (HBM_BW, PEAK_FLOPS_BF16, axis_bandwidth, init_distributed,
                   make_production_mesh)

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun")


def build_cell_fn(arch_id: str, shape_name: str, mesh,
                  grad_compression: bool = False, overrides=None,
                  microbatches: int = 1, device="cpu", shape=None):
    """(fn, args, shardings, cfg, shape) of the cell's step.

    `args` are tensors without values on `device` (fake under an active
    `FakeTensorMode`), not yet placed; `shardings` their NamedShardings
    (`shardings_for_shaped`: a dimension the mesh does not divide
    replicated); `fn(*args)` the step.  `shape` (a ShapeCell) in place of
    `SHAPES[shape_name]`."""
    cfg = get_config(arch_id)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or SHAPES[shape_name]
    model = get_model(cfg)
    tcfg = TrainConfig(opt=AdamWConfig(), grad_compression=grad_compression,
                       microbatches=microbatches)
    if shape.kind == "train":
        state = abstract_train_state(model, tcfg, device)
        batch, bspecs = model.batch_specs(shape, device)
        args = (state, batch)
        specs = (train_state_specs(model, tcfg), bspecs)
        fn = make_train_step(model, tcfg)
    elif shape.kind == "prefill":
        batch, bspecs = model.batch_specs(shape, device)
        args = (model.abstract_params(device), batch)
        specs = (model.param_specs(), bspecs)

        def fn(params, batch):
            with torch.no_grad():
                return model.forward(params, batch, False)
    else:  # decode: the step's own plain path (it launches no kernel)
        (cache, tokens, pos), (cspec, tspec, _) = model.decode_specs(
            shape, device)
        args = (model.abstract_params(device), cache, tokens)
        specs = (model.param_specs(), cspec, tspec)

        def fn(params, cache, tokens):
            return model.decode_step(params, cache, tokens, pos)
    shardings = tuple(shardings_for_shaped(mesh, a, s)
                      for a, s in zip(args, specs))
    return fn, args, shardings, cfg, shape


def _fake_world(n: int):
    """The fake process group of `n` ranks (made anew if the size
    differs)."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_world_size() != n:
        dist.destroy_process_group()
    init_distributed(fake=True, world_size=n)


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             grad_compression: bool = False, overrides=None, tag: str = "",
             microbatches: int = 1, mesh=None, shape=None) -> dict:
    """The cell's record.  Without `mesh`, the production mesh on a fake
    world of 256 (512 multi-pod) ranks.  `shape` in place of
    `SHAPES[shape_name]`."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg0 = get_config(arch_id)
    shape = shape or SHAPES[shape_name]
    ok, why = cell_applicable(cfg0, shape)
    mesh_name = "multi" if multi_pod else "single"
    rec = {"arch": arch_id, "shape": shape_name, "mesh": mesh_name,
           "tag": tag, "status": "skip", "reason": why}
    if not ok:
        return rec
    if mesh is None:
        _fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    mode = FakeTensorMode()
    with mode, ctx.use_mesh(mesh):
        fn, args, shardings, cfg, shape = build_cell_fn(
            arch_id, shape_name, mesh, grad_compression, overrides,
            microbatches, shape=shape)
        args = tree_map(put, args, shardings)
        if shape.kind == "train":
            from ..train.step import trainable
            trainable(args[0].params)
        arg_bytes = sum(op_analysis._nbytes(t) for t in tree_leaves(args)
                        if t is not None)
        params = args[0].params if shape.kind == "train" else args[0]
        param_bytes = sum(op_analysis._nbytes(t)
                          for t in tree_leaves(params))
        out, totals, trace_s = op_analysis.count(fn, *args)
        out_bytes = sum(op_analysis._nbytes(t) for t in _leaves(out))
    full = op_analysis.analyze(totals)
    coll = dict(full["collectives"])
    coll["_counts"] = dict(full["counts"])

    chips = mesh.size()
    flops_dev = float(full["flops"])
    bytes_dev = float(full["bytes"])
    coll_dev = float(full["collective_bytes"])
    # a collective over the model axis (stride 1, 16 wide) or a data axis
    # of a mesh past one host's 8 cards crosses hosts: the network's rate
    bw = axis_bandwidth(chips)
    t_compute = flops_dev / PEAK_FLOPS_BF16
    t_memory = bytes_dev / HBM_BW
    t_coll = coll_dev / bw
    dominant = max(("compute", t_compute), ("memory", t_memory),
                   ("collective", t_coll), key=lambda kv: kv[1])[0]

    n_active = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    mult = 6 if shape.kind == "train" else 2
    model_flops = mult * n_active * tokens
    rec.update({
        "status": "ok",
        "chips": chips,
        "use_kernels": False,
        "note": ("traced on fake tensors on the fake backend; the models' "
                 "plain paths (use_kernels=False), no kernel launched"),
        "trace_s": round(trace_s, 2),
        "per_device": {
            "flops": flops_dev, "bytes": bytes_dev,
            "collective_bytes": coll_dev,
            "argument_bytes": int(arg_bytes),
            "param_bytes": int(param_bytes),
            "output_bytes": int(out_bytes),
            "peak_bytes": int(arg_bytes + totals.peak_rise),
        },
        "collectives": coll,
        "roofline": {
            "t_compute_s": t_compute, "t_memory_s": t_memory,
            "t_collective_s": t_coll, "dominant": dominant,
            "collective_bw": bw,
            "model_flops": float(model_flops),
            "flops_global": flops_dev * chips,
            "useful_ratio": float(model_flops / max(flops_dev * chips, 1.0)),
        },
    })
    return rec


# --------------------------------------------------------------------------
# the four small cells held to the reference's records
# --------------------------------------------------------------------------

# tests/test_dryrun_small.py's cells: one dense and one MoE train cell, an
# MLA decode and an SSM decode
SMALL_CELLS = (("qwen2-1.5b", "train"), ("qwen3-moe-235b-a22b", "train"),
               ("deepseek-v2-236b", "decode"), ("mamba2-2.7b", "decode"))
# its shrunken shapes, under the names of the shapes they stand for
SMALL_SHAPES = {"train": ShapeCell("train_4k", 128, 8, "train"),
                "decode": ShapeCell("decode_32k", 128, 8, "decode")}
# per-device matrix FLOPs may miss the reference's by this share
SMALL_FLOPS_RTOL = 0.10


def small_overrides(arch_id: str) -> dict:
    """tests/test_dryrun_small.py's overrides of `arch_id`'s config."""
    cfg = get_config(arch_id)
    if cfg.family == "ssm":
        return dict(n_layers=2, d_model=64, vocab=512,
                    ssm=dataclasses.replace(cfg.ssm, d_state=16,
                                            head_dim=16))
    if cfg.family != "moe":
        return dict(n_layers=2, d_model=64, d_ff=128, vocab=512,
                    head_dim=16, n_heads=4, n_kv_heads=2)
    o = dict(n_layers=2, d_model=64, d_ff=64, vocab=512, head_dim=16,
             n_heads=4, n_kv_heads=2,
             moe=dataclasses.replace(cfg.moe, n_experts=8, top_k=2,
                                     d_ff_expert=32, router_group=64))
    if cfg.mla is not None:
        o["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                             rope_head_dim=8, nope_head_dim=16,
                             v_head_dim=16)
        o.update(head_dim=24, n_heads=4, n_kv_heads=4)
    return o


def run_small_cells(cells=SMALL_CELLS) -> dict:
    """{arch: record} of the small cells on a (2, 2, 2) mesh of the fake
    backend's world of 8 (made here; destroyed at the end)."""
    from .mesh import make_test_mesh, shutdown
    _fake_world(8)
    mesh = make_test_mesh(2, 2, 2, device_type="cpu")
    out = {}
    for arch, kind in cells:
        out[arch] = run_cell(arch, SMALL_SHAPES[kind].name, False,
                             overrides=small_overrides(arch), mesh=mesh,
                             shape=SMALL_SHAPES[kind])
    shutdown()
    return out


def check_small(rec: dict, ref: dict) -> dict:
    """A small cell's record against the reference's (`ref`: its model
    FLOPs, per-device parameter bytes and matrix FLOPs): the fields
    compared, the relative miss of the FLOPs, and `ok`."""
    per = rec["per_device"]
    rel = per["flops"] / ref["flops"] - 1.0
    checks = {"status": rec["status"] == "ok",
              "model_flops": rec["roofline"]["model_flops"]
              == ref["model_flops"],
              "param_bytes": per["param_bytes"] == ref["param_bytes"],
              "flops": abs(rel) <= SMALL_FLOPS_RTOL}
    return {"flops": per["flops"], "ref_flops": ref["flops"],
            "flops_rel": rel, "param_bytes": per["param_bytes"],
            "ref_param_bytes": ref["param_bytes"], "checks": checks,
            "ok": all(checks.values())}


def _leaves(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def cell_path(rec_or_key, out_dir=RESULTS_DIR):
    if isinstance(rec_or_key, dict):
        key = (rec_or_key["arch"], rec_or_key["shape"], rec_or_key["mesh"],
               rec_or_key.get("tag", ""))
    else:
        key = rec_or_key
    arch, shape, mesh, tag = key
    name = f"{arch}__{shape}__{mesh}" + (f"__{tag}" if tag else "")
    return os.path.join(out_dir, name + ".json")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args(argv)

    if args.small:
        print(json.dumps({"torch": torch.__version__,
                          "records": run_small_cells()}))
        return

    if args.list:
        for a in ARCHS:
            for s in SHAPES:
                ok, why = cell_applicable(get_config(a), SHAPES[s])
                print(f"{a:24s} {s:12s} {'OK' if ok else 'SKIP: ' + why}")
        return

    archs = list(ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(args.out, exist_ok=True)
    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                key = (arch, shape, "multi" if mp else "single", args.tag)
                path = cell_path(key, args.out)
                if os.path.exists(path) and not args.force:
                    print(f"[cached] {key}")
                    continue
                print(f"[run] {key} ...", flush=True)
                try:
                    rec = run_cell(arch, shape, mp,
                                   grad_compression=args.grad_compression,
                                   tag=args.tag)
                except Exception as e:  # recorded, and the exit code says so
                    rec = {"arch": arch, "shape": shape,
                           "mesh": "multi" if mp else "single",
                           "tag": args.tag, "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    failures += 1
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                if rec["status"] == "ok":
                    r = rec["roofline"]
                    print(f"  ok: trace={rec['trace_s']}s "
                          f"dominant={r['dominant']} "
                          f"t=(C {r['t_compute_s']:.3e}, "
                          f"M {r['t_memory_s']:.3e}, "
                          f"X {r['t_collective_s']:.3e}) "
                          f"useful={r['useful_ratio']:.2f} "
                          f"peakMB={rec['per_device']['peak_bytes']/2**20:.0f}",
                          flush=True)
                elif rec["status"] == "skip":
                    print(f"  skip: {rec['reason']}")
                else:
                    print(f"  ERROR: {rec['error']}\n{rec['traceback']}")
    from .mesh import shutdown
    shutdown()
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
