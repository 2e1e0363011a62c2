"""Launch wrapper of the first-fit placement kernel (csrc/first_fit.cu).

Replaces the Pallas kernel `first_fit_place` (src/repro/kernels/first_fit.py)
and, in the engine, the reference scheduler's `lax.while_loop` placement:
each of K candidates takes the lowest-index host whose free cores and GPUs
both cover its demand.  Candidates with +inf demand are inert; hosts with
-inf free capacity never fit.  Inputs are f32 [K] and [H], or [B, K] and
[B, H] with one scenario row per thread block.  CUDA tensors only
(kernels/ops.py routes CPU tensors to kernels/ref.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# the shared-memory ceiling of one Hopper thread block: 227 KB holds the
# two f32 free vectors of up to this many hosts
MAX_HOSTS = (232448 - 1024) // 8


def first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus):
    """(assign i32, new free cores, new free GPUs) from one launch."""
    one_d = cand_cores.dim() == 1
    cc, cg, fc, fg = (x.reshape(1, -1) if one_d else x
                      for x in (cand_cores, cand_gpus, free_cores, free_gpus))
    cc, cg, fc, fg = (x.to(torch.float32).contiguous()
                      for x in (cc, cg, fc, fg))
    build.require_cuda("first_fit_place", cc, cg, fc, fg)
    b, k = cc.shape
    h = fc.shape[1]
    if cg.shape != (b, k) or fc.shape != (b, h) or fg.shape != (b, h):
        raise ValueError("first_fit_place: candidate vectors must be [B, K] "
                         "and free vectors [B, H]")
    if h > MAX_HOSTS:
        raise ValueError(f"first_fit_place keeps the free vectors in shared "
                         f"memory: at most {MAX_HOSTS} hosts, got {h}")
    assign = torch.empty((b, k), dtype=torch.int32, device=cc.device)
    out_c = torch.empty_like(fc)
    out_g = torch.empty_like(fg)
    fn = build.function("first_fit", "steam_first_fit", [
        *[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_void_p] * 4])
    code = fn(build.ptr(cc), build.ptr(cg), build.ptr(fc), build.ptr(fg),
              b, k, h, build.ptr(assign), build.ptr(out_c), build.ptr(out_g),
              build.stream_of(cc))
    build.check("first_fit", "first_fit_place launch", code)
    build.count_launch("first_fit_place")
    if one_d:
        return assign[0], out_c[0], out_g[0]
    return assign, out_c, out_g
