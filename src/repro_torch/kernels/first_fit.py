"""Launch wrapper of the first-fit placement kernel (csrc/first_fit.cu).

Replaces the Pallas kernel `first_fit_place` (src/repro/kernels/first_fit.py)
and, in the engine, the reference scheduler's `lax.while_loop` placement:
each of K candidates takes the lowest-index host whose free cores and GPUs
both cover its demand.  Candidates with +inf demand are inert; hosts with
-inf free capacity never fit.  Inputs are f32 [K] and [H], or [B, K] and
[B, H], one scenario row per warp (H <= WARP_MAX_HOSTS) or per thread block
(larger H).  CUDA tensors only (kernels/ops.py routes CPU tensors to
kernels/ref.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

# the warp variant: 32 lanes of HOSTS_PER_LANE hosts in registers, rows
# ROWS_PER_BLOCK to a block
HOSTS_PER_LANE = 32
WARP_MAX_HOSTS = 32 * HOSTS_PER_LANE
ROWS_PER_BLOCK = 4
# the block variant: the shared-memory ceiling of one Hopper thread block,
# 227 KB, holds the two f32 free vectors of up to this many hosts
MAX_HOSTS = (232448 - 1024) // 8

_BLOCK_ARGS = [*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 3,
               *[ctypes.c_void_p] * 4]
_WARP_ARGS = [*[ctypes.c_void_p] * 4, *[ctypes.c_int] * 5,
              *[ctypes.c_void_p] * 4]


def variant(h: int) -> str:
    """The kernel that places onto `h` hosts: "warp" holds them in one
    warp's registers, "block" in a thread block's shared memory."""
    return "warp" if h <= WARP_MAX_HOSTS else "block"


def warp_grid(b: int) -> tuple[int, int]:
    """(blocks, threads a block) of the warp variant's launch for `b` rows
    (the block variant launches one 256-thread block a row)."""
    return -(-b // ROWS_PER_BLOCK), 32 * ROWS_PER_BLOCK


def first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus):
    """(assign i32, new free cores, new free GPUs) from one launch.  The
    outputs have the inputs' shapes; the two free vectors share one
    allocation."""
    cc, cg, fc, fg = (build.f32(x) for x in (cand_cores, cand_gpus,
                                             free_cores, free_gpus))
    build.require_cuda("first_fit_place", cc, cg, fc, fg)
    one_d = cc.dim() == 1
    b, k = (1, cc.shape[0]) if one_d else cc.shape
    h = fc.shape[-1]
    rows = (k,) if one_d else (b, k)
    hosts = (h,) if one_d else (b, h)
    if cg.shape != rows or fc.shape != hosts or fg.shape != hosts:
        raise ValueError("first_fit_place: candidate vectors must be [B, K] "
                         "and free vectors [B, H], or [K] and [H]")
    if h > MAX_HOSTS:
        raise ValueError(f"first_fit_place keeps the free vectors in shared "
                         f"memory: at most {MAX_HOSTS} hosts, got {h}")
    assign = torch.empty(rows, dtype=torch.int32, device=cc.device)
    out = torch.empty((2, *hosts), dtype=torch.float32, device=cc.device)
    ptrs = (cc.data_ptr(), cg.data_ptr(), fc.data_ptr(), fg.data_ptr())
    outs = (assign.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * b * h,
            build.stream_of(cc))
    if variant(h) == "warp":
        fn = build.function("first_fit", "steam_first_fit_warp", _WARP_ARGS)
        code = fn(*ptrs, b, k, h, *warp_grid(b), *outs)
    else:
        fn = build.function("first_fit", "steam_first_fit", _BLOCK_ARGS)
        code = fn(*ptrs, b, k, h, *outs)
    build.check("first_fit", "first_fit_place launch", code)
    build.count_launch("first_fit_place")
    out_c, out_g = out
    return assign, out_c, out_g
