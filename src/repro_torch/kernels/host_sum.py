"""Launch wrapper of the per-host sum kernel (csrc/host_sum.cu).

The scheduler's per-host sums (`scheduler._per_host_sum`: used cores and
GPUs, and the utilization-weighted ones) on the card: each host's running
tasks added in task order, so a run gives the same bits every time and the
CPU's (`ref.per_host_sum`, whose `scatter_add_` adds in task order there).
The port's own kernel: the reference has no Pallas kernel here (it calls
`jax.ops.segment_sum`).  Two value channels share one bin vector, all of
one shape, [T] or [B, T]; bins are int64, spare bins >= H dropped.  CUDA
tensors only (kernels/ops.py routes CPU tensors to kernels/ref.py).
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import build

THREADS = 1024
TILE = (THREADS - 32) * 4          # tasks a round (csrc: kTile)
SMEM_MAX = 232448                  # an H100 block's shared-memory ceiling
STATIC_SMEM = 4 * (THREADS // 32 - 1) + 8


def smem_bytes(h: int) -> int:
    """Dynamic shared memory of a launch on `h` hosts (csrc:
    host_sum_smem): two accumulators and two compacted tiles."""
    return 4 * (2 * (-(-h // 4) * 4) + 6 * TILE)


MAX_HOSTS = (SMEM_MAX - STATIC_SMEM - smem_bytes(0)) // 8 // 4 * 4

_ARGS = [*[ctypes.c_void_p] * 3, *[ctypes.c_int] * 3,
         *[ctypes.c_void_p] * 3]


def per_host_sum(v0, v1, seg, h: int) -> tuple:
    """(sums of v0, sums of v1), each [..., h] f32, from one launch."""
    v0, v1 = build.f32(v0), build.f32(v1)
    seg = (seg if seg.dtype == torch.int64 else seg.long()).contiguous()
    build.require_cuda("per_host_sum", v0, v1, seg)
    if v0.shape != seg.shape or v1.shape != seg.shape:
        raise ValueError(f"per_host_sum: values {tuple(v0.shape)}, "
                         f"{tuple(v1.shape)} and bins {tuple(seg.shape)} "
                         f"must share one shape, [T] or [B, T]")
    if not 1 <= h <= MAX_HOSTS:
        raise ValueError(f"per_host_sum keeps its accumulators in shared "
                         f"memory: 1 to {MAX_HOSTS} hosts, got {h}")
    *lead, t = seg.shape
    out = torch.empty((2, *lead, h), dtype=torch.float32, device=seg.device)
    fn = build.function("host_sum", "steam_host_sum", _ARGS)
    code = fn(build.ptr(v0), build.ptr(v1), build.ptr(seg),
              math.prod(lead), t, h, build.ptr(out[0]), build.ptr(out[1]),
              build.stream_of(seg))
    build.check("host_sum", "per_host_sum launch", code)
    build.count_launch("per_host_sum")
    return out[0], out[1]
