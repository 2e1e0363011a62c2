"""Launch wrapper of the SSD intra-chunk kernel (csrc/ssd_chunk.cu).

Replaces the Pallas kernel `ssd_intra_chunk` (src/repro/kernels/ssd_chunk.py):
per (batch, chunk, head)

    y[q, p] = sum_{k <= q} exp(cum[q] - cum[k]) * (C_q . B_k) * xdt[k, p]

with `cum` the in-chunk inclusive cumsum of `da`.  Inputs f32 (others are
converted): xdt [B, C, Q, H, P], da [B, C, H, Q], b / c [B, C, Q, G, N]
with H % G == 0 (head h reads group h // (H // G); G == H is the reference
kernel's repeated form).  CUDA tensors only (kernels/ops.py routes CPU
tensors to kernels/ref.py).
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_BLOCK_ROWS = 65535   # batch * chunks: the grid's y dimension


def ssd_intra_chunk(xdt, da, b, c):
    """y_intra f32 [B, C, Q, H, P] from one launch."""
    xdt, da, b, c = (t.to(torch.float32).contiguous() for t in (xdt, da, b, c))
    build.require_cuda("ssd_intra_chunk", xdt, da, b, c)
    if xdt.dim() != 5:
        raise ValueError(f"ssd_intra_chunk: xdt must be [B, C, Q, H, P], got "
                         f"{tuple(xdt.shape)}")
    bt, nc, q, h, p = xdt.shape
    g, n = b.shape[-2], b.shape[-1]
    if (da.shape != (bt, nc, h, q) or b.shape != (bt, nc, q, g, n)
            or c.shape != b.shape or h % g):
        raise ValueError(
            f"ssd_intra_chunk: shapes xdt {tuple(xdt.shape)}, da "
            f"{tuple(da.shape)}, b {tuple(b.shape)}, c {tuple(c.shape)}: "
            "want da [B,C,H,Q] and b, c [B,C,Q,G,N] with H % G == 0")
    if bt * nc > MAX_BLOCK_ROWS:
        raise ValueError(f"ssd_intra_chunk: at most {MAX_BLOCK_ROWS} "
                         f"batch x chunk rows, got {bt * nc}")
    y = torch.empty_like(xdt)
    if y.numel() == 0:
        return y
    fn = build.function("ssd_chunk", "steam_ssd_intra_chunk", [
        *[ctypes.c_void_p] * 5, *[ctypes.c_int] * 6, ctypes.c_void_p])
    code = fn(build.ptr(xdt), build.ptr(da), build.ptr(b), build.ptr(c),
              build.ptr(y), bt * nc, q, h, g, n, p, build.stream_of(xdt))
    build.check("ssd_chunk", "ssd_intra_chunk launch", code)
    build.count_launch("ssd_intra_chunk")
    return y
