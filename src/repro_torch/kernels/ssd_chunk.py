"""Launch wrapper of the SSD intra-chunk kernel (csrc/ssd_chunk.cu).

Replaces the Pallas kernel `ssd_intra_chunk` (src/repro/kernels/ssd_chunk.py):
per (batch, chunk, head)

    y[q, p] = sum_{k <= q} exp(cum[q] - cum[k]) * (C_q . B_k) * xdt[k, p]

with `cum` the in-chunk inclusive cumsum of `da`.  Inputs f32 (others are
converted): xdt [B, C, Q, H, P], da [B, C, H, Q], b / c [B, C, Q, G, N]
with H % G == 0 (head h reads group h // (H // G); G == H is the reference
kernel's repeated form).  One block takes a slab of `slab_heads(...)`
heads of one group and shares their score tiles.  CUDA tensors only
(kernels/ops.py routes CPU tensors to kernels/ref.py).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

H100_SMS = 132
MAX_SLAB = 8


def slab_heads(rows: int, groups: int, heads_per_group: int,
               sms: int = H100_SMS) -> int:
    """Heads of one group that a block takes (R): the most, up to MAX_SLAB,
    that still give every SM at least two blocks (rows * groups *
    ceil(heads_per_group / R) >= 2 * sms); 1 where no R does."""
    r = min(MAX_SLAB, heads_per_group)
    while r > 1 and rows * groups * -(-heads_per_group // r) < 2 * sms:
        r -= 1
    return r


def _pad4(t):
    """t zero-padded on its last axis to a multiple of 4 (16-byte rows)."""
    extra = -t.shape[-1] % 4
    return F.pad(t, (0, extra)) if extra else t


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
    if xdt.numel() == 0:
        return torch.empty_like(xdt)
    r = slab_heads(bt * nc, g, h // g)
    xp, b, c = (build.aligned(_pad4(t)) for t in (xdt, b, c))
    pp, n4 = xp.shape[-1], b.shape[-1]
    y = torch.empty_like(xp)
    cum = torch.empty_like(da)
    fn = build.function("ssd_chunk", "steam_ssd_intra_chunk", [
        *[ctypes.c_void_p] * 6, *[ctypes.c_int] * 7, ctypes.c_void_p])
    code = fn(build.ptr(xp), build.ptr(da), build.ptr(b), build.ptr(c),
              build.ptr(y), build.ptr(cum), bt * nc, q, h, g, n4, pp, r,
              build.stream_of(xdt))
    build.check("ssd_chunk", "ssd_intra_chunk launch", code)
    build.count_launch("ssd_intra_chunk")
    return y if pp == p else y[..., :p].contiguous()
