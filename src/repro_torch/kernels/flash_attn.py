"""Launch wrapper of the flash attention kernel (csrc/flash_attn.cu).

Replaces the Pallas kernel `flash_attention` (src/repro/kernels/flash_attn.py):
online-softmax attention, q [B, Sq, H, D], k / v [B, Sk, KV, D] with
H % KV == 0, causal mask top-left aligned (column <= row), f32 scores and
accumulation, output in q's type.  f32 or bf16 inputs, any D <= 256, any
Sq and Sk (the kernel masks ragged tiles; the reference wrapper's
`S % block == 0` does not apply).  bf16 runs on the tensor cores (wgmma),
f32 on the CUDA cores.  CUDA tensors only (kernels/ops.py routes CPU
tensors to kernels/ref.py).
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build

MAX_HEAD_DIM = 256
MAX_BATCH_HEADS = 65535   # batch * heads: the grid's y dimension
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def padded_head_dim(d: int) -> tuple[int, int]:
    """(d8, dp) of the bf16 kernel for head dim d: the width it reads from
    device memory, d zero-padded to a multiple of 8 (TMA's 16-byte rows),
    and the width its products run over, d rounded up to a multiple of 16
    (wgmma's reduction depth; the copies zero-fill the columns between)."""
    return -(-d // 8) * 8, -(-d // 16) * 16


def flash_attention(q, k, v, *, scale: float, causal: bool = True):
    """Attention output like q, from one launch."""
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: q, k, v must share a type of "
                         f"f32 / bf16, got {q.dtype}, {k.dtype}, {v.dtype}")
    q, k, v = (t.contiguous() for t in (q, k, v))
    build.require_cuda("flash_attention", q, k, v)
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, sk, kvh, d) or v.shape != k.shape or h % kvh:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}: want k, v "
                         "[B, Sk, KV, D] with H % KV == 0")
    if d > MAX_HEAD_DIM or b * h > MAX_BATCH_HEADS:
        raise ValueError(f"flash_attention: head dim {d} (at most "
                         f"{MAX_HEAD_DIM}), batch x heads {b * h} (at most "
                         f"{MAX_BATCH_HEADS})")
    if q.numel() == 0 or sk == 0:
        return torch.zeros_like(q)
    dk, dp = d, d
    if q.dtype == torch.bfloat16:
        dk, dp = padded_head_dim(d)
        if dk != d:
            q, k, v = (F.pad(t, (0, dk - d)) for t in (q, k, v))
        q, k, v = (build.aligned(t) for t in (q, k, v))
    o = torch.empty_like(q)
    fn = build.function("flash_attn", "steam_flash_attention", [
        *[ctypes.c_void_p] * 4, *[ctypes.c_int] * 8, ctypes.c_float,
        ctypes.c_int, ctypes.c_void_p])
    code = fn(build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(o),
              _DTYPES[q.dtype], b, sq, sk, h, kvh, dk, dp, float(scale),
              int(bool(causal)), build.stream_of(q))
    build.check("flash_attn", "flash_attention launch", code)
    build.count_launch("flash_attention")
    return o if dk == d else o[..., :d].contiguous()
