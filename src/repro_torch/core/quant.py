"""Quantized trace storage (bf16 / int8 affine) for the fused facility kernel.

  * `bf16` — half the bytes, relative error <= 2^-8.
  * `int8` — per-trace affine `x ~ q * scale + zero` over [min, max]: a
    quarter of the bytes, absolute error <= range/510.

`dequantize_trace` reconstructs f32; the CUDA facility kernel does the same
arithmetic on read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

STORES = ("f32", "bf16", "int8")


class QuantizedTrace(NamedTuple):
    """x ~ q.float() * scale + zero along the last axis.

    q:     bf16[..., S] or int8[..., S] payload
    scale: f32[..., 1]  per-trace scale (1.0 for bf16)
    zero:  f32[..., 1]  per-trace offset (0.0 for bf16)
    """
    q: torch.Tensor
    scale: torch.Tensor
    zero: torch.Tensor


def quantize_trace(x, store: str) -> QuantizedTrace:
    """Quantize f32[..., S] series along their last axis."""
    x = x.to(torch.float32)
    ones = torch.ones(x.shape[:-1] + (1,), dtype=torch.float32,
                      device=x.device)
    if store == "bf16":
        return QuantizedTrace(q=x.to(torch.bfloat16), scale=ones,
                              zero=torch.zeros_like(ones))
    if store == "int8":
        lo = torch.amin(x, dim=-1, keepdim=True)
        hi = torch.amax(x, dim=-1, keepdim=True)
        scale = torch.clamp(hi - lo, min=1e-12) / 255.0
        q = torch.round((x - lo) / scale - 128.0).to(torch.int8)
        return QuantizedTrace(q=q, scale=scale, zero=lo + 128.0 * scale)
    raise ValueError(f"unknown trace store '{store}'; pick one of {STORES}")


def dequantize_trace(qt: QuantizedTrace) -> torch.Tensor:
    """f32 reconstruction."""
    return qt.q.to(torch.float32) * qt.scale + qt.zero


def maybe_dequantize(v):
    """Pass tensors through, reconstruct QuantizedTraces (the grid's
    per-scenario trace payloads)."""
    return dequantize_trace(v) if isinstance(v, QuantizedTrace) else v
