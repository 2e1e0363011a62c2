"""Building blocks of the model substrate's serving path.

The port of the reference package's `models/layers.py`, the parts the
`ssm`, `hybrid`, `dense` and `vlm` families use: parameter tables and their
initialisation, normalisation, rotary embeddings, attention (prefill, with
the local / global window of a layer, and one-token decode against a KV
cache), the gated feed-forward block, embedding and logits.
Everything is a function over explicit parameter dicts whose leaves carry
the reference's stacked layer axes, so a parameter tree converts leaf for
leaf (`models/convert.py`).

Numerics as in the reference: parameters live in `cfg.param_dtype`, matrix
products run in `cfg.compute_dtype`, normalisation statistics and softmax
in f32.  The port runs on one device, so the reference's sharding
constraints are dropped.  Two liberties, both bit-neutral:

  * `cast_for_compute` makes the compute-type copy of each weight once;
    the reference casts at every use, which gives the same bits.
  * `cache_update` (and so `attention_decode`) writes the KV cache in
    place and returns the same tensors; the reference returns new arrays.

Attention with no softcap and no window goes through
`kernels.ops.flash_attention`: the tensor's device decides (the kernel on
the card, its plain version on the CPU), not `cfg.attn_impl`.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .config import ArchConfig

F32 = torch.float32
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# --------------------------------------------------------------------------
# parameter definition tables
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamDef:
    shape: tuple[int, ...]
    init: str = "normal"          # normal | zeros | ones | embed
    scale: float = 1.0            # fan-in style scale multiplier
    dtype: str | None = None      # override cfg.param_dtype


class TensorSpec(NamedTuple):
    """Shape and type of a tensor that is not allocated yet."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def _c(w, dt: torch.dtype):
    """`w` in type `dt` (no copy when it already is)."""
    return w if w.dtype == dt else w.to(dt)


def _init_leaf(gen, d: ParamDef, dtype: str, device) -> torch.Tensor:
    dt = dtype_of(d.dtype or dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "embed":
        std = d.scale
    else:  # fan-in scaled normal: last-but-one axis is fan-in for matrices
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    x = torch.randn(d.shape, generator=gen, dtype=F32, device=device)
    return x.mul_(std).to(dt)


def init_params(defs: dict, generator: torch.Generator, param_dtype: str,
                device) -> dict:
    """Materialise a ParamDef tree, leaves in sorted path order, each drawn
    from `generator` (which lives on `device`).  The draws are PyTorch's:
    the same seed gives other weights than the reference's `jax.random`."""
    flat = {path: _init_leaf(generator, d, param_dtype, device)
            for path, d in sorted(flatten(defs).items())}
    return unflatten(flat)


def flatten(tree, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def unflatten(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = v
    return out


def tree_map(fn: Callable, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_defs(defs: dict, n: int) -> dict:
    """Prefix every ParamDef with a stacked layer axis of length n."""
    return tree_map(lambda d: replace(d, shape=(n,) + d.shape), defs)


def layer(tree: dict, *idx) -> dict:
    """The slice of a stacked parameter tree at layer index `idx` (views)."""
    return tree_map(lambda a: a[idx], tree)


# leaves (and subtrees) the forward reads in f32, never in the compute type
_NOT_CAST = ("a_log", "dt_bias", "gate_norm")
_NORMS = ("ln", "ln1", "ln2", "ln_f", "q_norm", "k_norm", "post_attn",
          "post_mlp")


def cast_for_compute(cfg: ArchConfig, params: dict) -> dict:
    """The parameter tree with every weight that the forward casts to
    `cfg.compute_dtype` before use (matrices, convolutions, embedding,
    skip gains) cast once; norm weights and the SSM's decay and step
    parameters, which the forward reads in f32, stay as they are."""
    cdt = dtype_of(cfg.compute_dtype)
    flat = flatten(params)
    return unflatten({
        path: w if (path[-1] in _NOT_CAST
                    or any(p in _NORMS for p in path)) else _c(w, cdt)
        for path, w in flat.items()})


# --------------------------------------------------------------------------
# normalisation
# --------------------------------------------------------------------------

def rms_norm(x, w, eps: float, plus_one: bool = False):
    dt = x.dtype
    x = x.to(F32)
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    scale = (1.0 + w.to(F32)) if plus_one else w.to(F32)
    return (x * scale).to(dt)


def layer_norm(x, w, b, eps: float):
    dt = x.dtype
    x = x.to(F32)
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * w.to(F32) + b.to(F32)).to(dt)


def _gemma_like(cfg: ArchConfig) -> bool:
    return cfg.name.startswith(("gemma", "paligemma"))


def norm_defs(cfg: ArchConfig, kind: str | None = None) -> dict:
    kind = kind or getattr(cfg, "norm", "rms")
    if cfg.family == "encdec" or kind == "layer":
        return {"w": ParamDef((cfg.d_model,), "ones"),
                "b": ParamDef((cfg.d_model,), "zeros")}
    init = "zeros" if _gemma_like(cfg) else "ones"   # gemma stores w-1
    return {"w": ParamDef((cfg.d_model,), init)}


def apply_norm(cfg: ArchConfig, p: dict, x):
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps, plus_one=_gemma_like(cfg))


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_angles(positions, dim: int, theta: float):
    """positions int[...]; returns (cos, sin) f32[..., dim//2]."""
    freqs = theta ** (-torch.arange(0, dim, 2, dtype=F32,
                                    device=positions.device) / dim)
    ang = positions.to(F32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, rope_dim: int | None = None):
    """x: [..., S, H, D] (cos/sin [..., S, d/2] broadcast over H)."""
    d = rope_dim or x.shape[-1]
    rot, rest = x[..., :d], x[..., d:]
    x1, x2 = rot[..., : d // 2], rot[..., d // 2:]
    c = cos[..., None, :].to(x.dtype)
    s = sin[..., None, :].to(x.dtype)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return torch.cat([out, rest], dim=-1) if rest.shape[-1] else out


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def _softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x


def attn_defs(cfg: ArchConfig, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    defs = {"wq": ParamDef((d, h, hd)), "wk": ParamDef((d, kv, hd)),
            "wv": ParamDef((d, kv, hd)), "wo": ParamDef((h, hd, d))}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), "zeros")
        defs["bk"] = ParamDef((kv, hd), "zeros")
        defs["bv"] = ParamDef((kv, hd), "zeros")
    if cfg.qk_norm:
        init = "zeros" if _gemma_like(cfg) else "ones"
        defs["q_norm"] = ParamDef((hd,), init)
        defs["k_norm"] = ParamDef((hd,), init)
    return defs


def _proj_heads(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _merge_heads(out, wo):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return out.reshape(*out.shape[:-2], h * k) @ wo.reshape(h * k, d)


def _qk_project(cfg: ArchConfig, p: dict, x, positions, theta: float):
    cdt = dtype_of(cfg.compute_dtype)
    q = _proj_heads(x, _c(p["wq"], cdt))
    k = _proj_heads(x, _c(p["wk"], cdt))
    v = _proj_heads(x, _c(p["wv"], cdt))
    if "bq" in p:
        q = q + _c(p["bq"], cdt)
        k = k + _c(p["bk"], cdt)
        v = v + _c(p["bv"], cdt)
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, plus_one=_gemma_like(cfg))
        k = rms_norm(k, p["k_norm"], cfg.norm_eps, plus_one=_gemma_like(cfg))
    cos, sin = rope_angles(positions, cfg.hd, theta)
    return apply_rope(q, cos, sin), apply_rope(k, cos, sin), v


def causal_mask(s_q: int, s_k: int, q_offset: int = 0, window: int = 0,
                device=None):
    """bool[s_q, s_k]; True = attend.  window>0 adds a sliding-window band."""
    qi = torch.arange(s_q, device=device)[:, None] + q_offset
    ki = torch.arange(s_k, device=device)[None, :]
    m = ki <= qi
    if window:
        m &= ki > qi - window
    return m


def sdpa(q, k, v, mask, scale: float, softcap: float = 0.0):
    """q:[B,Sq,H,D] k/v:[B,Sk,KV,D]; GQA broadcast; f32 softmax."""
    b, sq, h, d = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k).to(F32) * scale
    logits = _softcap(logits, softcap)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v)
    return out.reshape(b, sq, h, v.shape[-1])


def sdpa_blockwise(q, k, v, scale: float, softcap: float = 0.0, *,
                   block: int, window: int = 0, q_offset: int = 0):
    """`sdpa` over query blocks of `block` rows (causal + optional sliding
    window), so the scores are [B, H, block, Sk] at a time; the reference
    falls back to one block when `block` does not divide Sq, and so does
    this."""
    sq, sk = q.shape[1], k.shape[1]
    blk = max(min(block, sq), 1)
    if sq % blk:
        blk = sq
    outs = []
    for q0 in range(0, sq, blk):
        m = causal_mask(blk, sk, q0 + q_offset, window, device=q.device)
        outs.append(sdpa(q[:, q0:q0 + blk], k, v, m, scale, softcap))
    return torch.cat(outs, dim=1)


def attention(cfg: ArchConfig, p: dict, x, positions, *, window: int = 0,
              theta: float | None = None, scale: float | None = None):
    """Full (prefill) self-attention with causal (+window) mask.  Without
    softcap and window it is `ops.flash_attention` (the kernel on the card);
    otherwise the blockwise or whole-matrix softmax of the reference."""
    theta = cfg.rope_theta if theta is None else theta
    q, k, v = _qk_project(cfg, p, x, positions, theta)
    scale = (1.0 / math.sqrt(cfg.hd)) if scale is None else scale
    if not cfg.attn_softcap and not window:
        out = ops.flash_attention(q, k, v, scale=scale, causal=True)
    elif cfg.attn_block:
        out = sdpa_blockwise(q, k, v, scale, cfg.attn_softcap,
                             block=cfg.attn_block, window=window)
    else:
        mask = causal_mask(x.shape[1], x.shape[1], 0, window, device=x.device)
        out = sdpa(q, k, v, mask, scale, cfg.attn_softcap)
    return _merge_heads(out, _c(p["wo"], out.dtype))


def layer_window(cfg: ArchConfig, layer_idx: int) -> int:
    """Sliding-window size of layer `layer_idx` (0 = global) under the
    config's local / global pattern: gemma2 (local_pattern 2) makes even
    layers local, gemma3 (6) every layer with idx % 6 != 5."""
    if not cfg.local_pattern:
        return 0
    is_local = layer_idx % cfg.local_pattern != cfg.local_pattern - 1
    return cfg.sliding_window if is_local else 0


def attention_traced_window(cfg: ArchConfig, p: dict, x, positions,
                            window: int):
    """Attention of a dense layer whose window is `layer_window`'s (the
    reference traces it; here it is a host integer, so `attention`'s
    dispatch applies: flash for a global layer without softcap)."""
    return attention(cfg, p, x, positions, window=window)


def cache_update(cache, new, pos: int):
    """Write `new` [B,T,...] into `cache` [B,S,...] at positions pos.. in
    place; returns `cache`."""
    cache[:, pos:pos + new.shape[1]] = new.to(cache.dtype)
    return cache


def attention_decode(cfg: ArchConfig, p: dict, x, cache_k, cache_v,
                     pos: int, *, window: int = 0,
                     theta: float | None = None, scale: float | None = None):
    """One-token decode against a KV cache.

    x: [B,1,D]; cache_k/v: [B,S,KV,hd], written in place at `pos` (a host
    integer: the batch decodes in step).  Returns (out, cache_k, cache_v).
    """
    theta = cfg.rope_theta if theta is None else theta
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qk_project(cfg, p, x, posv, theta)
    s = cache_k.shape[1]
    cache_update(cache_k, k, pos)
    cache_update(cache_v, v, pos)
    ki = torch.arange(s, device=x.device)
    mask = ki <= pos
    if window:
        mask &= ki > pos - window
    h, d = q.shape[2], q.shape[3]
    kvh = cache_k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d)
    scale = (1.0 / math.sqrt(cfg.hd)) if scale is None else scale
    logits = torch.einsum("bhgd,bkhd->bhgk", qg, cache_k).to(F32) * scale
    logits = _softcap(logits, cfg.attn_softcap)
    logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    out = torch.einsum("bhgk,bkhd->bhgd", probs, cache_v).reshape(b, 1, h, d)
    return _merge_heads(out, _c(p["wo"], out.dtype)), cache_k, cache_v


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def ffn_defs(cfg: ArchConfig, d_ff: int) -> dict:
    d = cfg.d_model
    if cfg.act == "gelu_mlp":   # plain 2-matrix MLP (whisper)
        return {"w_in": ParamDef((d, d_ff)),
                "b_in": ParamDef((d_ff,), "zeros"),
                "w_out": ParamDef((d_ff, d)),
                "b_out": ParamDef((d,), "zeros")}
    return {"w_gate": ParamDef((d, d_ff)), "w_up": ParamDef((d, d_ff)),
            "w_down": ParamDef((d_ff, d))}


def ffn(cfg: ArchConfig, p: dict, x):
    cdt = dtype_of(cfg.compute_dtype)
    if "w_in" in p:
        h = x @ _c(p["w_in"], cdt) + _c(p["b_in"], cdt)
        h = F.gelu(h, approximate="tanh")
        return h @ _c(p["w_out"], cdt) + _c(p["b_out"], cdt)
    act = _ACTS[cfg.act]
    h = act(x @ _c(p["w_gate"], cdt)) * (x @ _c(p["w_up"], cdt))
    return h @ _c(p["w_down"], cdt)


# --------------------------------------------------------------------------
# embedding / logits
# --------------------------------------------------------------------------

def embed_defs(cfg: ArchConfig) -> dict:
    vp = cfg.padded_vocab    # odd vocabs padded to a multiple of 256
    defs = {"tok": ParamDef((vp, cfg.d_model), "embed", scale=0.02)}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, vp))
    return defs


def embed(cfg: ArchConfig, p: dict, tokens):
    """Rows of the table in the compute type (the cast commutes with the
    gather, so only the gathered rows are cast)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = _c(p["tok"][tokens], cdt)
    if _gemma_like(cfg):
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=cdt,
                             device=x.device)
    return x


def logits_out(cfg: ArchConfig, p: dict, x):
    cdt = dtype_of(cfg.compute_dtype)
    w = _c(p["unembed"], cdt) if "unembed" in p else _c(p["tok"], cdt).T
    logits = _softcap((x @ w).to(F32), cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab:   # mask pad columns
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    return logits
