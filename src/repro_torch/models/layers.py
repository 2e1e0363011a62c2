"""Building blocks of the model substrate.

The port of the reference package's `models/layers.py`, the parts the
model families use: parameter tables and their initialisation (a bf16
leaf drawn a few slabs at a time, never whole in f32), normalisation,
rotary embeddings, attention (prefill, with the local / global window of
a layer, the blockwise softmax with or without the causal mask, and
one-token decode against a KV cache), the gated and plain feed-forward
blocks, embedding, logits, the cross-entropy loss and activation
checkpointing (`remat_policy`, `checkpointed`).
Everything is a function over explicit parameter dicts whose leaves carry
the reference's stacked layer axes, so a parameter tree converts leaf for
leaf (`models/convert.py`).

Numerics as in the reference: parameters live in `cfg.param_dtype`, matrix
products run in `cfg.compute_dtype`, normalisation statistics and softmax
in f32.  Each `ParamDef` carries the reference's partition spec over
("pod", "data", "model") (`param_specs`), and the activations are
constrained where the reference constrains them (distributed/ctx.py: a
no-op without a mesh or on one device).  Two liberties, both bit-neutral:

  * `cast_for_compute` makes the compute-type copy of each weight once;
    the reference casts at every use, which gives the same bits.
  * `cache_update` (and so `attention_decode`) writes the KV cache in
    place and returns the same tensors; the reference returns new arrays.

Attention with no softcap and no window goes through
`kernels.ops.flash_attention`: the tensor's device decides (the kernel on
the card, its plain version on the CPU), not `cfg.attn_impl`.  With
`use_kernels=False` (the losses') attention is the reference's plain
path, the blockwise or whole-matrix softmax, as its training takes.

Training differentiates these functions with autograd.  Weights are cast
to the compute type at each use (`_c`), inside the graph, so gradients
reach the parameters; `cast_for_compute` is for serving only.  One
difference from the reference under a bf16 compute type: the embedding
gathers rows of the f32 table and casts them, so its backward adds
repeated tokens' gradients in f32, where the reference's gather of the
cast table adds them in bf16 (with f32 compute both are the same sums).

The reference's `scan_layers` has no counterpart: the port's Python loops
over layers are its unrolled form, and `checkpointed` wraps a loop's body
where the reference wraps its scan body in `jax.checkpoint`.
"""
from __future__ import annotations

import functools
import math
import threading
from dataclasses import dataclass, replace
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from ..core import telemetry
from ..core.config import inv_f32
from ..distributed.ctx import (P, attention_layout, constrain,
                               current_mesh, from_local, local_of,
                               made_on_mesh, on_key_shards, shard_offset,
                               split_dims, to_layout, use_mesh)
from ..kernels import ops
from .config import ArchConfig

BATCH = ("pod", "data")

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
    spec: P | None = None         # partition spec; None: replicated

    @property
    def partition(self) -> P:
        return self.spec if self.spec is not None else \
            P(*(None,) * len(self.shape))


class TensorSpec(NamedTuple):
    """Shape and type of a tensor that is not allocated yet."""
    shape: tuple[int, ...]
    dtype: torch.dtype


def dtype_of(name: str) -> torch.dtype:
    return DTYPES[name]


def _c(w, dt: torch.dtype):
    """`w` in type `dt` (no copy when it already is)."""
    return w if w.dtype == dt else w.to(dt)


_INIT_CHUNK = 1 << 26


def _init_leaf(gen, d: ParamDef, dtype: str, device,
               box=None) -> torch.Tensor:
    """The leaf `d` drawn from `gen`; with `box` ((start, length) a
    dimension) only that block of it, from the same draws."""
    dt = dtype_of(d.dtype or dtype)
    part = box is not None and any(n != m for (_, n), m in zip(box, d.shape))
    box = box or [(0, n) for n in d.shape]
    shape = tuple(n for _, n in box)
    cut = tuple(slice(a, a + n) for a, n in box)
    if d.init == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if d.init == "embed":
        std = d.scale
    else:  # fan-in scaled normal: last-but-one axis is fan-in for matrices
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
    if dt == F32 or len(d.shape) < 2:
        x = torch.randn(d.shape, generator=gen, dtype=F32, device=device)
        x = x[cut].clone() if part else x
        return x.mul_(std).to(dt)
    # a narrower type: drawn in f32 a few leading-axis slabs at a time (at
    # most _INIT_CHUNK elements, or one slab) into the final tensor, so no
    # f32 copy of the whole leaf is held (a bf16 stack of experts is tens
    # of GB); of each slab only the box's part is kept
    out = torch.empty(shape, dtype=dt, device=device)
    (a0, n0), rest = box[0], cut[1:]
    rows = max(_INIT_CHUNK // math.prod(d.shape[1:]), 1)
    for i in range(0, d.shape[0], rows):
        n = min(rows, d.shape[0] - i)
        x = torch.randn((n,) + d.shape[1:], generator=gen, dtype=F32,
                        device=device)
        lo, hi = max(i, a0), min(i + n, a0 + n0)
        if lo < hi:
            out[lo - a0:hi - a0] = x[(slice(lo - i, hi - i),) + rest].mul_(
                std)
    return out


def init_params(defs: dict, generator: torch.Generator, param_dtype: str,
                device, mesh=None) -> dict:
    """Materialise a ParamDef tree, leaves in sorted path order, each drawn
    from `generator` (which lives on `device`).  The draws are PyTorch's:
    the same seed gives other weights than the reference's `jax.random`.

    With `mesh`, every leaf is a DTensor laid out by its partition spec
    (axes the mesh lacks dropped, as `sharding.place` lays it out) whose
    shard this rank builds alone: every rank makes the same draws as
    without a mesh and keeps its shard of each, so the shards are the
    slices of the unmeshed init and no rank holds a whole leaf (a bf16
    leaf is drawn one chunk of at most _INIT_CHUNK elements, or one slab,
    at a time)."""
    flat = sorted(flatten(defs).items())
    if mesh is None:
        return unflatten({path: _init_leaf(generator, d, param_dtype, device)
                          for path, d in flat})
    return unflatten({path: made_on_mesh(
        lambda box, d=d: _init_leaf(generator, d, param_dtype, device, box),
        d.shape, d.partition, mesh) for path, d in flat})


def abstract_params(defs: dict, param_dtype: str, device="meta") -> dict:
    """The parameter tree as tensors with no values: meta tensors, or fake
    ones when called under a `FakeTensorMode` with device "cpu" (the dry
    run's stand-in for the reference's ShapeDtypeStructs)."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=dtype_of(
        d.dtype or param_dtype), device=device), defs)


def param_specs(defs: dict) -> dict:
    """The partition-spec tree matching the parameter tree."""
    return tree_map(lambda d: d.partition, defs)


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
    return tree_map(lambda d: replace(d, shape=(n,) + d.shape,
                                      spec=P(None, *d.partition)), defs)


def layer(tree: dict, *idx) -> dict:
    """The slice of a stacked parameter tree at layer index `idx` (views)."""
    return tree_map(lambda a: a[idx], tree)


# leaves (and subtrees) the forward reads in f32, never in the compute type
_NOT_CAST = ("a_log", "dt_bias", "gate_norm", "router")
_NORMS = ("ln", "ln1", "ln2", "ln_f", "ln_x", "enc_ln", "dec_ln", "q_norm",
          "k_norm", "kv_norm", "post_attn", "post_mlp")


def cast_for_compute(cfg: ArchConfig, params: dict) -> dict:
    """The parameter tree with every weight that the forward casts to
    `cfg.compute_dtype` before use (matrices, convolutions, embedding,
    skip gains, biases) cast once; norm weights, the SSM's decay and step
    parameters and the MoE router, which the forward reads in f32, stay
    as they are."""
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


# --------------------------------------------------------------------------
# activation checkpointing
# --------------------------------------------------------------------------

# the matrix products a "dots" policy keeps (the reference's
# checkpoint_dots): x @ w and einsum lower to these
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_policy(cfg: ArchConfig):
    """The `context_fn` of `torch.utils.checkpoint.checkpoint` for
    `cfg.remat_policy`: "dots" keeps the matrix products' outputs and
    recomputes the rest; any other policy keeps nothing (the reference's
    `nothing_saveable`)."""
    if cfg.remat_policy == "dots":
        return functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
    return noop_context_fn


_REMAT = threading.local()


def _in_checkpointed_layer() -> bool:
    return getattr(_REMAT, "depth", 0) > 0


def checkpointed(cfg: ArchConfig, fn: Callable) -> Callable:
    """`fn` under activation checkpointing when `cfg.remat` is set and grad
    mode is on (backward recomputes it from its inputs); `fn` itself
    otherwise.  Recomputing gives the same bits.  Inside such a layer the
    blockwise attention does not checkpoint its blocks again: the layer's
    recompute already runs them once more, as XLA merges the reference's
    nested recomputes into one.  The recompute runs under the mesh the
    forward ran under (`ctx.use_mesh`): on the card autograd runs the
    backward in a thread of its own, where no mesh is installed, and a
    recompute without the forward's `constrain`s would save other
    tensors."""
    if not cfg.remat:
        return fn
    context_fn = remat_policy(cfg)

    def marked(mesh, *args):
        _REMAT.depth = getattr(_REMAT, "depth", 0) + 1
        try:
            with use_mesh(mesh):
                return fn(*args)
        finally:
            _REMAT.depth -= 1

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(marked, current_mesh(), *args, use_reentrant=False,
                          context_fn=context_fn)
    return run


def norm_defs(cfg: ArchConfig, kind: str | None = None) -> dict:
    kind = kind or getattr(cfg, "norm", "rms")
    if cfg.family == "encdec" or kind == "layer":
        return {"w": ParamDef((cfg.d_model,), "ones"),
                "b": ParamDef((cfg.d_model,), "zeros")}
    init = "zeros" if _gemma_like(cfg) else "ones"   # gemma stores w-1
    return {"w": ParamDef((cfg.d_model,), init)}


def residual_spec(cfg: ArchConfig) -> P:
    """Layer-boundary sharding of the [B,S,D] residual stream."""
    if cfg.seq_shard_residual:
        return P(BATCH, "model", None)
    return P(BATCH, None, None)


def apply_norm(cfg: ArchConfig, p: dict, x):
    if "b" in p:
        return layer_norm(x, p["w"], p["b"], cfg.norm_eps)
    return rms_norm(x, p["w"], cfg.norm_eps, plus_one=_gemma_like(cfg))


# --------------------------------------------------------------------------
# rotary position embeddings
# --------------------------------------------------------------------------

def rope_freqs(dim: int, theta: float) -> torch.Tensor:
    """The frequencies theta ** (-arange(0, dim, 2) / dim), f32[dim // 2],
    made on the host: the exponent in f32 and theta in f32, as the
    reference computes them, the power taken in f64 and rounded once to
    f32.  That is the correctly rounded f32 power, which XLA gives; torch's
    f32 `pow` is not correctly rounded (one ulp off at 4 of qwen2's 64
    frequencies), and the angles position * freq carry that error up with
    the position.  The same bits whatever device the angles are made on."""
    ex = -torch.arange(0, dim, 2, dtype=F32) / dim
    base = torch.tensor(theta, dtype=F32).to(torch.float64)
    return (base ** ex.to(torch.float64)).to(F32)


def rope_table(positions, dim: int, theta: float):
    """The angles f32[..., dim//2] of int positions[...]: the f32 product
    of each position with `rope_freqs`, as the reference computes it."""
    return positions.to(F32)[..., None] * rope_freqs(dim, theta).to(
        positions.device)


def rope_angles(positions, dim: int, theta: float):
    """positions int[...]; returns (cos, sin) f32[..., dim//2] of
    `rope_table`."""
    ang = rope_table(positions, dim, theta)
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


def _model_divisible(n_heads: int) -> bool:
    """Heads shard over `model` only when they divide its 16 ways."""
    return n_heads % 16 == 0


def head_spec(n_heads: int) -> P:
    return P(None, "model", None) if _model_divisible(n_heads) \
        else P(None, None, None)


def attn_defs(cfg: ArchConfig, d_model: int | None = None) -> dict:
    d = d_model or cfg.d_model
    hd, h, kv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    defs = {"wq": ParamDef((d, h, hd), spec=head_spec(h)),
            "wk": ParamDef((d, kv, hd), spec=head_spec(kv)),
            "wv": ParamDef((d, kv, hd), spec=head_spec(kv)),
            "wo": ParamDef((h, hd, d), spec=P("model", None, None)
                           if _model_divisible(h) else None)}
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((h, hd), "zeros")
        defs["bk"] = ParamDef((kv, hd), "zeros")
        defs["bv"] = ParamDef((kv, hd), "zeros")
    if cfg.qk_norm:
        init = "zeros" if _gemma_like(cfg) else "ones"
        defs["q_norm"] = ParamDef((hd,), init)
        defs["k_norm"] = ParamDef((hd,), init)
    return defs


def _rows_matmul(x, w):
    """x [..., D] @ w [D, N].  A DTensor x whose rows are split on two
    dimensions (batch and sequence) takes a batched product with w
    broadcast over the batch: merging the two split dimensions into one
    has no sharding rule."""
    if _is_dtensor(x) and x.dim() == 3 and any(
            getattr(p, "dim", None) == 1 for p in x.placements):
        return torch.bmm(x, w.expand(x.shape[0], *w.shape))
    return x @ w


def _proj_heads(x, w):
    """einsum("bsd,dhk->bshk") as one matrix product."""
    d, h, k = w.shape
    return _rows_matmul(x, w.reshape(d, h * k)).reshape(*x.shape[:-1], h, k)


def _merge_heads(out, wo):
    """einsum("bshk,hkd->bsd") as one matrix product."""
    h, k, d = wo.shape
    return _rows_matmul(out.reshape(*out.shape[:-2], h * k),
                        wo.reshape(h * k, d))


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


def _is_dtensor(x) -> bool:
    return type(x).__name__ == "DTensor"


def _sdpa_on_shards(q, k, v, mask, scale: float, softcap: float):
    """`sdpa` of DTensors, run on each rank's shards
    (`ctx.attention_layout`: q's batch, row and head splits kept, k and v
    whole along the keys); the mask is cut to the rank's rows.  The result
    is laid out as q."""
    mesh, qp, kvp = attention_layout(q, k, rows=True)
    q = to_layout(q, mesh, qp)
    used = split_dims(qp, kvp)
    ql = local_of(q, used)
    if mask.dim() >= 2 and mask.shape[-2] != 1:
        off = shard_offset(q, 1)
        mask = mask[..., off:off + ql.shape[1], :]
    out = sdpa(ql, local_of(to_layout(k, mesh, kvp), used),
               local_of(to_layout(v, mesh, kvp), used), mask, scale, softcap)
    return from_local(out, mesh, qp, (*q.shape[:3], v.shape[-1]))


def sdpa(q, k, v, mask, scale: float, softcap: float = 0.0):
    """q:[B,Sq,H,D] k/v:[B,Sk,KV,D]; GQA broadcast; f32 softmax.  On
    DTensors it runs on each rank's shards (`_sdpa_on_shards`)."""
    if _is_dtensor(q):
        return _sdpa_on_shards(q, k, v, mask, scale, softcap)
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
                   block: int, window: int = 0, q_offset: int = 0,
                   causal: bool = True, row_shard: bool = False):
    """`sdpa` over query blocks of `block` rows (causal + optional sliding
    window; `causal=False`: every key, as whisper's encoder and
    cross-attention take), so the scores are [B, H, block, Sk] at a time;
    the reference falls back to one block when `block` does not divide Sq,
    and so does this.  Under grad mode each block is checkpointed, as the
    reference's scan body is: backward recomputes a block's scores rather
    than keeping every block's [B, H, block, Sk] softmax (inside a
    checkpointed layer, whose recompute runs the blocks once more, they are
    not checkpointed again: `checkpointed`).  row_shard: a
    block's query rows (and its output rows) split over `model`, as the
    reference constrains them for heads that do not divide it."""
    sq, sk = q.shape[1], k.shape[1]
    blk = max(min(block, sq), 1)
    if sq % blk:
        blk = sq
    grad = torch.is_grad_enabled() and not _in_checkpointed_layer()
    outs = []
    for q0 in range(0, sq, blk):
        m = (causal_mask(blk, sk, q0 + q_offset, window, device=q.device)
             if causal else torch.ones((blk, sk), dtype=torch.bool,
                                       device=q.device))
        qblk = q[:, q0:q0 + blk]
        if row_shard:
            qblk = constrain(qblk, P(BATCH, "model", None, None))
        args = (qblk, k, v, m, scale, softcap)
        out = (checkpoint(sdpa, *args, use_reentrant=False) if grad
               else sdpa(*args))
        if row_shard:
            out = constrain(out, P(BATCH, "model", None, None))
        outs.append(out)
    return torch.cat(outs, dim=1)


def attention(cfg: ArchConfig, p: dict, x, positions, *, window: int = 0,
              theta: float | None = None, scale: float | None = None,
              use_kernels: bool = True):
    """Full (prefill) self-attention with causal (+window) mask.  Without
    softcap and window it is `ops.flash_attention` (the kernel on the card);
    otherwise, and always with `use_kernels=False` (the reference's
    `attn_impl="xla"`, the path its training takes), the blockwise or
    whole-matrix softmax of the reference."""
    theta = cfg.rope_theta if theta is None else theta
    scale = (1.0 / math.sqrt(cfg.hd)) if scale is None else scale
    flash = use_kernels and not cfg.attn_softcap and not window
    row_shard = (not flash and bool(cfg.attn_block)
                 and not _model_divisible(cfg.n_heads))
    with telemetry.stage_scope("attention", x.device):
        if row_shard:
            # heads stay whole on every rank, so the rows split over
            # `model`: the projections of the reference's row-sharded
            # blocks run on the rank's rows (its layout under GSPMD)
            x = constrain(x, P(BATCH, "model", None))
        q, k, v = _qk_project(cfg, p, x, positions, theta)
        k = constrain(k, P(BATCH, None, None, None))
        if flash:
            out = ops.flash_attention(q, k, v, scale=scale, causal=True)
        elif cfg.attn_block:
            out = sdpa_blockwise(q, k, v, scale, cfg.attn_softcap,
                                 block=cfg.attn_block, window=window,
                                 row_shard=row_shard)
        else:
            mask = causal_mask(x.shape[1], x.shape[1], 0, window,
                               device=x.device)
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
                            window: int, use_kernels: bool = True):
    """Attention of a dense layer whose window is `layer_window`'s (the
    reference traces it; here it is a host integer, so `attention`'s
    dispatch applies: flash for a global layer without softcap, unless
    `use_kernels` is False)."""
    return attention(cfg, p, x, positions, window=window,
                     use_kernels=use_kernels)


def cache_update(cache, new, pos: int):
    """Write `new` [B,T,...] into `cache` [B,S,...] at positions pos.. in
    place; returns `cache`.  A DTensor cache (on a mesh, its positions
    perhaps split over `model`) is written by each rank into the positions
    its shard holds, from `new` laid out as the cache but whole along the
    positions: no collective beyond that layout."""
    if _is_dtensor(cache):
        from torch.distributed.tensor import Replicate, Shard
        mesh = cache.device_mesh
        pl = [Replicate() if p == Shard(1) else p for p in cache.placements]
        new = to_layout(new.to(cache.dtype), mesh, pl).to_local()
        local = cache.to_local()
        off = shard_offset(cache, 1)
        lo, hi = max(pos, off), min(pos + new.shape[1], off + local.shape[1])
        if lo < hi:
            local[:, lo - off:hi - off] = new[:, lo - pos:hi - pos]
        return cache
    cache[:, pos:pos + new.shape[1]] = new.to(cache.dtype)
    return cache


def attention_decode(cfg: ArchConfig, p: dict, x, cache_k, cache_v,
                     pos: int, *, window: int = 0,
                     theta: float | None = None, scale: float | None = None,
                     cache_spec: P | None = None):
    """One-token decode against a KV cache.

    x: [B,1,D]; cache_k/v: [B,S,KV,hd], written in place at `pos` (a host
    integer: the batch decodes in step).  Returns (out, cache_k, cache_v).
    """
    theta = cfg.rope_theta if theta is None else theta
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q, k, v = _qk_project(cfg, p, x, posv, theta)
    cache_k = cache_update(cache_k, k, pos)
    cache_v = cache_update(cache_v, v, pos)
    if cache_spec is not None:
        cache_k = constrain(cache_k, cache_spec)
        cache_v = constrain(cache_v, cache_spec)
    scale = (1.0 / math.sqrt(cfg.hd)) if scale is None else scale

    def attend(qs, kvs, start):
        # over the keys at positions start .. start + k.shape[1]
        (q,), (k, v) = qs, kvs
        b, _, h, d = q.shape
        kvh = k.shape[2]
        ki = torch.arange(start, start + k.shape[1], device=q.device)
        mask = ki <= pos
        if window:
            mask &= ki > pos - window
        qg = q.reshape(b, kvh, h // kvh, d)
        logits = torch.einsum("bhgd,bkhd->bhgk", qg, k).to(F32) * scale
        logits = _softcap(logits, cfg.attn_softcap)
        logits = torch.where(mask, logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(q.dtype)
        out = torch.einsum("bhgk,bkhd->bhgd", probs, v)
        return (out.reshape(b, 1, h, v.shape[-1]),
                logits.reshape(b, 1, h, k.shape[1]))
    # on a mesh the cache stays split over its positions (`on_key_shards`)
    out = on_key_shards(attend, (q,), (cache_k, cache_v))
    return _merge_heads(out, _c(p["wo"], out.dtype)), cache_k, cache_v


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

_ACTS: dict[str, Callable] = {
    "silu": F.silu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
}


def ffn_defs(cfg: ArchConfig, d_ff: int, fsdp: bool = False) -> dict:
    d = cfg.d_model
    dspec = "data" if fsdp else None
    if cfg.act == "gelu_mlp":   # plain 2-matrix MLP (whisper)
        return {"w_in": ParamDef((d, d_ff), spec=P(dspec, "model")),
                "b_in": ParamDef((d_ff,), "zeros", spec=P("model")),
                "w_out": ParamDef((d_ff, d), spec=P("model", dspec)),
                "b_out": ParamDef((d,), "zeros")}
    return {"w_gate": ParamDef((d, d_ff), spec=P(dspec, "model")),
            "w_up": ParamDef((d, d_ff), spec=P(dspec, "model")),
            "w_down": ParamDef((d_ff, d), spec=P("model", dspec))}


def ffn(cfg: ArchConfig, p: dict, x):
    cdt = dtype_of(cfg.compute_dtype)
    if "w_in" in p:
        h = x @ _c(p["w_in"], cdt) + _c(p["b_in"], cdt)
        h = F.gelu(h, approximate="tanh")
        return h @ _c(p["w_out"], cdt) + _c(p["b_out"], cdt)
    act = _ACTS[cfg.act]
    # on a mesh an FSDP split of the weights over `data` is gathered first
    cols, rows = P(None, "model"), P("model", None)
    h = (act(x @ constrain(_c(p["w_gate"], cdt), cols))
         * (x @ constrain(_c(p["w_up"], cdt), cols)))
    h = constrain(h, P(BATCH, None, "model"))
    return h @ constrain(_c(p["w_down"], cdt), rows)


# --------------------------------------------------------------------------
# embedding / logits / loss
# --------------------------------------------------------------------------

def embed_defs(cfg: ArchConfig, fsdp: bool = False) -> dict:
    """The token table (vocab over `model`) and, untied, the unembedding
    (vocab over `model`; under FSDP the model width over `data` too)."""
    spec = P("model", "data") if fsdp else P("model", None)
    unembed_spec = P("data", "model") if fsdp else P(None, "model")
    vp = cfg.padded_vocab    # odd vocabs padded to a multiple of 256
    defs = {"tok": ParamDef((vp, cfg.d_model), "embed", scale=0.02,
                            spec=spec)}
    if not cfg.tie_embeddings:
        defs["unembed"] = ParamDef((cfg.d_model, vp), spec=unembed_spec)
    return defs


def _gather_rows(table, tokens):
    """table[tokens].  A DTensor table (its rows split over `model`) is
    gathered on each rank's shards: a rank looks up the tokens whose rows
    it holds and writes zeros for the rest, and the result is a partial
    sum over the rows' mesh axes (one nonzero term a token: the sum is
    exact), laid out by the tokens' batch split."""
    if not _is_dtensor(table):
        return table[tokens]
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = table.device_mesh
    rows = [i for i, p in enumerate(table.placements) if p == Shard(0)]
    table = table.redistribute(mesh, [Shard(0) if i in rows else Replicate()
                                      for i in range(mesh.ndim)])
    tpl = [Replicate() if i in rows else p for i, p in enumerate(
        tokens.placements if _is_dtensor(tokens)
        else [Replicate()] * mesh.ndim)]
    tpl = [p if p in (Shard(0), Replicate()) else Replicate() for p in tpl]
    tok = to_layout(tokens, mesh, tpl).to_local()
    local = local_of(table, split_dims(tpl, table.placements))
    idx = tok.long() - shard_offset(table, 0)
    held = (idx >= 0) & (idx < local.shape[0])
    out = local[idx.clamp(0, local.shape[0] - 1)] * held[..., None].to(
        local.dtype)
    pl = [Partial() if i in rows else tpl[i] for i in range(mesh.ndim)]
    return from_local(out, mesh, pl, (*tokens.shape, table.shape[1]))


def embed(cfg: ArchConfig, p: dict, tokens):
    """Rows of the table in the compute type (the cast commutes with the
    gather, so only the gathered rows are cast)."""
    cdt = dtype_of(cfg.compute_dtype)
    x = _c(_gather_rows(p["tok"], tokens), cdt)
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


def cross_entropy(logits, labels, mask=None):
    """logits f32[B,S,V], labels int[B,S]; mean NLL over unmasked tokens
    (`mask` [B,S], nonzero = counted).

    The gold logit is picked with `gather`.  The reference sums the logits
    under a compare with the vocab ids (a gather over a vocab-sharded
    tensor would all-gather it), which adds only zeros to the gold logit:
    the same bits, without a [B, S, V] f32 temporary (5 GB at qwen2-1.5b's
    2 x 4096 positions and 151,936 ids).  Sharded logits (DTensors) take
    the reference's form.  The unmasked mean is the sum
    times the f32 reciprocal of the count, as the jitted reference computes
    `jnp.mean`.
    """
    logz = torch.logsumexp(logits, dim=-1)
    if _is_dtensor(logits):
        # vocab-sharded logits: the reference's compare-and-reduce keeps
        # every operand sharded (a gather would collect the logits)
        ids = torch.arange(logits.shape[-1], device=labels.device)
        gold = torch.where(labels.long()[..., None] == ids, logits,
                           0.0).sum(-1)
    else:
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.sum() * inv_f32(nll.numel())
    m = mask.to(F32)
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
