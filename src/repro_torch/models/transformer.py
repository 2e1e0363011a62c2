"""Dense decoder-only transformer: qwen2, stablelm, gemma2, gemma3, and the
text backbone of paligemma (the port of the reference's
`models/transformer.py`).

The reference scans one layer body over stacked weights with the window
size a traced per-layer value.  The port runs on one device, eagerly: a
Python loop over the layers (the scan's unrolled form), each layer's
window a host integer (`layers.layer_window`), each layer checkpointed
under `cfg.remat` as the reference's scan body is.  For serving,
attention of a global layer with no softcap goes through
`ops.flash_attention` (the kernel on the card); a local layer, or any
layer of a softcapped model (gemma2), takes the blockwise softmax of the
reference.  `dense_loss` takes the blockwise softmax on every layer
(`use_kernels=False`), as the reference's layers always do.

The paligemma ("vlm") variant prepends `n_frontend_tokens` precomputed
SigLIP patch embeddings: a learned projection from `frontend_dim` to
`d_model` (scaled by sqrt(d_model) like gemma's token embeddings); the
vision tower itself is not simulated.
"""
from __future__ import annotations

import math

import torch

from ..distributed.ctx import P, constrain
from . import layers as L
from .config import ArchConfig

BATCH = L.BATCH


def dense_defs(cfg: ArchConfig, fsdp: bool = False) -> dict:
    layer = {
        "ln1": L.norm_defs(cfg),
        "attn": L.attn_defs(cfg),
        "ln2": L.norm_defs(cfg),
        "mlp": L.ffn_defs(cfg, cfg.d_ff, fsdp),
    }
    if cfg.post_norm:  # gemma2 / gemma3: extra norms after attn and ffn
        layer["post_attn"] = L.norm_defs(cfg)
        layer["post_mlp"] = L.norm_defs(cfg)
    defs = {
        "embed": L.embed_defs(cfg, fsdp),
        "layers": L.stack_defs(layer, cfg.n_layers),
        "ln_f": L.norm_defs(cfg),
    }
    if cfg.family == "vlm":
        defs["vision_proj"] = L.ParamDef((cfg.frontend_dim, cfg.d_model),
                                         spec=P(None, "model"))
    return defs


def _mlp_half(cfg: ArchConfig, lp: dict, x, h):
    """x + the attention output `h` (post-normed), then the FFN half."""
    if "post_attn" in lp:
        h = L.apply_norm(cfg, lp["post_attn"], h)
    x = x + h
    h = L.ffn(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))
    if "post_mlp" in lp:
        h = L.apply_norm(cfg, lp["post_mlp"], h)
    return x + h


def _layer_fn(cfg: ArchConfig, use_kernels: bool):
    def fn(x, lp, positions, window):
        h = L.attention_traced_window(
            cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x), positions,
            window, use_kernels)
        return constrain(_mlp_half(cfg, lp, x, h), L.residual_spec(cfg))
    return L.checkpointed(cfg, fn)


def dense_logits(cfg: ArchConfig, params: dict, tokens, extra_embeds=None,
                 last_only: bool = False, use_kernels: bool = True):
    """tokens int[B,S] -> logits f32[B,S,V] (last_only: [B,1,V], the
    prefill's).  extra_embeds (vlm): [B,P,D_f] frontend embeddings
    prepended to the token sequence; their positions are dropped from the
    full logits.  use_kernels=False: attention without the flash kernel
    (the training path)."""
    x = L.embed(cfg, params["embed"], tokens)
    if extra_embeds is not None:
        proj = extra_embeds.to(x.dtype) @ L._c(params["vision_proj"], x.dtype)
        if L._gemma_like(cfg):
            proj = proj * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype,
                                       device=x.device)
        x = torch.cat([proj, x], dim=1)
    x = constrain(x, P(BATCH, None, None))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    fn = _layer_fn(cfg, use_kernels)
    for i in range(cfg.n_layers):
        x = fn(x, L.layer(params["layers"], i), positions,
               L.layer_window(cfg, i))
    x = L.apply_norm(cfg, params["ln_f"], x)
    if last_only:
        return L.logits_out(cfg, params["embed"], x[:, -1:])
    logits = L.logits_out(cfg, params["embed"], x)
    if extra_embeds is not None:
        logits = logits[:, extra_embeds.shape[1]:]
    return logits


def dense_loss(cfg: ArchConfig, params: dict, batch: dict):
    """Mean next-token cross-entropy of the text positions (a vlm's labels
    cover its tokens only: `dense_logits` drops the patch positions)."""
    logits = dense_logits(cfg, params, batch["tokens"],
                          batch.get("patch_embeds"), use_kernels=False)
    return L.cross_entropy(logits, batch["labels"], batch.get("mask"))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def dense_cache_shape(cfg: ArchConfig, batch: int, seq: int) -> dict:
    kv = L.TensorSpec((cfg.n_layers, batch, seq, cfg.n_kv_heads, cfg.hd),
                      L.dtype_of(cfg.compute_dtype))
    return {"k": kv, "v": kv}


def dense_cache_spec(cfg: ArchConfig) -> dict:
    """The cache's sequence axis over `model` (long contexts at batch 1; a
    sequence-parallel decode attention)."""
    spec = P(None, BATCH, "model", None, None)
    return {"k": spec, "v": spec}


def dense_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens,
                      pos: int):
    """tokens int[B,1] at position `pos` (a host integer) -> (logits
    f32[B,1,V], cache), the cache written in place."""
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))
    kv_spec = P(BATCH, "model", None, None)
    for i in range(cfg.n_layers):
        lp = L.layer(params["layers"], i)
        h, _, _ = L.attention_decode(
            cfg, lp["attn"], L.apply_norm(cfg, lp["ln1"], x), cache["k"][i],
            cache["v"][i], pos, window=L.layer_window(cfg, i),
            cache_spec=kv_spec)
        x = _mlp_half(cfg, lp, x, h)
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.logits_out(cfg, params["embed"], x), cache
