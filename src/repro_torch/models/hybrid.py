"""zamba2-7b: Mamba-2 backbone with a weight-SHARED attention+MLP block
(the port of the reference's `models/hybrid.py`).

One transformer block, its parameters reused at every site, sits between
groups of Mamba-2 layers behind small per-site linear adapters.  The
81-layer backbone is 13 groups of 6 mamba layers, each followed by the
shared block (13 sites), plus 3 trailing mamba layers.  At decode each site
keeps its own KV cache; all sites use the same weights.

Structure per group g:  x -> [mamba x 6] -> x + SharedAttnBlock(adapter_g(x))
"""
from __future__ import annotations

import torch

from ..distributed.ctx import P, constrain
from . import layers as L
from .config import ArchConfig
from .ssm import (mamba_layer_decode, mamba_stack, ssm_block_defs,
                  ssm_state_shape, ssm_state_spec)

BATCH = L.BATCH


def _split(cfg: ArchConfig) -> tuple[int, int, int]:
    """(n_groups, per_group, trailing) mamba-layer layout."""
    per = cfg.attn_every
    n_groups = cfg.n_layers // per
    return n_groups, per, cfg.n_layers - n_groups * per


def hybrid_model_defs(cfg: ArchConfig) -> dict:
    n_groups, per, trailing = _split(cfg)
    mamba_layer = {"ln": L.norm_defs(cfg), "mix": ssm_block_defs(cfg)}
    defs = {
        "embed": L.embed_defs(cfg),
        "groups": L.stack_defs(L.stack_defs(mamba_layer, per), n_groups),
        "adapters": L.stack_defs(
            {"w": L.ParamDef((cfg.d_model, cfg.d_model), scale=0.1,
                             spec=P(None, "model"))}, n_groups),
        "shared": {"ln1": L.norm_defs(cfg), "attn": L.attn_defs(cfg),
                   "ln2": L.norm_defs(cfg),
                   "mlp": L.ffn_defs(cfg, cfg.d_ff)},
        "ln_f": L.norm_defs(cfg),
    }
    if trailing:
        defs["trailing"] = L.stack_defs(mamba_layer, trailing)
    return defs


def _shared_block(cfg: ArchConfig, sp: dict, ap: dict, x, positions,
                  use_kernels: bool = True):
    h = x @ L._c(ap["w"], x.dtype)
    h = L.apply_norm(cfg, sp["ln1"], h)
    x = x + L.attention(cfg, sp["attn"], h, positions,
                        use_kernels=use_kernels)
    return constrain(x + L.ffn(cfg, sp["mlp"], L.apply_norm(cfg, sp["ln2"],
                                                            x)),
                     L.residual_spec(cfg))


def hybrid_logits(cfg: ArchConfig, params: dict, tokens,
                  last_only: bool = False, use_kernels: bool = True):
    """Mamba layers checkpointed one by one under `cfg.remat`, the shared
    block not, as in the reference.  use_kernels=False: no SSD or flash
    kernel (the training path)."""
    n_groups, per, trailing = _split(cfg)
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    for g in range(n_groups):
        x = mamba_stack(cfg, L.layer(params["groups"], g), x, per,
                        use_kernels)
        x = _shared_block(cfg, params["shared"],
                          L.layer(params["adapters"], g), x, positions,
                          use_kernels)
    if trailing:
        x = mamba_stack(cfg, params["trailing"], x, trailing, use_kernels)
    x = L.apply_norm(cfg, params["ln_f"], x)
    if last_only:
        x = x[:, -1:]
    return L.logits_out(cfg, params["embed"], x)


def hybrid_loss(cfg: ArchConfig, params: dict, batch: dict):
    """Mean next-token cross-entropy on the plain path (the reference's
    `use_pallas=False`; its shared attention is the blockwise softmax)."""
    logits = hybrid_logits(cfg, params, batch["tokens"], use_kernels=False)
    return L.cross_entropy(logits, batch["labels"], batch.get("mask"))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def hybrid_state_shape(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Mamba recurrent state per layer (groups' layers first, then the
    trailing ones) + one KV cache per shared-attention site."""
    n_groups, _, _ = _split(cfg)
    st = ssm_state_shape(cfg, batch, seq)
    kv = L.TensorSpec((n_groups, batch, seq, cfg.n_kv_heads, cfg.hd),
                      L.dtype_of(cfg.compute_dtype))
    st["shared_k"] = kv
    st["shared_v"] = kv
    return st


def hybrid_state_spec(cfg: ArchConfig) -> dict:
    spec = ssm_state_spec(cfg)
    spec["shared_k"] = P(None, BATCH, "model", None, None)
    spec["shared_v"] = P(None, BATCH, "model", None, None)
    return spec


def hybrid_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens,
                       pos: int):
    """One token per row at position `pos` (a host integer): (logits
    [B,1,V], cache), every cache leaf written in place."""
    n_groups, per, trailing = _split(cfg)
    sp = params["shared"]
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))
    for g in range(n_groups):
        for j in range(per):
            x = mamba_layer_decode(cfg, L.layer(params["groups"], g, j), x,
                                   cache, g * per + j)
        h = x @ L._c(params["adapters"]["w"][g], x.dtype)
        h = L.apply_norm(cfg, sp["ln1"], h)
        h, _, _ = L.attention_decode(cfg, sp["attn"], h, cache["shared_k"][g],
                                     cache["shared_v"][g], pos,
                                     cache_spec=P(BATCH, "model", None, None))
        x = x + h
        x = x + L.ffn(cfg, sp["mlp"], L.apply_norm(cfg, sp["ln2"], x))
    for j in range(trailing):
        x = mamba_layer_decode(cfg, L.layer(params["trailing"], j), x, cache,
                               n_groups * per + j)
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.logits_out(cfg, params["embed"], x), cache
