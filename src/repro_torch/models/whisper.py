"""whisper-base: encoder-decoder transformer (the port of the reference's
`models/whisper.py`).

The conv / mel frontend is a stub, as in the reference: the batch carries
precomputed frame embeddings "frames" [B, enc_seq, d_model].  The rest is
the architecture: sinusoidal encoder positions, multi-head attention with
q / v / out biases, pre-LayerNorm blocks, plain GELU MLPs, learned decoder
positions, cross-attention into the encoder output, and the output head
tied to the input embedding.

On the serving path every attention goes through `ops.flash_attention`
(the kernel on the card): the encoder's self-attention (non-causal), the
decoder's (causal) and its cross-attention (non-causal, Sq the decoder's
length, Sk the encoder's), 3 x n_layers launches a prefill at whisper's
equal depths.  The loss takes the reference's blockwise softmax
(`use_kernels=False`).

Decode keeps a self-attention KV cache a layer and reads the cross-attention
K / V from the cache ("cross_k" / "cross_v" [L, B, enc_seq, H, hd]); like
the reference's, `whisper_decode_step` does not fill them: its caller
projects the encoder output with each layer's cross-attention weights
(`_project`).
"""
from __future__ import annotations

import math

import torch

from ..core import telemetry
from ..distributed.ctx import P, constrain
from ..kernels import ops
from . import layers as L
from .config import ArchConfig

F32 = torch.float32
BATCH = L.BATCH


def _sinusoid(seq: int, d: int, device=None):
    pos = torch.arange(seq, dtype=F32, device=device)[:, None]
    inv = torch.exp(-torch.arange(0, d, 2, dtype=F32, device=device)
                    * (math.log(10000.0) / (d // 2 - 1)))
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _attn_defs(cfg: ArchConfig) -> dict:
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.hd
    spec = L.head_spec(h)
    ospec = P("model", None, None) if h % 16 == 0 else None
    return {"wq": L.ParamDef((d, h, hd), spec=spec),
            "wk": L.ParamDef((d, h, hd), spec=spec),
            "wv": L.ParamDef((d, h, hd), spec=spec),
            "bq": L.ParamDef((h, hd), "zeros"),
            "bv": L.ParamDef((h, hd), "zeros"),
            "wo": L.ParamDef((h, hd, d), spec=ospec),
            "bo": L.ParamDef((d,), "zeros")}


def _project(p, x, cdt, which: str):
    out = L._proj_heads(x, L._c(p["w" + which], cdt))
    if "b" + which in p:
        out = out + L._c(p["b" + which], cdt)
    return out


def _out(p, out, cdt):
    """einsum("bshk,hkd->bsd", out, wo) + bo."""
    return L._merge_heads(out, L._c(p["wo"], cdt)) + L._c(p["bo"], cdt)


def _mha(cfg: ArchConfig, p: dict, xq, xkv, causal: bool,
         use_kernels: bool = True):
    """No RoPE: whisper adds absolute positions at the embeddings.  Flash
    attention (the kernel on the card); with use_kernels=False the
    reference's blockwise or whole-matrix softmax."""
    cdt = L.dtype_of(cfg.compute_dtype)
    with telemetry.stage_scope("attention", xq.device):
        q = _project(p, xq, cdt, "q")
        k = _project(p, xkv, cdt, "k")
        v = _project(p, xkv, cdt, "v")
        scale = 1.0 / math.sqrt(cfg.hd)
        if use_kernels:
            out = ops.flash_attention(q, k, v, scale=scale, causal=causal)
        elif cfg.attn_block:
            out = L.sdpa_blockwise(
                q, k, v, scale, block=cfg.attn_block, causal=causal,
                row_shard=not L._model_divisible(cfg.n_heads))
        else:
            sq, sk = xq.shape[1], xkv.shape[1]
            mask = (L.causal_mask(sq, sk, device=xq.device) if causal else
                    torch.ones((sq, sk), dtype=torch.bool, device=xq.device))
            out = L.sdpa(q, k, v, mask, scale)
        return _out(p, out, cdt)


def _mha_decode(cfg: ArchConfig, p: dict, x, ck, cv, pos: int):
    cdt = L.dtype_of(cfg.compute_dtype)
    q = _project(p, x, cdt, "q")
    k = _project(p, x, cdt, "k")
    v = _project(p, x, cdt, "v")
    ck = constrain(L.cache_update(ck, k, pos), P(BATCH, "model", None, None))
    cv = constrain(L.cache_update(cv, v, pos), P(BATCH, "model", None, None))
    mask = (torch.arange(ck.shape[1], device=x.device) <= pos)[None, :]
    out = L.sdpa(q, ck, cv, mask, 1.0 / math.sqrt(cfg.hd))
    return _out(p, out, cdt), ck, cv


def whisper_model_defs(cfg: ArchConfig) -> dict:
    enc_layer = {"ln1": L.norm_defs(cfg, "layer"), "attn": _attn_defs(cfg),
                 "ln2": L.norm_defs(cfg, "layer"),
                 "mlp": L.ffn_defs(cfg, cfg.d_ff)}
    dec_layer = {"ln1": L.norm_defs(cfg, "layer"), "self_attn": _attn_defs(cfg),
                 "ln_x": L.norm_defs(cfg, "layer"), "cross_attn": _attn_defs(cfg),
                 "ln2": L.norm_defs(cfg, "layer"),
                 "mlp": L.ffn_defs(cfg, cfg.d_ff)}
    return {
        "embed": L.embed_defs(cfg),
        "dec_pos": L.ParamDef((4096, cfg.d_model), "embed", scale=0.02),
        "enc_layers": L.stack_defs(enc_layer, cfg.n_enc_layers),
        "enc_ln": L.norm_defs(cfg, "layer"),
        "dec_layers": L.stack_defs(dec_layer, cfg.n_layers),
        "dec_ln": L.norm_defs(cfg, "layer"),
    }


def encode(cfg: ArchConfig, params: dict, frames, use_kernels: bool = True):
    """frames: [B, enc_seq, D] stub embeddings -> encoder states."""
    cdt = L.dtype_of(cfg.compute_dtype)
    x = frames.to(cdt) + _sinusoid(frames.shape[1], cfg.d_model,
                                   frames.device).to(cdt)
    x = constrain(x, P(BATCH, None, None))
    for i in range(cfg.n_enc_layers):
        lp = L.layer(params["enc_layers"], i)
        h = L.apply_norm(cfg, lp["ln1"], x)
        x = x + _mha(cfg, lp["attn"], h, h, False, use_kernels)
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = constrain(x + L.ffn(cfg, lp["mlp"], h), P(BATCH, None, None))
    return L.apply_norm(cfg, params["enc_ln"], x)


def _dec_positions(params, start: int, seq: int, cdt):
    return L._c(params["dec_pos"][start:start + seq], cdt)


def decode_train(cfg: ArchConfig, params: dict, tokens, enc,
                 last_only: bool = False, use_kernels: bool = True):
    """Teacher-forced decoder over the encoder states `enc` -> logits
    f32[B,S,V] (last_only: [B,1,V], the prefill's)."""
    cdt = L.dtype_of(cfg.compute_dtype)
    s = tokens.shape[1]
    x = L.embed(cfg, params["embed"], tokens)
    pos_table = params["dec_pos"]
    reps = -(-s // pos_table.shape[0])
    pos = pos_table.repeat(reps, 1)[:s]      # wraps past 4096 rows
    x = x + L._c(pos, cdt)[None]
    x = constrain(x, P(BATCH, None, None))
    for i in range(cfg.n_layers):
        lp = L.layer(params["dec_layers"], i)
        h = L.apply_norm(cfg, lp["ln1"], x)
        x = x + _mha(cfg, lp["self_attn"], h, h, True, use_kernels)
        h = L.apply_norm(cfg, lp["ln_x"], x)
        x = x + _mha(cfg, lp["cross_attn"], h, enc, False, use_kernels)
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = constrain(x + L.ffn(cfg, lp["mlp"], h), P(BATCH, None, None))
    x = L.apply_norm(cfg, params["dec_ln"], x)
    if last_only:
        x = x[:, -1:]
    return L.logits_out(cfg, params["embed"], x)


def whisper_loss(cfg: ArchConfig, params: dict, batch: dict):
    enc = encode(cfg, params, batch["frames"], use_kernels=False)
    logits = decode_train(cfg, params, batch["tokens"], enc,
                          use_kernels=False)
    return L.cross_entropy(logits, batch["labels"], batch.get("mask"))


# --------------------------------------------------------------------------
# decode (serve_step): self-attn KV cache + precomputed cross KV
# --------------------------------------------------------------------------

def whisper_cache_shape(cfg: ArchConfig, batch: int, seq: int) -> dict:
    dt = L.dtype_of(cfg.compute_dtype)
    h, hd, nl = cfg.n_heads, cfg.hd, cfg.n_layers
    return {
        "k": L.TensorSpec((nl, batch, seq, h, hd), dt),
        "v": L.TensorSpec((nl, batch, seq, h, hd), dt),
        "cross_k": L.TensorSpec((nl, batch, cfg.enc_seq, h, hd), dt),
        "cross_v": L.TensorSpec((nl, batch, cfg.enc_seq, h, hd), dt),
    }


def whisper_cache_spec(cfg: ArchConfig) -> dict:
    spec = P(None, BATCH, "model", None, None)
    return {"k": spec, "v": spec, "cross_k": spec, "cross_v": spec}


def whisper_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens,
                        pos: int):
    """tokens int[B,1] at position `pos` (a host integer) -> (logits
    f32[B,1,V], cache), the self-attention cache written in place."""
    cdt = L.dtype_of(cfg.compute_dtype)
    x = L.embed(cfg, params["embed"], tokens)
    ptab = params["dec_pos"]
    x = x + L._c(ptab[pos % ptab.shape[0]], cdt)[None, None]
    x = constrain(x, P(BATCH, None, None))
    enc_mask = torch.ones((1, cfg.enc_seq), dtype=torch.bool,
                          device=x.device)
    scale = 1.0 / math.sqrt(cfg.hd)
    for i in range(cfg.n_layers):
        lp = L.layer(params["dec_layers"], i)
        h = L.apply_norm(cfg, lp["ln1"], x)
        h, _, _ = _mha_decode(cfg, lp["self_attn"], h, cache["k"][i],
                              cache["v"][i], pos)
        x = x + h
        h = L.apply_norm(cfg, lp["ln_x"], x)
        q = _project(lp["cross_attn"], h, cdt, "q")
        out = L.sdpa(q, cache["cross_k"][i], cache["cross_v"][i], enc_mask,
                     scale)
        x = x + _out(lp["cross_attn"], out, cdt)
        h = L.apply_norm(cfg, lp["ln2"], x)
        x = x + L.ffn(cfg, lp["mlp"], h)
    x = L.apply_norm(cfg, params["dec_ln"], x)
    return L.logits_out(cfg, params["embed"], x), cache
