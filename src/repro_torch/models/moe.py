"""Mixture-of-Experts decoders: qwen3-moe (GQA + 128 experts top-8) and
deepseek-v2 (MLA + 2 shared + 160 experts top-6) (the port of the
reference's `models/moe.py`).

Dispatch is the reference's GShard group-limited scheme (`moe_ffn`): tokens
are split into groups of `router_group`, and each group dispatches into
per-expert capacity buffers with one-hot einsums.  A (token, expert) pair
past its expert's capacity is dropped, at prefill and at decode alike (at
decode a group is the batch, so qwen3-moe's capacity is one slot), as in
the reference.  `moe_ffn_sort` is the sort-based dispatch
(`dispatch="sort"`): an argsort over the expert assignments, a gather into
[E, C] buffers, and a combine that gathers each token's kept slots and adds
them one at a time in ascending expert order, the order of the reference's
scatter-add (its sort is stable by expert), so a run repeats bit for bit on
the card, where a scatter-add would take atomics.  The router, the
dispatch and combine einsums and the expert products are PyTorch matrix
products, as the reference computes them outside any Pallas kernel.

MLA (deepseek-v2) prefill takes the expanded form.  On the serving path its
attention is `ops.flash_attention` (the kernel on the card) with v
zero-padded to the q / k width (192) and the output cut back to v's (128):
the zero columns only add zeros.  The loss takes the reference's blockwise
softmax (`use_kernels=False`).  Decode takes the absorbed form over the
[B, S, kv_lora] latent cache and the [B, S, rope] key cache.

The parameters carry the reference's partition specs (experts over
`model`, their width and the embedding over `data`: FSDP), and the
activations are constrained where the reference constrains them (no-ops
without a mesh); its scans over layers are Python loops, each layer
checkpointed under `cfg.remat` as the reference's scan body is.
"""
from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from ..core import telemetry
from ..core.config import inv_f32
from ..distributed.ctx import (P, constrain, on_attention_shards,
                               on_key_shards, on_shards, to_layout)
from ..kernels import ops
from . import layers as L
from .config import ArchConfig

F32 = torch.float32
BATCH = L.BATCH

# --------------------------------------------------------------------------
# MoE FFN
# --------------------------------------------------------------------------


def moe_defs(cfg: ArchConfig) -> dict:
    m = cfg.moe
    d, fe = cfg.d_model, m.d_ff_expert
    defs = {
        "router": L.ParamDef((d, m.n_experts), scale=0.1),
        "w_gate": L.ParamDef((m.n_experts, d, fe),
                             spec=P("model", "data", None)),
        "w_up": L.ParamDef((m.n_experts, d, fe),
                           spec=P("model", "data", None)),
        "w_down": L.ParamDef((m.n_experts, fe, d),
                             spec=P("model", None, "data")),
    }
    if m.n_shared:
        defs["shared"] = L.ffn_defs(cfg, m.n_shared * fe, fsdp=True)
    return defs


def _capacity(cfg: ArchConfig, gs: int | None = None) -> int:
    m = cfg.moe
    gs = m.router_group if gs is None else gs
    c = int(gs * m.top_k * m.capacity_factor / m.n_experts)
    return max(c, 1)


_ROUTES = threading.local()


@contextlib.contextmanager
def record_routes():
    """A list of every routing decision made inside the block, one entry a
    router call (a layer of a prefill or of a decode step), in order: (the
    top k + 1 router probabilities [..., k + 1], the chosen experts
    [..., k]), as computed (on a mesh, DTensors).  For comparing expert
    choices between runs where the k-th and (k+1)-th probabilities are
    apart."""
    prev = getattr(_ROUTES, "log", None)
    _ROUTES.log = []
    try:
        yield _ROUTES.log
    finally:
        _ROUTES.log = prev


def routes_agree(got: list, want: list, k: int, margin: float) -> dict:
    """The expert choices of two runs' `record_routes` lists (whole
    tensors), compared for the tokens whose k-th and (k+1)-th router
    probabilities in `want` are more than `margin` apart: the tokens
    compared, those left out, and those whose sets of k experts differ.
    A choice is a set: the order of a token's k experts among themselves
    changes no expert a token reaches (the dispatch and the combine follow
    expert order), and two of them nearly tied inside the top k swap
    places under rounding that the margin does not guard; the tokens
    whose sets agree in another order are counted as `reordered`."""
    n = left = bad = reordered = 0
    for (_, gi), (top, wi) in zip(got, want, strict=True):
        decided = (top[..., k - 1] - top[..., k]) > margin
        same = (torch.sort(gi, dim=-1).values
                == torch.sort(wi, dim=-1).values).all(-1)
        n += int(decided.sum())
        left += int((~decided).sum())
        bad += int((~same & decided).sum())
        reordered += int((same & (gi != wi).any(-1)).sum())
    return {"compared": n, "left_out": left, "differ": bad,
            "reordered": reordered}


def _route(cfg: ArchConfig, p: dict, x):
    """(probs, gate values, gate indices) of tokens `x` [..., D]: the f32
    router softmax, its top-k (descending) and the gate values renormalised
    to sum to 1."""
    logits = x.to(F32) @ p["router"].to(F32)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    log = getattr(_ROUTES, "log", None)
    if log is not None:
        # outside autograd: a checkpointed layer's recompute (on the card,
        # in autograd's own thread, where no log is open) must save what
        # its forward saved
        with torch.no_grad():
            log.append((torch.topk(probs, cfg.moe.top_k + 1,
                                   dim=-1).values, gate_idx))
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return probs, gate_vals, gate_idx


def _experts(cfg: ArchConfig, p: dict, xe, cdt):
    """The expert FFNs of buffers xe [E, rows, D] -> [E, rows, D].  On a
    mesh the experts' FSDP split over `data` is gathered first."""
    w = {k: constrain(L._c(p[k], cdt), P("model", None, None))
         for k in ("w_gate", "w_up", "w_down")}
    g = torch.bmm(xe, w["w_gate"])
    u = torch.bmm(xe, w["w_up"])
    h = L._ACTS[cfg.act](g) * u
    return torch.bmm(h, w["w_down"])


def moe_ffn_sort(cfg: ArchConfig, p: dict, x):
    """Sort-based dispatch (`dispatch="sort"`): capacity is global, C =
    T * top_k * capacity_factor / E; each expert's tokens keep their order
    (a stable argsort), the first C of them are gathered into its buffer,
    and every token adds its kept slots in ascending expert order."""
    m = cfg.moe
    with telemetry.stage_scope("moe", x.device):
        cdt = L.dtype_of(cfg.compute_dtype)
        b, s, d = x.shape
        t, k, e = b * s, m.top_k, m.n_experts
        dev = x.device
        xf = x.reshape(t, d)
        probs, gate_vals, gate_idx = _route(cfg, p, xf)        # [T,E] [T,K]
        if L._is_dtensor(gate_idx):
            # on a mesh the global capacity's bookkeeping (a stable
            # argsort, a searchsorted, scatters: no sharding rule covers
            # them) runs on whole index tensors, and the buffers gather
            # from every token
            gate_idx, gate_vals = gate_idx.full_tensor(), \
                gate_vals.full_tensor()
            xf = constrain(xf, P(None, None))
        onehot_k = F.one_hot(gate_idx, e).to(F32)
        frac_tokens = onehot_k.sum(1).mean(0) / k
        aux = e * torch.sum(frac_tokens * probs.mean(0))

        c = max(int(t * m.top_k * m.capacity_factor / m.n_experts), 1)
        e_flat = gate_idx.reshape(-1)                          # [T*K]
        order = torch.argsort(e_flat, stable=True)             # FIFO per expert
        e_sorted = e_flat[order]
        pos = torch.arange(t * k, device=dev)
        tok_sorted = pos[order] // k
        w_sorted = gate_vals.reshape(-1)[order]
        starts = torch.searchsorted(e_sorted, torch.arange(e, device=dev),
                                    right=False)
        rank = pos - starts[e_sorted]
        keep = rank < c
        # each kept pair's (expert, slot); a dropped pair writes the spare
        # slot e * c, which is cut off: an unused slot reads token 0 with
        # weight 0
        slot = torch.where(keep, e_sorted * c + rank, e * c)
        dispatch_tok = torch.zeros(e * c + 1, dtype=torch.int64, device=dev)
        dispatch_tok[slot] = tok_sorted
        dispatch_w = torch.zeros(e * c + 1, dtype=F32, device=dev)
        dispatch_w[slot] = w_sorted
        dispatch_tok, dispatch_w = dispatch_tok[:e * c], dispatch_w[:e * c]

        xe = xf.to(cdt)[dispatch_tok].reshape(e, c, d)
        xe = constrain(xe, P("model", None, None))
        ye = constrain(_experts(cfg, p, xe, cdt), P("model", None, None))
        # every token's slots, on any rank's experts: the buffers whole
        ye = constrain(ye.reshape(e * c, d), P(None, None))
        ye = ye * dispatch_w[:, None].to(cdt)
        # the combine: each token's slots (the spare slot, a zero row, for
        # a dropped pair), ascending, added one at a time from zero
        slot_of = torch.empty_like(slot)
        slot_of[order] = slot
        slots = torch.sort(slot_of.reshape(t, k), dim=-1).values
        ye = torch.cat([ye, ye.new_zeros((1, d))])
        y = torch.zeros((t, d), dtype=cdt, device=dev)
        for j in range(k):
            y = y + ye[slots[:, j]]
        y = y.reshape(b, s, d)
        if m.n_shared:
            y = y + L.ffn(cfg, p["shared"], x)
        return constrain(y, L.residual_spec(cfg)), aux


def moe_ffn(cfg: ArchConfig, p: dict, x):
    """x: [B,S,D] -> ([B,S,D], aux_loss scalar)."""
    if cfg.moe.dispatch == "sort":
        return moe_ffn_sort(cfg, p, x)
    m = cfg.moe
    with telemetry.stage_scope("moe", x.device):
        cdt = L.dtype_of(cfg.compute_dtype)
        b, s, d = x.shape
        t = b * s
        gs = min(m.router_group, t)
        n = t // gs
        xg = x.reshape(n, gs, d)

        # --- routing (f32 for numerics) ---
        probs, gate_vals, gate_idx = _route(cfg, p, xg)        # [N,Gs,K]

        # load-balancing aux loss (Switch-style): E * sum_e f_e * p_e
        onehot_k = F.one_hot(gate_idx, m.n_experts).to(F32)    # [N,Gs,K,E]
        sel = onehot_k.sum(2)
        frac_tokens = sel.mean((0, 1)) / m.top_k
        frac_probs = probs.mean((0, 1))
        aux = m.n_experts * torch.sum(frac_tokens * frac_probs)

        # --- capacity: position of each (token, k) within its expert ---
        c = _capacity(cfg, gs)
        flatsel = onehot_k.reshape(n, gs * m.top_k, m.n_experts)
        pos = torch.cumsum(flatsel, dim=1) - flatsel           # FIFO over (g,k)
        pos = (pos * flatsel).sum(-1).reshape(n, gs, m.top_k)
        keep = pos < c
        # a dropped pair's one-hot row is zero (index c, cut off)
        pos_oh = F.one_hot(torch.where(keep, pos, c).long(),
                           c + 1)[..., :c].to(F32)

        # combine[n,g,e,c] = gate weight routed to (expert e, slot c)
        combine = torch.einsum("ngke,ngkc->ngec", onehot_k,
                               pos_oh * gate_vals[..., None])
        dispatch = (combine > 0).to(cdt)
        combine = constrain(combine.to(cdt), P(BATCH, None, "model", None))
        dispatch = constrain(dispatch, P(BATCH, None, "model", None))

        # --- dispatch -> expert FFN -> combine ---
        # (on a mesh each rank's groups and experts: the einsums' merged
        # dimensions would be split two ways, which has no sharding rule)
        buf, slots = P("model", BATCH, None, None), P(BATCH, None, "model",
                                                       None)
        xe = on_shards(lambda a, w: torch.einsum("ngd,ngec->encd", a, w),
                       (xg.to(cdt), dispatch), (P(BATCH, None, None), slots),
                       buf, (m.n_experts, n, c, d))
        xe = constrain(xe, buf)
        ye = _experts(cfg, p, xe.reshape(m.n_experts, n * c, d), cdt)
        ye = constrain(ye.reshape(m.n_experts, n, c, d), buf)
        y = on_shards(lambda a, w: torch.einsum("encd,ngec->ngd", a, w),
                      (ye, combine), (buf, slots), P(BATCH, None, None),
                      (n, gs, d), partial=("model",))
        y = y.reshape(b, s, d)

        if m.n_shared:
            y = y + L.ffn(cfg, p["shared"], x)
        return constrain(y, P(BATCH, None, None)), aux


# --------------------------------------------------------------------------
# MLA attention (deepseek-v2)
# --------------------------------------------------------------------------

def mla_defs(cfg: ArchConfig) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.nope_head_dim + m.rope_head_dim
    defs: dict = {}
    heads = P(None, "model", None)
    if m.q_lora_rank:
        defs["wq_a"] = L.ParamDef((d, m.q_lora_rank))
        defs["q_norm"] = L.ParamDef((m.q_lora_rank,), "ones")
        defs["wq_b"] = L.ParamDef((m.q_lora_rank, h, qk), spec=heads)
    else:
        defs["wq"] = L.ParamDef((d, h, qk), spec=heads)
    defs["wkv_a"] = L.ParamDef((d, m.kv_lora_rank + m.rope_head_dim))
    defs["kv_norm"] = L.ParamDef((m.kv_lora_rank,), "ones")
    defs["wkv_b"] = L.ParamDef(
        (m.kv_lora_rank, h, m.nope_head_dim + m.v_head_dim), spec=heads)
    defs["wo"] = L.ParamDef((h, m.v_head_dim, d),
                            spec=P("model", None, None))
    return defs


def _mla_q(cfg: ArchConfig, p, x, positions, cdt):
    m = cfg.mla
    if "wq_a" in p:
        cq = x @ L._c(p["wq_a"], cdt)
        cq = L.rms_norm(cq, p["q_norm"], cfg.norm_eps)
        q = L._proj_heads(cq, L._c(p["wq_b"], cdt))
    else:
        q = L._proj_heads(x, L._c(p["wq"], cdt))
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    cos, sin = L.rope_angles(positions, m.rope_head_dim, cfg.rope_theta)
    return q_nope, L.apply_rope(q_rope, cos, sin)


def _mla_latent(cfg: ArchConfig, p, x, positions, cdt):
    """(normed latent [B,S,R], roped shared key [B,S,1,Rr]) of x."""
    m = cfg.mla
    ckv = x @ L._c(p["wkv_a"], cdt)
    ckv, k_rope = ckv[..., :m.kv_lora_rank], ckv[..., m.kv_lora_rank:]
    ckv = L.rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    cos, sin = L.rope_angles(positions, m.rope_head_dim, cfg.rope_theta)
    return ckv, L.apply_rope(k_rope[:, :, None, :], cos, sin)


def mla_attention(cfg: ArchConfig, p: dict, x, positions,
                  use_kernels: bool = True):
    """Expanded-form MLA (training / prefill): flash attention over the
    per-head q / k of width nope + rope and v padded to it (the kernel on
    the card); with use_kernels=False the reference's blockwise softmax."""
    m = cfg.mla
    cdt = L.dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    h = cfg.n_heads
    with telemetry.stage_scope("attention", x.device):
        q_nope, q_rope = _mla_q(cfg, p, x, positions, cdt)
        ckv, k_rope = _mla_latent(cfg, p, x, positions, cdt)
        kv = L._proj_heads(ckv, L._c(p["wkv_b"], cdt))
        k_nope, v = kv[..., :m.nope_head_dim], kv[..., m.nope_head_dim:]

        scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)
        # the shared rope key folded into per-head keys: a standard MHA
        # with head dim nope + rope
        q_eff = torch.cat([q_nope, q_rope], dim=-1)
        k_rope = k_rope.expand(b, s, h, m.rope_head_dim)
        if L._is_dtensor(k_nope):
            # laid out as the per-head keys (their head split), so the
            # concatenation's operands agree
            k_rope = to_layout(k_rope, k_nope.device_mesh, k_nope.placements)
        k_eff = torch.cat([k_nope, k_rope], dim=-1)
        if use_kernels:
            dv = v.shape[-1]
            dp = max(q_eff.shape[-1], dv)

            def flash(q, k, v):
                q, k, v = (F.pad(t, (0, dp - t.shape[-1])) for t in (q, k, v))
                return ops.flash_attention(q, k, v, scale=scale,
                                           causal=True)[..., :dv]
            out = on_attention_shards(flash, q_eff, k_eff, v)
        elif cfg.attn_block:
            out = L.sdpa_blockwise(q_eff, k_eff, v, scale,
                                   block=cfg.attn_block)
        else:
            out = L.sdpa(q_eff, k_eff, v,
                         L.causal_mask(s, s, device=x.device), scale)
        return L._merge_heads(out, L._c(p["wo"], cdt))


def mla_decode(cfg: ArchConfig, p: dict, x, cache_ckv, cache_kr, pos: int):
    """Absorbed-form MLA decode: attend in the kv_lora latent space.

    cache_ckv: [B,S,R] compressed latents; cache_kr: [B,S,Rr] shared rope
    keys; both written in place at `pos` (a host integer).
    """
    m = cfg.mla
    cdt = L.dtype_of(cfg.compute_dtype)
    b = x.shape[0]
    posv = torch.full((b, 1), pos, dtype=torch.int64, device=x.device)
    q_nope, q_rope = _mla_q(cfg, p, x, posv, cdt)             # [B,1,H,*]
    ckv, k_rope = _mla_latent(cfg, p, x, posv, cdt)
    cache_ckv = L.cache_update(cache_ckv, ckv, pos)
    cache_kr = L.cache_update(cache_kr, k_rope[:, :, 0, :], pos)
    cache_ckv = constrain(cache_ckv, P(BATCH, "model", None))
    cache_kr = constrain(cache_kr, P(BATCH, "model", None))

    wkv_b = L._c(p["wkv_b"], cdt)
    wk = wkv_b[..., :m.nope_head_dim]                        # [R,H,Dn]
    wv = wkv_b[..., m.nope_head_dim:]                        # [R,H,Dv]
    # absorb the k projection into q: q_lat[b,h,r] = sum_d q_nope wk
    q_lat = torch.einsum("bshk,rhk->bshr", q_nope, wk)      # [B,1,H,R]
    scale = 1.0 / math.sqrt(m.nope_head_dim + m.rope_head_dim)

    def attend(qs, kvs, start):
        # over the latents at positions start .. start + ckv.shape[1]
        (q_lat, q_rope), (ckv, kr) = (qs[0][:, 0], qs[1][:, 0]), kvs
        # the two score products added in the compute type, then f32 and
        # scale
        logits = (torch.einsum("bhr,bsr->bhs", q_lat, ckv)
                  + torch.einsum("bhk,bsk->bhs", q_rope, kr))
        logits = logits.to(F32) * scale
        mask = torch.arange(start, start + ckv.shape[1],
                            device=ckv.device) <= pos
        logits = torch.where(mask[None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1).to(cdt)
        o_lat = torch.einsum("bhs,bsr->bhr", probs, ckv)      # [B,H,R]
        return o_lat[:, None], logits[:, None]
    # on a mesh the caches stay split over their positions (`on_key_shards`)
    o_lat = on_key_shards(attend, (q_lat, q_rope),
                          (cache_ckv, cache_kr))[:, 0]
    out = torch.einsum("bhr,rhd->bhd", o_lat, wv)[:, None]   # [B,1,H,Dv]
    out = L._merge_heads(out, L._c(p["wo"], cdt))
    return out, cache_ckv, cache_kr


# --------------------------------------------------------------------------
# full MoE decoder models
# --------------------------------------------------------------------------

def moe_model_defs(cfg: ArchConfig) -> dict:
    attn = mla_defs(cfg) if cfg.mla is not None else L.attn_defs(cfg)
    layer = {"ln1": L.norm_defs(cfg), "attn": attn,
             "ln2": L.norm_defs(cfg), "moe": moe_defs(cfg)}
    defs = {"embed": L.embed_defs(cfg, fsdp=True),
            "layers": L.stack_defs(layer, cfg.n_layers - cfg.moe.first_dense),
            "ln_f": L.norm_defs(cfg)}
    if cfg.moe.first_dense:
        dense_layer = {"ln1": L.norm_defs(cfg), "attn": attn,
                       "ln2": L.norm_defs(cfg),
                       "mlp": L.ffn_defs(cfg, cfg.d_ff, fsdp=True)}
        defs["dense_layers"] = L.stack_defs(dense_layer, cfg.moe.first_dense)
    return defs


def _moe_layer_fn(cfg: ArchConfig, use_kernels: bool = True):
    def fn(x, lp, positions):
        h = L.apply_norm(cfg, lp["ln1"], x)
        if cfg.mla is not None:
            h = mla_attention(cfg, lp["attn"], h, positions, use_kernels)
        else:
            h = L.attention(cfg, lp["attn"], h, positions,
                            use_kernels=use_kernels)
        x = x + h
        h = L.apply_norm(cfg, lp["ln2"], x)
        if "moe" in lp:
            h, aux = moe_ffn(cfg, lp["moe"], h)
        else:
            h = L.ffn(cfg, lp["mlp"], h)
            aux = torch.zeros((), dtype=F32, device=x.device)
        return constrain(x + h, L.residual_spec(cfg)), aux
    return L.checkpointed(cfg, fn)


def moe_logits(cfg: ArchConfig, params: dict, tokens, last_only: bool = False,
               use_kernels: bool = True):
    """tokens int[B,S] -> (logits f32[B,S,V] (last_only: [B,1,V]), the
    layers' summed aux loss).  use_kernels=False: attention without the
    flash kernel (the training path)."""
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    fn = _moe_layer_fn(cfg, use_kernels)
    aux_total = torch.zeros((), dtype=F32, device=x.device)
    for i in range(cfg.moe.first_dense):
        x, a = fn(x, L.layer(params["dense_layers"], i), positions)
        aux_total = aux_total + a
    for i in range(cfg.n_layers - cfg.moe.first_dense):
        x, a = fn(x, L.layer(params["layers"], i), positions)
        aux_total = aux_total + a
    x = L.apply_norm(cfg, params["ln_f"], x)
    if last_only:
        x = x[:, -1:]
    return L.logits_out(cfg, params["embed"], x), aux_total


def moe_loss(cfg: ArchConfig, params: dict, batch: dict, aux_weight=0.01):
    logits, aux = moe_logits(cfg, params, batch["tokens"], use_kernels=False)
    return (L.cross_entropy(logits, batch["labels"], batch.get("mask"))
            + aux_weight * aux * inv_f32(cfg.n_layers))


# ---- decode ----------------------------------------------------------------

def moe_cache_shape(cfg: ArchConfig, batch: int, seq: int) -> dict:
    dt = L.dtype_of(cfg.compute_dtype)
    nl = cfg.n_layers - cfg.moe.first_dense
    if cfg.mla is not None:
        m = cfg.mla
        out = {"ckv": L.TensorSpec((nl, batch, seq, m.kv_lora_rank), dt),
               "kr": L.TensorSpec((nl, batch, seq, m.rope_head_dim), dt)}
        if cfg.moe.first_dense:
            out["dense_ckv"] = L.TensorSpec(
                (cfg.moe.first_dense, batch, seq, m.kv_lora_rank), dt)
            out["dense_kr"] = L.TensorSpec(
                (cfg.moe.first_dense, batch, seq, m.rope_head_dim), dt)
        return out
    kv = L.TensorSpec((nl, batch, seq, cfg.n_kv_heads, cfg.hd), dt)
    return {"k": kv, "v": kv}


def moe_cache_spec(cfg: ArchConfig) -> dict:
    """The caches' sequence axis over `model`."""
    if cfg.mla is not None:
        spec3 = P(None, BATCH, "model", None)
        out = {"ckv": spec3, "kr": spec3}
        if cfg.moe.first_dense:
            out["dense_ckv"] = spec3
            out["dense_kr"] = spec3
        return out
    spec = P(None, BATCH, "model", None, None)
    return {"k": spec, "v": spec}


def moe_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens,
                    pos: int):
    """tokens int[B,1] at position `pos` (a host integer) -> (logits
    f32[B,1,V], cache), the cache written in place."""
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))

    def attn_step(lp, x, ck, cv):
        h = L.apply_norm(cfg, lp["ln1"], x)
        if cfg.mla is not None:
            h, _, _ = mla_decode(cfg, lp["attn"], h, ck, cv, pos)
        else:
            h, _, _ = L.attention_decode(
                cfg, lp["attn"], h, ck, cv, pos,
                cache_spec=P(BATCH, "model", None, None))
        return x + h

    keys = ("dense_ckv", "dense_kr") if cfg.mla is not None else ("k", "v")
    for i in range(cfg.moe.first_dense):
        lp = L.layer(params["dense_layers"], i)
        x = attn_step(lp, x, cache[keys[0]][i], cache[keys[1]][i])
        x = x + L.ffn(cfg, lp["mlp"], L.apply_norm(cfg, lp["ln2"], x))

    keys = ("ckv", "kr") if cfg.mla is not None else ("k", "v")
    for i in range(cfg.n_layers - cfg.moe.first_dense):
        lp = L.layer(params["layers"], i)
        x = attn_step(lp, x, cache[keys[0]][i], cache[keys[1]][i])
        h, _ = moe_ffn(cfg, lp["moe"], L.apply_norm(cfg, lp["ln2"], x))
        x = x + h
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.logits_out(cfg, params["embed"], x), cache
