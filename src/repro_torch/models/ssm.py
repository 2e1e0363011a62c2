"""Mamba-2 (SSD: state-space duality) blocks, for mamba2-2.7b and the
zamba2-7b hybrid backbone (the port of the reference's `models/ssm.py`).

The SSD forward is the chunked dual form of the selective-state recurrence
(Dao & Gu, arXiv:2405.21060): within a chunk the output is a masked
quadratic ("attention-like") form, `kernels.ops.ssd_intra_chunk` (the
kernel on the card, its segsum plain version on the CPU) when serving,
and the reference's segsum einsums with `use_kernels=False` (the training
path, `ssm_loss`); across chunks a small recurrence carries the [H, N, P]
state.  Decode is the O(1) recurrent form over the same parameters, in
plain tensor ops.

Einsum letters: b=batch, c=chunk, q/k=position-in-chunk, h=head,
g=group, r=head-in-group, p=head-channel, s=ssm-state.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..distributed.ctx import (P, constrain, from_local, local_of,
                               shard_box, split_dims, to_layout)
from ..kernels import ops
from . import layers as L
from .config import ArchConfig

F32 = torch.float32
BATCH = L.BATCH
STATE_KEYS = ("h", "conv_x", "conv_b", "conv_c")


def _dims(cfg: ArchConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    return d_in, d_in // s.head_dim


def ssm_block_defs(cfg: ArchConfig) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    d_in, n_heads = _dims(cfg)
    gn = s.n_groups * s.d_state
    D = L.ParamDef
    cols, heads = P(None, "model"), P("model")
    return {
        "in_z": D((d, d_in), spec=cols), "in_x": D((d, d_in), spec=cols),
        "in_b": D((d, gn)), "in_c": D((d, gn)),
        "in_dt": D((d, n_heads), spec=cols),
        "conv_x": D((s.d_conv, d_in), scale=0.5, spec=cols),
        "conv_b": D((s.d_conv, gn), scale=0.5),
        "conv_c": D((s.d_conv, gn), scale=0.5),
        "a_log": D((n_heads,), "zeros", spec=heads),
        "dt_bias": D((n_heads,), "zeros", spec=heads),
        "d_skip": D((n_heads,), "ones", spec=heads),
        "gate_norm": D((d_in,), "ones", spec=heads),
        "out": D((d_in, d), spec=P("model", None)),
    }


# On a mesh the block's convolutions and its SSD scan (and step) run on
# each rank's shards: a rank's batch rows and channels (heads) need no
# other rank's, so no collective runs inside them and DTensor's rules for
# padding, einsums and views, which differ between PyTorch releases, are
# not needed.  `_kept` gives the layout a rank computes in.

def _kept(x, dims) -> list:
    """x's placements with its splits of the tensor dimensions `dims` kept
    and any other split (or partial sum) made whole."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim in dims else Replicate()
            for p in x.placements]


def _moved(pl, moves: dict) -> list:
    """Placements `pl` with Shard(d) made Shard(moves[d]) for d in
    `moves`, and every other split replicated."""
    from torch.distributed.tensor import Replicate, Shard
    return [Shard(moves[p.dim]) if p.is_shard() and p.dim in moves
            else Replicate() for p in pl]


def _locals(mesh, pairs, used) -> list:
    """Each (tensor, placements) of `pairs` laid out so, this rank's
    shard."""
    return [local_of(to_layout(t, mesh, pl), used) for t, pl in pairs]


def _groups_of(h: int, g: int, h0: int, hl: int) -> slice:
    """The groups that heads h0 .. h0 + hl of H = h heads in g groups
    read (head i reads group i // (h // g)): whole groups, or one."""
    r = h // g
    if hl % r == 0 and h0 % r == 0:
        return slice(h0 // r, (h0 + hl) // r)
    if r % hl == 0:
        return slice(h0 // r, h0 // r + 1)
    raise ValueError(f"a rank's heads {h0}..{h0 + hl} split a group of "
                     f"{r} heads")


def causal_conv(x, w):
    """Depthwise causal conv: x [B,S,C], w [K,C] -> [B,S,C]."""
    if type(x).__name__ == "DTensor":
        mesh = x.device_mesh
        xp = _kept(x, (0, 2))
        used = split_dims(xp)
        out = causal_conv(*_locals(mesh, ((x, xp), (w, _moved(xp, {2: 1}))),
                                   used))
        return from_local(out, mesh, xp, x.shape)
    k = w.shape[0]
    xp = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i: i + x.shape[1], :] * L._c(w[i], x.dtype)
    return out


def conv_step(state, xt, w):
    """Decode-time conv: state [B,K-1,C] holds the last K-1 inputs."""
    if type(xt).__name__ == "DTensor":
        mesh = xt.device_mesh
        xp = _kept(xt, (0, 1))
        sp = _moved(xp, {0: 0, 1: 2})
        used = split_dims(xp)
        new, out = conv_step(*_locals(mesh, ((state, sp), (xt, xp),
                                             (w, _moved(xp, {1: 1}))), used))
        return (from_local(new, mesh, sp, state.shape),
                from_local(out, mesh, xp, xt.shape))
    window = torch.cat([state, xt[:, None, :]], dim=1)          # [B,K,C]
    out = torch.einsum("bkc,kc->bc", window, L._c(w, xt.dtype))
    return window[:, 1:], out


# --------------------------------------------------------------------------
# SSD chunked scan (prefill)
# --------------------------------------------------------------------------

def _segsum(a):
    """a: [..., Q] -> a-sums over (k, q] as lower-triangular [..., Q, Q]
    (-inf above the diagonal)."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=a.device))
    return torch.where(mask, diff, -torch.inf)


def _intra_chunk_plain(xdt, da_h, bg, cg, r: int):
    """The intra-chunk term as the reference's jnp path computes it
    (`ssd_scan` with use_pallas=False): B and C repeated per head, the
    decayed scores `cb * exp(segsum)`, then their product with xdt."""
    bh = bg.repeat_interleave(r, dim=3)
    ch = cg.repeat_interleave(r, dim=3)
    decay = torch.exp(_segsum(da_h))                          # [b,c,h,q,k]
    cb = torch.einsum("bcqhs,bckhs->bchqk", ch, bh)
    return torch.einsum("bchqk,bckhp->bcqhp", cb * decay, xdt)


def ssd_scan(x, dt, a, b, c, chunk: int, use_kernels: bool = True):
    """Chunked SSD.  x:[B,S,H,P] dt:[B,S,H] a:[H] b,c:[B,S,G,N].

    Returns (y [B,S,H,P], final_state [B,H,N,P]) in x's type; the math is
    f32.  B and C stay in their G groups (head h reads group h // (H // G))
    and are never repeated per head, except on the plain intra-chunk path
    (use_kernels=False), which is the reference's.  DTensors (a model on
    a mesh) run the whole scan on each rank's batch rows and heads
    (`_ssd_scan_on_shards`).  Each chunk's inter-chunk term is added into
    the intra-chunk output in place (the reference's sum of the two,
    element by element), so no [B,S,H,P] f32 stack of them is held.
    """
    if type(x).__name__ == "DTensor":
        return _ssd_scan_on_shards(x, dt, a, b, c, chunk, use_kernels)
    bt, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"seq {s} not divisible by chunk {q}")
    nc, r = s // q, h // g

    dtf = dt.to(F32).reshape(bt, nc, q, h)
    bg = b.to(F32).reshape(bt, nc, q, g, n)
    cg = c.to(F32).reshape(bt, nc, q, g, n)

    da_h = (dtf * a).permute(0, 1, 3, 2)          # [b,c,h,q], a < 0
    cum = torch.cumsum(da_h, dim=-1)              # [b,c,h,q]
    total = cum[..., -1]                          # [b,c,h]
    xdt = x.to(F32).reshape(bt, nc, q, h, p) * dtf[..., None]  # [b,c,q,h,p]

    if use_kernels:
        y = ops.ssd_intra_chunk(xdt, da_h, bg, cg)
    else:
        y = _intra_chunk_plain(xdt, da_h, bg, cg, r)

    # per-chunk input->state summaries
    decay_out = torch.exp(total[..., None] - cum)                # [b,c,h,q]
    xw = (xdt * decay_out.permute(0, 1, 3, 2)[..., None]).reshape(
        bt, nc, q, g, r, p)
    del xdt
    z_states = torch.einsum("bcqgs,bcqgrp->bcgrsp", bg, xw).reshape(
        bt, nc, h, n, p)
    del xw

    # inter-chunk recurrence + state broadcast back into each chunk
    if torch.is_grad_enabled():
        y = y.clone()   # selective checkpointing may keep the product
    hstate = torch.zeros((bt, h, n, p), dtype=F32, device=x.device)
    for i in range(nc):
        yc = torch.einsum("bqgs,bgrsp->bqgrp", cg[:, i],
                          hstate.reshape(bt, g, r, n, p)).reshape(bt, q, h, p)
        y[:, i] += yc * torch.exp(cum[:, i]).permute(0, 2, 1)[..., None]
        hstate = (hstate * torch.exp(total[:, i])[..., None, None]
                  + z_states[:, i])
    return y.reshape(bt, s, h, p).to(x.dtype), hstate.to(x.dtype)


def _ssd_scan_on_shards(x, dt, a, b, c, chunk: int, use_kernels: bool):
    """`ssd_scan` of DTensors on each rank's shards: x's batch and head
    splits kept (any other split gathered), dt and a split alike, B and C
    split with the batch and whole over the groups, of which a rank reads
    the ones its heads read (`_groups_of`).  Its chunk loop runs on plain
    tensors (and the kernel on the card) rather than through DTensor's
    dispatch.  y is laid out as x's kept splits, the final state
    [B,H,N,P] alike."""
    mesh = x.device_mesh
    xp = _kept(x, (0, 2))
    used = split_dims(xp)
    h0, hl = shard_box(x.shape, xp, mesh)[2]
    grp = _groups_of(x.shape[2], b.shape[2], h0, hl)
    bp = _moved(xp, {0: 0})
    xl, dtl, al, bl, cl = _locals(mesh, (
        (x, xp), (dt, xp), (a, _moved(xp, {2: 0})), (b, bp), (c, bp)), used)
    y, st = ssd_scan(xl, dtl, al, bl[:, :, grp], cl[:, :, grp], chunk,
                     use_kernels)
    return (from_local(y, mesh, xp, x.shape),
            from_local(st, mesh, _moved(xp, {0: 0, 2: 1}),
                       (x.shape[0], x.shape[2], b.shape[3], x.shape[3])))


def ssd_step(hstate, xt, dtt, a, bt_, ct):
    """O(1) decode recurrence.  hstate:[B,H,N,P] xt:[B,H,P] dtt:[B,H]
    bt_/ct:[B,G,N] -> (new_state, y [B,H,P]).  DTensors run on each
    rank's batch rows and heads, as `_ssd_scan_on_shards`."""
    if type(xt).__name__ == "DTensor":
        mesh = xt.device_mesh
        xp = _kept(xt, (0, 1))
        used = split_dims(xp)
        h0, hl = shard_box(xt.shape, xp, mesh)[1]
        grp = _groups_of(xt.shape[1], bt_.shape[1], h0, hl)
        bp = _moved(xp, {0: 0})
        hs, xl, dl, al, bl, cl = _locals(mesh, (
            (hstate, xp), (xt, xp), (dtt, xp), (a, _moved(xp, {1: 0})),
            (bt_, bp), (ct, bp)), used)
        new, y = ssd_step(hs, xl, dl, al, bl[:, grp], cl[:, grp])
        return (from_local(new, mesh, xp, hstate.shape),
                from_local(y, mesh, xp, xt.shape))
    b, h, g, n = xt.shape[0], xt.shape[1], bt_.shape[1], bt_.shape[2]
    # each group's row repeated for its h // g heads (repeat_interleave)
    bh = bt_[:, :, None].expand(b, g, h // g, n).reshape(b, h, n).to(F32)
    chh = ct[:, :, None].expand(b, g, h // g, n).reshape(b, h, n).to(F32)
    dtf = dtt.to(F32)
    decay = torch.exp(dtf * a)[..., None, None]                   # [B,H,1,1]
    upd = (dtf[..., None] * bh)[..., None] * xt.to(F32)[:, :, None, :]
    hstate = hstate.to(F32) * decay + upd
    y = torch.einsum("bhs,bhsp->bhp", chh, hstate)
    return hstate.to(xt.dtype), y.to(xt.dtype)


# --------------------------------------------------------------------------
# mamba2 block
# --------------------------------------------------------------------------

def _block_inputs(cfg: ArchConfig, p: dict, u):
    """Shared projections for prefill and decode."""
    cdt = L.dtype_of(cfg.compute_dtype)
    return tuple(u @ L._c(p[k], cdt)
                 for k in ("in_z", "in_x", "in_b", "in_c", "in_dt"))


def _gated_out(cfg: ArchConfig, p: dict, y, z):
    y = L.rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return y @ L._c(p["out"], y.dtype)


def mamba2_block(cfg: ArchConfig, p: dict, u, use_kernels: bool = True):
    """u: [B,S,D] -> [B,S,D] (prefill and training path)."""
    s_cfg = cfg.ssm
    d_in, n_heads = _dims(cfg)
    z, x, braw, craw, dtraw = _block_inputs(cfg, p, u)
    x = F.silu(causal_conv(x, p["conv_x"]))
    braw = F.silu(causal_conv(braw, p["conv_b"]))
    craw = F.silu(causal_conv(craw, p["conv_c"]))

    bsz, s, _ = u.shape
    xh = x.reshape(bsz, s, n_heads, s_cfg.head_dim)
    xh = constrain(xh, P(BATCH, None, "model", None))
    bmat = braw.reshape(bsz, s, s_cfg.n_groups, s_cfg.d_state)
    cmat = craw.reshape(bsz, s, s_cfg.n_groups, s_cfg.d_state)
    dt = F.softplus(dtraw.to(F32) + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))

    y, _ = ssd_scan(xh, dt, a, bmat, cmat, s_cfg.chunk, use_kernels)
    y = y + xh * L._c(p["d_skip"], xh.dtype)[None, None, :, None]
    return _gated_out(cfg, p, y.reshape(bsz, s, d_in), z)


def mamba2_block_decode(cfg: ArchConfig, p: dict, u, state: dict):
    """u: [B,1,D]; state = {"h":[B,H,N,P], "conv_x/b/c": [B,K-1,*]}.
    Returns (out, new state) without touching `state`."""
    s_cfg = cfg.ssm
    d_in, n_heads = _dims(cfg)
    z, x, braw, craw, dtraw = _block_inputs(cfg, p, u)
    cx, x1 = conv_step(state["conv_x"], x[:, 0], p["conv_x"])
    cb, b1 = conv_step(state["conv_b"], braw[:, 0], p["conv_b"])
    cc, c1 = conv_step(state["conv_c"], craw[:, 0], p["conv_c"])
    x1, b1, c1 = F.silu(x1), F.silu(b1), F.silu(c1)

    bsz = u.shape[0]
    xh = x1.reshape(bsz, n_heads, s_cfg.head_dim)
    bmat = b1.reshape(bsz, s_cfg.n_groups, s_cfg.d_state)
    cmat = c1.reshape(bsz, s_cfg.n_groups, s_cfg.d_state)
    dt = F.softplus(dtraw[:, 0].to(F32) + p["dt_bias"].to(F32))
    a = -torch.exp(p["a_log"].to(F32))
    hstate, y = ssd_step(state["h"], xh, dt, a, bmat, cmat)
    y = y + xh * L._c(p["d_skip"], xh.dtype)[None, :, None]
    out = _gated_out(cfg, p, y.reshape(bsz, 1, d_in), z)
    return out, {"h": hstate, "conv_x": cx, "conv_b": cb, "conv_c": cc}


def mamba_layer_decode(cfg: ArchConfig, lp: dict, x, cache: dict, i: int):
    """One residual mamba layer of a decode step; writes layer i of the
    stacked `cache` leaves in place."""
    h = L.apply_norm(cfg, lp["ln"], x)
    out, st = mamba2_block_decode(cfg, lp["mix"], h,
                                  {k: cache[k][i] for k in STATE_KEYS})
    for k in STATE_KEYS:
        dst = cache[k][i]
        if type(dst).__name__ == "DTensor":
            # each rank writes its own shard (as `layers.cache_update`)
            dst.to_local().copy_(to_layout(st[k], dst.device_mesh,
                                           dst.placements).to_local())
        else:
            dst.copy_(st[k])
    return x + out


# --------------------------------------------------------------------------
# full mamba2 LM
# --------------------------------------------------------------------------

def ssm_model_defs(cfg: ArchConfig) -> dict:
    return {"embed": L.embed_defs(cfg),
            "layers": L.stack_defs(
                {"ln": L.norm_defs(cfg), "mix": ssm_block_defs(cfg)},
                cfg.n_layers),
            "ln_f": L.norm_defs(cfg)}


def mamba_stack(cfg: ArchConfig, lps: dict, x, n: int,
                use_kernels: bool = True):
    """n residual mamba layers, stacked on the leading axis of `lps`; each
    layer checkpointed under `cfg.remat` (the reference's scan body)."""
    def fn(x, lp):
        return constrain(
            x + mamba2_block(cfg, lp["mix"], L.apply_norm(cfg, lp["ln"], x),
                             use_kernels), L.residual_spec(cfg))
    fn = L.checkpointed(cfg, fn)
    for i in range(n):
        x = fn(x, L.layer(lps, i))
    return x


def ssm_logits(cfg: ArchConfig, params: dict, tokens,
               last_only: bool = False, use_kernels: bool = True):
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))
    x = mamba_stack(cfg, params["layers"], x, cfg.n_layers, use_kernels)
    x = L.apply_norm(cfg, params["ln_f"], x)
    if last_only:
        x = x[:, -1:]
    return L.logits_out(cfg, params["embed"], x)


def ssm_loss(cfg: ArchConfig, params: dict, batch: dict):
    """Mean next-token cross-entropy on the plain SSD path (the reference's
    `use_pallas=False`, the way its registry trains)."""
    logits = ssm_logits(cfg, params, batch["tokens"], use_kernels=False)
    return L.cross_entropy(logits, batch["labels"], batch.get("mask"))


def ssm_state_shape(cfg: ArchConfig, batch: int, seq: int) -> dict:
    """Decode state: O(1) in seq.  seq is unused but kept in the signature
    so all families share the cache API."""
    s = cfg.ssm
    d_in, n_heads = _dims(cfg)
    dt = L.dtype_of(cfg.compute_dtype)
    gn = s.n_groups * s.d_state
    nl = cfg.n_layers
    T = L.TensorSpec
    return {
        "h": T((nl, batch, n_heads, s.d_state, s.head_dim), dt),
        "conv_x": T((nl, batch, s.d_conv - 1, d_in), dt),
        "conv_b": T((nl, batch, s.d_conv - 1, gn), dt),
        "conv_c": T((nl, batch, s.d_conv - 1, gn), dt),
    }


def ssm_state_spec(cfg: ArchConfig) -> dict:
    """The decode state's heads (and x channels) over `model`."""
    return {"h": P(None, BATCH, "model", None, None),
            "conv_x": P(None, BATCH, None, "model"),
            "conv_b": P(None, BATCH, None, None),
            "conv_c": P(None, BATCH, None, None)}


def ssm_decode_step(cfg: ArchConfig, params: dict, cache: dict, tokens,
                    pos: int):
    """One token per row: (logits [B,1,V], cache), the cache written in
    place.  The recurrent state is position-free, so `pos` is unused."""
    del pos
    x = L.embed(cfg, params["embed"], tokens)
    x = constrain(x, P(BATCH, None, None))
    for i in range(cfg.n_layers):
        x = mamba_layer_decode(cfg, L.layer(params["layers"], i), x, cache, i)
    x = L.apply_norm(cfg, params["ln_f"], x)
    return L.logits_out(cfg, params["embed"], x), cache
