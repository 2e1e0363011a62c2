"""Plain PyTorch versions of the hand-written kernels.

Each function computes what its kernel computes, in eager tensor ops, on
tensors of any device: the CPU path of `kernels/ops.py` runs them, and the
card's smoke test holds each kernel against them on the same inputs.

  fused_power_carbon     <- csrc/power_carbon.cu  steam_power_carbon
  fused_facility_power   <- csrc/power_carbon.cu  steam_facility_power
  first_fit_place        <- csrc/first_fit.cu     steam_first_fit
  fused_facility_chain   <- csrc/fused_step.cu    steam_facility_totals
    (+ engine.facility_totals_from_flows; `fused_facility_totals` below)
  ssd_intra_chunk        <- csrc/ssd_chunk.cu     steam_ssd_intra_chunk
  flash_attention        <- csrc/flash_attn.cu    steam_flash_attention
  ssd_chunk              the sequential SSD recurrence (an oracle, no kernel)

Host inputs are [H] or [B, H] (one scenario per row); the per-row scalars
(carbon intensity, wet-bulb, setpoint) are host numbers, 0-d or [B] tensors.
The facility chain takes [S] or [B, S] series, its per-row parameters host
numbers, 0-d, [B] or [B, 1] tensors.
The model kernels take the layouts of the reference's Pallas wrappers.
The arithmetic is that of the reference package's oracles
(src/repro/kernels/ref.py) and Pallas kernels, term for term in f32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import battery as battery_mod
from ..core import renewables as renewables_mod
from ..core import thermal as thermal_mod
from ..core.power import host_power_kw
from ..core.quant import dequantize_trace, quantize_trace

F32 = torch.float32


def fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h: float,
                       cpu_cfg, gpu_cfg):
    """(power_kw, it_kw, carbon_kg); `ci` None gives carbon 0."""
    p = host_power_kw(cpu_util, gpu_util, n_gpus, on, cpu_cfg, gpu_cfg)
    it = p.sum(-1)
    if ci is None:
        return p, it, torch.zeros_like(it)
    return p, it, it * np.float32(dt_h) * ci / 1000.0


def fused_facility_power(cpu_util, gpu_util, n_gpus, on, wet_bulb_c,
                         setpoint_c, cpu_cfg, gpu_cfg, cooling_cfg):
    """(power_kw, it_kw, cooling_kw, water_l_per_h): the power block, its
    sum, and core/thermal.py's cooling model of that IT total."""
    p = host_power_kw(cpu_util, gpu_util, n_gpus, on, cpu_cfg, gpu_cfg)
    it = p.sum(-1)
    cool, water = thermal_mod.cooling_step(it, wet_bulb_c, cooling_cfg,
                                           setpoint_c=setpoint_c)
    return p, it, cool, water


def first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus):
    """Sequential greedy first-fit: (assign i32, free cores, free GPUs).

    Candidate k takes the lowest-index host whose free cores and GPUs both
    cover it; +inf demand never fits, and neither does a -inf free host.
    Inputs [K] and [H], or [B, K] and [B, H].  Candidates that are inert in
    every row place nothing and change nothing, so the loop skips them."""
    one_d = cand_cores.dim() == 1
    cc, cg, fc, fg = (x.reshape(1, -1) if one_d else x
                      for x in (cand_cores, cand_gpus, free_cores, free_gpus))
    fc, fg = fc.to(F32).clone(), fg.to(F32).clone()  # updated in place below
    cc, cg = cc.to(F32), cg.to(F32)
    b, k = cc.shape
    h = fc.shape[1]
    hidx = torch.arange(h, device=fc.device)
    assign = torch.full((b, k), -1, dtype=torch.int32, device=fc.device)
    live = ~(torch.isposinf(cc) | torch.isposinf(cg)).all(0)
    for i in torch.nonzero(live).reshape(-1).tolist():
        need_c, need_g = cc[:, i:i + 1], cg[:, i:i + 1]
        fits = (fc >= need_c) & (fg >= need_g)
        first = torch.where(fits, hidx, h).amin(1, keepdim=True)
        sel = (hidx == first) & (first < h)
        fc -= torch.where(sel, need_c, 0.0)
        fg -= torch.where(sel, need_g, 0.0)
        assign[:, i] = torch.where(first[:, 0] < h, first[:, 0], -1).to(
            torch.int32)
    if one_d:
        return assign[0], fc[0], fg[0]
    return assign, fc, fg


def _column(x):
    """A per-row parameter given as [B] as the [B, 1] column that meets
    [B, S] series; host numbers, 0-d and [B, 1] tensors as they are."""
    return x[:, None] if isinstance(x, torch.Tensor) and x.dim() == 1 else x


def fused_facility_chain(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                         pv_cf, batt_threshold, ci_rising, dt_h, cfg, *,
                         soc0=0.0, setpoint_c=None, batt_capacity_kwh=None,
                         batt_rate_kw=None, dispatch_lambda=None,
                         pv_capacity_kw=None, chiller_derate=None):
    """The facility pipeline (cooling -> renewables -> battery -> net
    metering) vectorized over the time axis; a dict of f32 flow series plus
    the battery SoC trajectory.  Series are [S], or [B, S] rows (one a
    scenario) with per-row parameters as host numbers, 0-d, [B] or [B, 1]
    tensors.

    Everything but the SoC recurrence is elementwise in t.  The dispatch
    decisions factor out of the recurrence: their only SoC dependence, the
    `charge > 0` discharge guard, is reapplied as `soc > 0` in the loop.
    `chiller_derate` (the f32 [S] or [B, S] facility-failure series of
    core/resilience.py) degrades the cooling model step by step as
    `engine.stage_cooling` does; None is the healthy model bit for bit.
    Keys mirror `engine.EnergyFlow` plus `water_l_per_h`, `heat_reuse_kw`,
    `soc` and `want_charge`."""
    it_kw = it_kw.to(F32)
    zeros = torch.zeros_like(it_kw)
    dt = np.float32(dt_h)
    soc0, setpoint_c, batt_capacity_kwh, batt_rate_kw, dispatch_lambda, \
        pv_capacity_kw = (_column(x) for x in (
            soc0, setpoint_c, batt_capacity_kwh, batt_rate_kw,
            dispatch_lambda, pv_capacity_kw))

    if cfg.cooling.enabled:
        cooling_kw, water_l_per_h = thermal_mod.cooling_step(
            it_kw, wet_bulb_c, cfg.cooling, setpoint_c=setpoint_c,
            chiller_derate=chiller_derate)
        reuse = cfg.cooling.heat_reuse_fraction
        if reuse > 0.0:
            heat_reuse_kw = reuse * thermal_mod.reclaimable_heat_kw(
                it_kw, cooling_kw, wet_bulb_c, cfg.cooling,
                setpoint_c=setpoint_c, chiller_derate=chiller_derate)
            water_l_per_h = water_l_per_h * (1.0 - reuse)
        else:
            heat_reuse_kw = zeros
    else:
        cooling_kw = water_l_per_h = heat_reuse_kw = zeros
    load = it_kw + cooling_kw

    if cfg.renewables.enabled:
        cap_kw = (np.float32(cfg.renewables.pv_capacity_kw)
                  if pv_capacity_kw is None else pv_capacity_kw)
        pv_kw = renewables_mod.pv_power_kw(cap_kw, pv_cf)
        net_load, surplus = renewables_mod.net_load_split(load, pv_kw)
    else:
        pv_kw, net_load, surplus = zeros, load, None

    if cfg.battery.enabled:
        bcfg = cfg.battery
        cap, rate = battery_mod.battery_params(bcfg, batt_capacity_kwh,
                                               batt_rate_kw)
        eff = np.float32(bcfg.round_trip_efficiency)
        wc, wd = battery_mod.dispatch_decision(
            bcfg, torch.ones_like(it_kw), ci, batt_threshold, ci_rising,
            price=price, price_lo=price_lo, price_hi=price_hi,
            dispatch_lambda=dispatch_lambda)
        if surplus is not None:
            wc, wd, charge_cap_kw = battery_mod.surplus_aware_dispatch(
                wc, wd, surplus)
        else:
            charge_cap_kw = torch.full_like(it_kw, float("inf"))
        shape = torch.broadcast_shapes(it_kw.shape, charge_cap_kw.shape,
                                       net_load.shape, wc.shape, wd.shape)
        lead, s = shape[:-1], shape[-1]
        charge_cap_kw, net_load, wc, wd = (x.expand(shape) for x in (
            charge_cap_kw, net_load, wc, wd))
        # filled one step at a time below: fresh buffers nobody else holds
        soc = torch.empty(shape, dtype=F32, device=it_kw.device)
        charge_kw = torch.empty_like(soc)
        discharge_kw = torch.empty_like(soc)
        cur = torch.zeros((*lead, 1), dtype=F32, device=it_kw.device) + soc0
        for j in range(s):
            at = slice(j, j + 1)
            ck = torch.clamp(torch.clamp((cap - cur) / dt, min=0.0), max=rate)
            ck = torch.minimum(ck, charge_cap_kw[..., at])
            ck = torch.where(wc[..., at], ck, 0.0)
            dk = torch.minimum(torch.clamp(cur / dt, max=rate),
                               net_load[..., at])
            dk = torch.where(wd[..., at] & (cur > 0.0) & ~wc[..., at], dk,
                             0.0)
            cur = torch.clamp(torch.clamp(cur + (ck * eff - dk) * dt,
                                          min=0.0), max=cap)
            soc[..., at], charge_kw[..., at], discharge_kw[..., at] = (
                cur, ck, dk)
        want_charge = wc
    else:
        soc = charge_kw = discharge_kw = zeros
        want_charge = torch.zeros_like(it_kw, dtype=torch.bool)

    if cfg.renewables.enabled:
        if cfg.battery.enabled:
            pv_to_batt, export_kw, curtailed_kw = renewables_mod.split_surplus(
                surplus, charge_kw, cfg.renewables)
            grid_import_kw = net_load + (charge_kw - pv_to_batt) - discharge_kw
        else:
            _, export_kw, curtailed_kw = renewables_mod.split_surplus(
                surplus, zeros, cfg.renewables)
            grid_import_kw = net_load
    else:
        export_kw = curtailed_kw = zeros
        grid_import_kw = load + charge_kw - discharge_kw

    return {"it_kw": it_kw, "cooling_kw": cooling_kw, "pv_kw": pv_kw,
            "batt_charge_kw": charge_kw, "batt_discharge_kw": discharge_kw,
            "grid_import_kw": grid_import_kw, "grid_export_kw": export_kw,
            "curtailed_kw": curtailed_kw, "water_l_per_h": water_l_per_h,
            "heat_reuse_kw": heat_reuse_kw, "soc": soc,
            "want_charge": want_charge}


def stored_trace(x, store: str):
    """The f32 trace the kernel reads from a `store` ('f32', 'bf16' or
    'int8') payload: `x` itself, or its dequantized quantization."""
    if store == "f32":
        return x.to(F32)
    return dequantize_trace(quantize_trace(x, store))


def fused_facility_totals(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                          pv_cf, batt_threshold, ci_rising, cfg, *,
                          trace_store: str = "f32", **chain_kwargs):
    """The totals dict of `engine.facility_totals_from_flows` over the
    chain above, with the four exogenous traces read through `trace_store`
    as the kernel reads them."""
    from ..core.engine import facility_totals_from_flows  # engine imports ops
    ci, wet_bulb_c, price, pv_cf = (stored_trace(x, trace_store)
                                    for x in (ci, wet_bulb_c, price, pv_cf))
    flows = fused_facility_chain(it_kw, ci, wet_bulb_c, price, price_lo,
                                 price_hi, pv_cf, batt_threshold, ci_rising,
                                 cfg.dt_h, cfg, **chain_kwargs)
    return facility_totals_from_flows(flows, ci, price, cfg)


# ---------------------------------------------------------------------------
# the model substrate's kernels: SSD intra-chunk and flash attention
# ---------------------------------------------------------------------------

def segsum(a):
    """a [..., Q] -> [..., Q, Q]: sums of a over (k, q] on and below the
    diagonal (cum[q] - cum[k]), -inf above it."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_intra_chunk(xdt, da, b, c):
    """y[q, p] = sum_{k <= q} exp(cum[q] - cum[k]) (C_q . B_k) xdt[k, p] per
    (batch, chunk, head), in the segsum form of the reference's
    `ssm.ssd_scan`.  xdt [B,C,Q,H,P], da [B,C,H,Q], b / c [B,C,Q,G,N]
    with H % G == 0 -> y f32 [B,C,Q,H,P]."""
    h, g = xdt.shape[3], b.shape[3]
    bh = b.to(F32).repeat_interleave(h // g, dim=3)
    ch = c.to(F32).repeat_interleave(h // g, dim=3)
    decay = torch.exp(segsum(da.to(F32)))                    # [b,c,h,q,k]
    cb = torch.einsum("bcqhs,bckhs->bchqk", ch, bh)
    return torch.einsum("bchqk,bckhp->bcqhp", cb * decay, xdt.to(F32))


def flash_attention(q, k, v, *, scale: float, causal: bool = True):
    """Attention with the kernel's conventions: q [B,Sq,H,D], k / v
    [B,Sk,KV,D], query head h on kv head h // (H // KV), causal mask top-left
    aligned (column <= row), masked scores -1e30, softmax and the product
    with v in f32, output in q's type."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    qg = q.to(F32).reshape(b, sq, kvh, h // kvh, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(F32)) * scale
    if causal:
        rows = torch.arange(sq, device=q.device)[:, None]
        mask = torch.arange(sk, device=q.device)[None, :] <= rows
        logits = torch.where(mask, logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(F32))
    return out.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def ssd_chunk(x, dt, a, b, c):
    """Mamba-2 SSD as the exact sequential state-space recurrence (the
    reference's oracle `kernels/ref.ssd_chunk`).

    x f32[T, H, P], dt f32[T, H] (> 0), a f32[H] (< 0), b / c f32[T, G, N]
    (G groups over H heads) -> y f32[T, H, P] with y_t = C_t^T h_t,
    h_t = exp(dt_t a) h_{t-1} + dt_t B_t x_t^T per head (state [N, P])."""
    t, h, p = x.shape
    rep = h // b.shape[1]
    bh = b.repeat_interleave(rep, dim=1)                     # [T, H, N]
    ch = c.repeat_interleave(rep, dim=1)
    state = torch.zeros((h, b.shape[2], p), dtype=F32, device=x.device)
    ys = []
    for i in range(t):
        decay = torch.exp(dt[i] * a)[:, None, None]
        upd = (dt[i][:, None] * bh[i])[..., None] * x[i][:, None, :]
        state = state * decay + upd
        ys.append(torch.einsum("hn,hnp->hp", ch[i], state))
    return torch.stack(ys)
