"""The ops layer: one entry per hand-written kernel, dispatched on device.

A CUDA tensor launches the kernel (csrc/*.cu through the wrappers in this
package) or raises; a CPU tensor takes the kernel's plain version in
kernels/ref.py.  There is no fallback from a failed launch and no switch
that sends CUDA tensors to the plain versions.

Each kernel keeps a launch count, added to by its wrapper at the launch and
nowhere else; `launch_counts()` / `reset_launch_counts()` read and clear
them, so a run can show which kernels its path went through.  An active
telemetry session is told which way each call went (`plain_kernels` of its
run records).

No kernel has a backward: each writes its output into a fresh tensor, so
an output carries no autograd history.  Every entry therefore refuses, on
every device, to run with grad mode on when an input requires grad (the
CPU's plain versions refuse too, so a CPU test finds a training path that
reaches a kernel).  Training takes the models' plain path
(`use_kernels=False`, as `Model.loss` does); serving runs under
`torch.no_grad()` (`Model.prefill`, `Model.decode_step`).
"""
from __future__ import annotations

import functools

import torch

from ..core import telemetry
from . import build, ref
from . import first_fit as _first_fit
from . import flash_attn as _flash_attn
from . import fused_step as _fused_step
from . import host_sum as _host_sum
from . import power_carbon as _power_carbon
from . import ssd_chunk as _ssd_chunk

launch_counts = build.launch_counts
reset_launch_counts = build.reset_launch_counts
KERNELS = build.KERNELS


def _refuse_autograd(name: str, *tensors) -> None:
    """Raise when grad mode is on and one of `tensors` requires grad: the
    kernel's output would silently drop that input's gradient."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"ops.{name}: an input requires grad, and the kernel (and its "
            "plain version here) has no backward; train through the models' "
            "plain path (use_kernels=False, as Model.loss does), or call "
            "under torch.no_grad()")


def _abstract(x) -> bool:
    """A fake or meta tensor: a program traced for its shapes and counts
    (launch/op_analysis.py), with no values to compute on."""
    from torch._subclasses.fake_tensor import is_fake
    return x.device.type == "meta" or is_fake(x)


def host_power(cpu_util, gpu_util, n_gpus, on, cpu_cfg, gpu_cfg):
    """(power_kw[H], it_kw): per-host power and its sum (kernel 1, without
    the carbon tail)."""
    _refuse_autograd("host_power", cpu_util, gpu_util, n_gpus, on)
    telemetry.note_plain_kernels(not cpu_util.is_cuda)
    if cpu_util.is_cuda:
        p, it, _ = _power_carbon.fused_power_carbon(
            cpu_util, gpu_util, n_gpus, on, None, 0.0, cpu_cfg, gpu_cfg)
        return p, it
    p, it, _ = ref.fused_power_carbon(cpu_util, gpu_util, n_gpus, on, None,
                                      0.0, cpu_cfg, gpu_cfg)
    return p, it


def fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h, cpu_cfg,
                       gpu_cfg):
    """(power_kw, it_kw, op_carbon_kg) in one pass."""
    _refuse_autograd("fused_power_carbon", cpu_util, gpu_util, n_gpus, on,
                     ci)
    telemetry.note_plain_kernels(not cpu_util.is_cuda)
    impl = _power_carbon if cpu_util.is_cuda else ref
    return impl.fused_power_carbon(cpu_util, gpu_util, n_gpus, on, ci, dt_h,
                                   cpu_cfg, gpu_cfg)


def facility_power(cpu_util, gpu_util, n_gpus, on, wet_bulb_c, setpoint_c,
                   cpu_cfg, gpu_cfg, cooling_cfg):
    """(power_kw, it_kw, cooling_kw, water_l_per_h) in one pass: the power
    block, the host-axis sum and the cooling model of core/thermal.py."""
    _refuse_autograd("facility_power", cpu_util, gpu_util, n_gpus, on,
                     wet_bulb_c, setpoint_c)
    telemetry.note_plain_kernels(not cpu_util.is_cuda)
    impl = _power_carbon if cpu_util.is_cuda else ref
    return impl.fused_facility_power(cpu_util, gpu_util, n_gpus, on,
                                     wet_bulb_c, setpoint_c, cpu_cfg,
                                     gpu_cfg, cooling_cfg)


def first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus):
    """Greedy first-fit of K candidates onto H hosts:
    (assign i32[K], free cores, free GPUs)."""
    _refuse_autograd("first_fit_place", cand_cores, cand_gpus, free_cores,
                     free_gpus)
    if _abstract(cand_cores):
        # a traced program's placement: the outputs' shapes and types only
        # (the placement depends on the values, which fake tensors lack)
        return (torch.full(cand_cores.shape, -1, dtype=torch.int32,
                           device=cand_cores.device),
                free_cores.clone(), free_gpus.clone())
    telemetry.note_plain_kernels(not cand_cores.is_cuda)
    impl = _first_fit if cand_cores.is_cuda else ref
    return impl.first_fit_place(cand_cores, cand_gpus, free_cores, free_gpus)


def fused_facility_totals(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                          pv_cf, batt_threshold, ci_rising, cfg, **kwargs):
    """The megakernel's facility half over the whole horizon, reduced to
    the totals dict of `engine.facility_totals_from_flows`."""
    _refuse_autograd("fused_facility_totals", it_kw, ci, wet_bulb_c, price,
                     price_lo, price_hi, pv_cf, batt_threshold, ci_rising,
                     *kwargs.values())
    telemetry.note_plain_kernels(not it_kw.is_cuda)
    impl = _fused_step if it_kw.is_cuda else ref
    return impl.fused_facility_totals(it_kw, ci, wet_bulb_c, price, price_lo,
                                      price_hi, pv_cf, batt_threshold,
                                      ci_rising, cfg, **kwargs)


def fused_facility_chain(it_kw, ci, wet_bulb_c, price, price_lo, price_hi,
                         pv_cf, batt_threshold, ci_rising, cfg, **kwargs):
    """The facility half with its per-step series: (flows, totals), the
    dict of `ref.fused_facility_chain` (the traces read through
    `trace_store`) and the totals of `fused_facility_totals`.  On the card
    one launch of kernel 3's series route writes both; its totals are the
    totals route's bits."""
    _refuse_autograd("fused_facility_chain", it_kw, ci, wet_bulb_c, price,
                     price_lo, price_hi, pv_cf, batt_threshold, ci_rising,
                     *kwargs.values())
    telemetry.note_plain_kernels(not it_kw.is_cuda)
    impl = _fused_step if it_kw.is_cuda else ref
    return impl.fused_facility_series(it_kw, ci, wet_bulb_c, price, price_lo,
                                      price_hi, pv_cf, batt_threshold,
                                      ci_rising, cfg, **kwargs)


def per_host_sum(status, host, a0, a1, h: int, w0=None, w1=None) -> tuple:
    """Per-host sums of the task table's value columns a0 and a1 (times the
    weight columns w0 / w1 where given, the product rounded to f32) over
    the tasks with `status == RUNNING` and `host >= 0`, in the bin
    `min(host, h - 1)`; each host's values added in task order.  Columns
    [T], [1, T] or [B, T]: ([..., h], [..., h]) f32."""
    _refuse_autograd("per_host_sum", status, host, a0, a1, w0, w1)
    telemetry.note_plain_kernels(not status.is_cuda)
    impl = _host_sum if status.is_cuda else ref
    return impl.per_host_sum(status, host, a0, a1, h, w0, w1)


def ssd_intra_chunk(xdt, da, b, c):
    """Mamba-2 SSD intra-chunk quadratic form: xdt [B,C,Q,H,P], da
    [B,C,H,Q], b / c [B,C,Q,G,N] (H % G == 0) -> y f32 [B,C,Q,H,P]."""
    _refuse_autograd("ssd_intra_chunk", xdt, da, b, c)
    telemetry.note_plain_kernels(not xdt.is_cuda)
    impl = _ssd_chunk if xdt.is_cuda else ref
    return impl.ssd_intra_chunk(xdt, da, b, c)


def flash_attention(q, k, v, *, scale: float, causal: bool = True):
    """Online-softmax attention: q [B,Sq,H,D], k / v [B,Sk,KV,D] -> like q
    (causal mask top-left aligned, f32 accumulation).  DTensors (a model on
    a mesh) run the kernel on each rank's shards: the batch and the heads
    split as the inputs are (a GQA group never split across ranks), the
    sequence whole (`ctx.attention_layout`)."""
    if type(q).__name__ == "DTensor":
        from ..distributed.ctx import on_attention_shards
        return on_attention_shards(functools.partial(
            flash_attention, scale=scale, causal=causal), q, k, v)
    _refuse_autograd("flash_attention", q, k, v)
    telemetry.note_plain_kernels(not q.is_cuda)
    impl = _flash_attn if q.is_cuda else ref
    return impl.flash_attention(q, k, v, scale=scale, causal=causal)
