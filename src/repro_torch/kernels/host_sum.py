"""Launch wrapper of the per-host sum kernel (csrc/host_sum.cu).

The scheduler's per-host sums on the card, straight from the task table's
columns (`scheduler.free_capacity`: used cores and GPUs;
`scheduler.host_utilization`: cores and GPUs weighted by utilization):
each host's running tasks added in task order, so a run gives the same bits
every time and the CPU's (`ref.per_host_sum`, whose `scatter_add_` adds in
task order there).  The port's own kernel: the reference has no Pallas
kernel here (it calls `jax.ops.segment_sum`).  CUDA tensors only
(kernels/ops.py routes CPU tensors to kernels/ref.py).

The columns go to the kernel as the table holds them: status and host
int32, values f32, each [T] or [B, T] with unit stride along T; a [T] or
[1, T] column, and a [B, T] view of one row, pass with row stride 0, never
expanded or copied.  A launch takes a workspace (PyTorch's caching
allocator) laid out by the kernel's library (`workspace_bytes`: 16 bytes a
(row, task) slot, T rounded up to a tile, and each tile's bucket starts),
and one ticket counter a row, kept per device and left at 0 by the kernel;
launches on one device share the counters, so they run in stream order
(PyTorch's current stream).
"""
from __future__ import annotations

import ctypes

import torch

from ..core.state import RUNNING
from . import build

# the accumulators live in registers and `out`, not in shared memory:
# any int32 host count
MAX_HOSTS = 2 ** 31 - 1
MAX_ROWS = 65535                   # the grid's y extent

_ARGS = [*[ctypes.c_void_p] * 6, *[ctypes.c_longlong] * 6,
         *[ctypes.c_int] * 4, ctypes.c_void_p, ctypes.c_longlong,
         *[ctypes.c_void_p] * 4]


def workspace_bytes(b: int, t: int) -> int:
    """Bytes of a launch's workspace at b rows of t tasks, as the kernel
    lays it out (csrc: steam_host_sum_workspace_bytes)."""
    return build.function("host_sum", "steam_host_sum_workspace_bytes",
                          [ctypes.c_int] * 2, ctypes.c_longlong)(b, t)


def blocks_per_sm() -> int:
    """Blocks of the kernel an SM holds at once, as compiled and launched
    (the CUDA occupancy calculator); 0 on an error."""
    return build.function("host_sum", "steam_host_sum_blocks_per_sm", [])()


_tickets: dict = {}


def _tickets_for(device, b: int):
    """The device's ticket counters, at least b of them, all 0 between
    launches (a new, larger buffer replaces a short one in stream order)."""
    t = _tickets.get(device)
    if t is None or t.numel() < b:
        t = torch.zeros(max(b, 64), dtype=torch.int32, device=device)
        _tickets[device] = t
    return t


def _row_stride(x) -> int:
    return x.stride(0) if x.dim() == 2 and x.shape[0] > 1 else 0


def per_host_sum(status, host, a0, a1, h: int, w0=None, w1=None) -> tuple:
    """(sums of a0 [* w0], sums of a1 [* w1]), each [..., h] f32, over the
    running tasks of each host, from one launch."""
    cols = [x for x in (status, host, a0, a1, w0, w1) if x is not None]
    build.require_cuda("per_host_sum", *cols)
    if status.dtype != torch.int32 or host.dtype != torch.int32:
        raise ValueError(f"per_host_sum: status and host must be int32, got "
                         f"{status.dtype} and {host.dtype}")
    if any(x.dtype != torch.float32 for x in cols[2:]):
        raise ValueError("per_host_sum: value and weight columns must be "
                         "float32")
    t = status.shape[-1]
    rows = {x.shape[0] for x in cols if x.dim() == 2} - {1}
    if (any(x.dim() not in (1, 2) or x.shape[-1] != t for x in cols)
            or len(rows) > 1):
        raise ValueError(
            "per_host_sum: columns [T] or [B, T] of one T and one B, got "
            + ", ".join(str(tuple(x.shape)) for x in cols))
    if not 1 <= h <= MAX_HOSTS:
        raise ValueError(f"per_host_sum: 1 to {MAX_HOSTS} hosts, got {h}")
    b = rows.pop() if rows else 1
    if b > MAX_ROWS:
        raise ValueError(f"per_host_sum: at most {MAX_ROWS} rows, got {b}")
    status, host, a0, a1, w0, w1 = (
        x if x is None or x.stride(-1) == 1 or t <= 1 else x.contiguous()
        for x in (status, host, a0, a1, w0, w1))
    lead = (b,) if any(x.dim() == 2 for x in cols) else ()
    dev = status.device
    out = torch.empty((2, *lead, h), dtype=torch.float32, device=dev)
    ws = torch.empty(-(-workspace_bytes(b, t) // 4), dtype=torch.int32,
                     device=dev)
    fn = build.function("host_sum", "steam_host_sum", _ARGS)
    code = fn(*(None if x is None else x.data_ptr()
                for x in (status, host, a0, a1, w0, w1)),
              *(0 if x is None else _row_stride(x)
                for x in (status, host, a0, a1, w0, w1)),
              b, t, h, RUNNING, ws.data_ptr(), 4 * ws.numel(),
              _tickets_for(dev, b).data_ptr(), out.data_ptr(),
              out.data_ptr() + 4 * b * h, build.stream_of(status))
    build.check("host_sum", "per_host_sum launch", code)
    build.count_launch("per_host_sum")
    return out[0], out[1]
