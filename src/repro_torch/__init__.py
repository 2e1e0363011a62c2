"""OpenDC-STEAM in PyTorch: the datacenter simulator on an NVIDIA H100.

The PyTorch port of the reference package `repro` (JAX).  Its entry points
take an explicit `device` and default to "cuda": the card runs the
hand-written Hopper kernels of `repro_torch.kernels`, and the CPU, asked
for with `device="cpu"`, runs their plain versions.

Everything is f32.  Matrix products and convolutions may not drop to TF32:
the port turns both of PyTorch's TF32 switches off here.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .core import (SimConfig, make_host_table, make_task_table,  # noqa: E402
                   simulate, summarize, sweep_grid)
from .workloads import make_workload  # noqa: E402

__all__ = ["SimConfig", "make_host_table", "make_task_table", "make_workload",
           "simulate", "summarize", "sweep_grid"]
