"""Process groups, meshes and the card's roofline constants.

The port of the reference's `launch/mesh.py`.  A mesh is a
`torch.distributed.device_mesh.DeviceMesh` with `mesh_dim_names`, built by
`init_device_mesh` over the default process group.  Functions only: no
process-group state is touched when this module is imported.

Single pod: (16, 16) = 256 cards, axes ("data", "model").
Multi-pod:  (2, 16, 16) = 512 cards, axes ("pod", "data", "model"); the
`pod` axis is pure data parallelism whose gradient all-reduce crosses the
hosts' network.

`init_distributed` makes the default process group: from torchrun's
`RANK` / `WORLD_SIZE` / `LOCAL_RANK` when they are set, else a world of
one on a `file://` store; NCCL for "cuda", gloo for "cpu", and the
`fake` backend (no communication, any world size) for a dry run.
"""
from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist

# NVIDIA H100 SXM5 80 GB (NVIDIA H100 Tensor Core GPU data sheet): the
# roofline's denominators, per card
PEAK_FLOPS_BF16 = 989e12        # dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12                # HBM3 bytes/s
NVLINK_BW = 450e9               # NVLink 4 bytes/s each way (900 GB/s total)
# an axis that crosses hosts: one 400 Gb/s NDR InfiniBand adapter a card,
# as in the DGX H100 (8 ConnectX-7 ports for 8 cards)
NETWORK_BW = 50e9               # bytes/s a card
CARDS_PER_HOST = 8


def axis_bandwidth(n_cards: int) -> float:
    """Bytes/s a card for a collective over `n_cards` cards: NVLink inside
    one 8-card host, the network beyond it."""
    return NVLINK_BW if n_cards <= CARDS_PER_HOST else NETWORK_BW


def _backend(device_type: str) -> str:
    return {"cuda": "nccl", "cpu": "gloo"}[device_type]


def init_distributed(device_type: str = "cuda", *, world_size: int | None =
                     None, rank: int = 0, fake: bool = False,
                     store_dir: str | None = None, timeout_s: float = 600.0):
    """Make the default process group (once) and return (rank, world size).

    Under torchrun (`RANK`, `WORLD_SIZE`, `LOCAL_RANK` set) the group
    rendezvouses through its `env://` store and, on "cuda", each process
    takes card `LOCAL_RANK`.  Otherwise a world of `world_size` (default 1)
    at `rank` meets on a `file://` store in `store_dir` (a fresh temporary
    directory by default).  `fake=True` makes the `fake` backend's world
    of `world_size`: no communication, every collective a no-op, for
    tracing a program at the mesh's shapes (launch/dryrun.py)."""
    import datetime
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    timeout = datetime.timedelta(seconds=timeout_s)
    if fake:
        # the fake backend's store lives in PyTorch's testing package: this
        # is the one place that imports it
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world_size or 1)
        return rank, world_size or 1
    backend = _backend(device_type)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        if device_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(backend, init_method="env://",
                                timeout=timeout)
        return dist.get_rank(), dist.get_world_size()
    if device_type == "cuda":
        torch.cuda.set_device(rank % max(torch.cuda.device_count(), 1))
    store_dir = store_dir or tempfile.mkdtemp(prefix="steam_pg_")
    os.makedirs(store_dir, exist_ok=True)
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(store_dir, "store"),
        rank=rank, world_size=world_size or 1, timeout=timeout)
    return rank, world_size or 1


def shutdown():
    """Destroy the default process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def _mesh(shape, names, device_type: str):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with `multi_pod`, over the default process group."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"), device_type)
    return _mesh((16, 16), ("data", "model"), device_type)


def make_test_mesh(data: int = 2, model: int = 2, pod: int = 1, *,
                   device_type: str = "cuda"):
    """A small mesh over the default process group (whose world size must
    be the mesh's size)."""
    if pod > 1:
        return _mesh((pod, data, model), ("pod", "data", "model"),
                     device_type)
    return _mesh((data, model), ("data", "model"), device_type)


def make_mesh(shape, names, *, device_type: str = "cuda"):
    """A mesh of any shape and axis names over the default process group."""
    return _mesh(shape, tuple(names), device_type)
