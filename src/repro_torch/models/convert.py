"""Parameter trees carried between the reference package and the port.

The reference keeps parameters as a nested dict of arrays; the port keeps
the same nested dict, leaf for leaf with the same shapes and stacked layer
axes, of torch tensors.  `params_from_numpy` takes the reference's tree
with its leaves as numpy arrays (`jax.tree.map(np.asarray, params)`) and
`params_to_numpy` gives one back, so one set of weights runs through both
packages.  A bf16 leaf crosses as the raw bits: a numpy array of the
`bfloat16` dtype that JAX hands out is read through its uint16 view, and
`params_to_numpy` returns a bf16 tensor as that uint16 view (numpy has no
bf16 type of its own).
"""
from __future__ import annotations

import numpy as np
import torch

from .layers import tree_map


def _to_tensor(a, device) -> torch.Tensor:
    a = np.array(a, order="C")  # a writable copy: JAX's arrays are read-only
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def params_from_numpy(tree: dict, device="cuda") -> dict:
    """The reference's parameter tree (numpy leaves) as the port's tensors
    on `device`, same nesting, shapes and types."""
    return tree_map(lambda a: _to_tensor(a, device), tree)


def params_to_numpy(params: dict) -> dict:
    """The port's parameter tree as numpy arrays (bf16 as uint16 bits)."""
    return tree_map(_to_numpy, params)
