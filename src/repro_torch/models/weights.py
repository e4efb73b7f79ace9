"""Carry parameters across: the reference's parameter tree, as numpy,
into the port's tree of tensors.

The reference's trees are nested dicts and lists of arrays;
``jax.tree.map(np.asarray, params)`` gives the numpy form this module
takes. bf16 arrays come out of JAX as ``ml_dtypes.bfloat16`` arrays,
which ``torch.from_numpy`` rejects: they are carried as their uint16 bit
patterns and viewed as ``torch.bfloat16``, so every value crosses bit
for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device


def _tensor_from_numpy(a, device) -> torch.Tensor:
    """One array (copied) as a tensor on ``device``; bf16 bit for bit."""
    a = np.array(a, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device=None):
    """The reference's parameter tree (numpy leaves) as the port's tree:
    same dict keys and list order, tensors on ``device`` (default
    ``"cuda"``)."""
    dev = resolve_device(device)

    def carry(node):
        if isinstance(node, dict):
            return {k: carry(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(carry(v) for v in node)
        return _tensor_from_numpy(node, dev)

    return carry(tree)
