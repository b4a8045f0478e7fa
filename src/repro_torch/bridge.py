"""Bridge from the JAX package's pytrees, already turned into numpy.

Torch cannot reproduce ``jax.random``, so a test that compares the port
with the JAX package builds the JAX params, converts them to numpy
(``jax.tree.map(np.asarray, params)``) and hands them here. The tree
keeps its structure: dicts stay dicts, the per-slot ``layers`` tuple
stays a tuple, every leaf keeps its shape and dtype.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device

PyTree = Any


def _to_torch(tree: PyTree, device: torch.device) -> PyTree:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_to_torch(v, device) for v in tree)
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":      # ml_dtypes' bf16: no numpy twin
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr)).to(device)     # a writable copy


def params_from_numpy(tree: PyTree, device=None) -> PyTree:
    """The JAX ``init_params`` tree (as numpy) -> the port's params."""
    return _to_torch(tree, resolve_device(device))


def cache_from_numpy(tree: PyTree, device=None) -> PyTree:
    """The JAX ``init_cache`` tree (as numpy): a tuple of per-slot
    ``{"k","v"}`` of shape ``(G,B,max_len,Hkv,hd)`` for attention, or
    ``{"h","conv_x","conv_b","conv_c"}`` for SSM layers."""
    return _to_torch(tree, resolve_device(device))
