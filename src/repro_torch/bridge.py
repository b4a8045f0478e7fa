"""Bridge from the JAX package's pytrees, already turned into numpy, and
back to numpy for comparisons.

Torch cannot reproduce ``jax.random``, so a test that compares the port
with the JAX package builds the JAX params, converts them to numpy
(``jax.tree.map(np.asarray, params)``) and hands them here. The tree
keeps its structure: dicts stay dicts, the per-slot ``layers`` tuple
stays a tuple, every leaf keeps its shape and dtype, and a JAX
``Quantized(q, scale)`` pair becomes the port's ``Quantized``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.compression import Quantized
from repro_torch.optim.adamw import AdamWState

PyTree = Any


def _is_quantized(tree) -> bool:
    return isinstance(tree, tuple) and getattr(tree, "_fields", None) == Quantized._fields


def _to_torch(tree: PyTree, device: torch.device) -> PyTree:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device) for k, v in tree.items()}
    if _is_quantized(tree):
        return Quantized(*(_to_torch(v, device) for v in tree))
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


def opt_state_from_numpy(state: PyTree, device=None) -> AdamWState:
    """A JAX ``AdamWState(step, m, v)`` (as numpy; m and v trees of f32
    arrays or ``Quantized`` pairs) -> the port's ``AdamWState``."""
    step, m, v = state
    dev = resolve_device(device)
    return AdamWState(step=int(np.asarray(step)), m=_to_torch(m, dev),
                      v=_to_torch(v, dev))


def to_numpy(tree: PyTree) -> PyTree:
    """The port's params or ``AdamWState`` -> the same structure of numpy
    arrays (bf16 as f32), to hold against the JAX trees."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, AdamWState):
        return AdamWState(step=tree.step, m=to_numpy(tree.m), v=to_numpy(tree.v))
    if isinstance(tree, Quantized):
        return Quantized(*(to_numpy(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_numpy(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return tree
