"""Numerics policy knobs, the counterpart of ``repro/models/precision.py``.

``bf16_collectives()``: every tensor-parallel boundary product emits
bf16 (``matmul_dtype``), and ``layers.row_parallel`` sums its partial
products over the ``model`` axis explicitly, once, in f32, and rounds
the sum to bf16 (what XLA on the CPU makes of JAX's bf16 psum).
"""
from __future__ import annotations

import contextlib

import torch

_BF16_COLLECTIVES = False


@contextlib.contextmanager
def bf16_collectives(enabled: bool = True):
    global _BF16_COLLECTIVES
    prev = _BF16_COLLECTIVES
    _BF16_COLLECTIVES = enabled
    try:
        yield
    finally:
        _BF16_COLLECTIVES = prev


def matmul_dtype():
    """The output dtype of tensor-parallel boundary products (None = the
    inputs')."""
    return torch.bfloat16 if _BF16_COLLECTIVES else None


def enabled() -> bool:
    return _BF16_COLLECTIVES
