"""Attention, the counterpart of ``repro/models/attention.py``.

- ``attention_ref``    : quadratic reference (the plain version of K1).
- ``decode_attention`` : one-token attention against a KV cache, with a
  scalar or per-row ``(B,)`` cache length (the plain version of K2).
- ``attention`` / ``decode`` : dispatch between those and the CUDA
  kernels. ``impl="auto"`` takes the kernel for CUDA tensors at every
  length and the plain version for CPU tensors; ``"ref"`` always takes
  the plain version.

Shapes: q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd); GQA via Hq % Hkv == 0.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import use_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import NEG_INF, attention_ref

__all__ = ["NEG_INF", "attention_ref", "decode_attention", "attention", "decode"]


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, impl: str = "auto"):
    """Self-attention for train / prefill: q (B,S,Hq,hd), k/v (B,S,Hkv,hd)."""
    if use_kernel(impl, q):
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap)


def decode(q, k_cache, v_cache, cache_len, *, window: Optional[int] = None,
           softcap: Optional[float] = None, impl: str = "auto"):
    """One-token attention: q (B,1,Hq,hd), caches (B,S,Hkv,hd), cache_len
    scalar or (B,). Returns the cache dtype."""
    if use_kernel(impl, q):
        return decode_attention_kernel(q, k_cache, v_cache, cache_len,
                                       window=window, softcap=softcap)
    return decode_attention(q, k_cache, v_cache, cache_len, window=window,
                            softcap=softcap)
