"""Wrapper of the CUDA flash-attention kernel (``csrc/flash_attention.cu``)
in the model zoo's (B,S,H,hd) layout.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.attention_ref``). ``flash_attention.launches`` counts the
launches of the kernel.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, window, softcap):
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_attention: q, k, v must lie on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share a dtype of "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: want q (B,S,Hq,hd) and k, v "
                         f"(B,S,Hkv,hd), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, s, hq, d = q.shape
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d:
        raise ValueError("flash_attention: self-attention needs k, v of q's "
                         "batch, length and head dim")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"flash_attention: {hq} q heads do not group over "
                         f"{k.shape[2]} kv heads")
    if d > MAX_HEAD_DIM or d % 4:
        raise ValueError(f"flash_attention: head dim {d} must be a multiple "
                         f"of 4 and at most {MAX_HEAD_DIM}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous "
                             "and 16-byte aligned")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got {window}")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"flash_attention: softcap must be positive, got {softcap}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B,S,Hq,hd); k/v (B,S,Hkv,hd) -> (B,S,Hq,hd) in q.dtype; ``scale``
    the scores' factor, 1/sqrt(hd) where None."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, scale=scale).to(q.dtype)
    _check(q, k, v, window, softcap)
    refuse_grad("flash_attention", q, k, v)
    if q.device.index != torch.cuda.current_device():    # launch from q's device
        with torch.cuda.device(q.device):
            return flash_attention(q, k, v, causal=causal, window=window, softcap=softcap,
                                   scale=scale)
    b, s, hq, d = q.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    # the raw handle: torch.cuda.current_stream(...).cuda_stream builds a
    # Stream object, and a torch.cuda.device block costs as much again:
    # several us of host time each, on every layer of a prefill
    stream = torch._C._cuda_getCurrentRawStream(q.device.index)
    err = _build.library("flash_attention").fa_forward(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), DTYPES[q.dtype], b, s, hq,
        k.shape[2], d, int(causal), window or 0, 1.0 / (d ** 0.5) if scale is None else scale,
        softcap or 0.0, stream)
    _build.check(err, "flash_attention launch")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
