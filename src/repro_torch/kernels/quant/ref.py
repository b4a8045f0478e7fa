"""Plain PyTorch versions of the int8 blockwise quantization kernels,
mirroring ``repro/kernels/quant/ref.py``."""
from __future__ import annotations

import math

import torch


def quantize_ref(x: torch.Tensor):
    """x (nblk, blk) f32/bf16 -> (q int8 (nblk, blk), scale f32 (nblk, 1)).

    ``scale = max|x| / 127 + 1e-30`` per row and ``q = clip(round(x /
    scale), ±127)``: true divisions, and ``torch.round`` rounds half to
    even, as ``jnp.round`` does. The 127 is a tensor on x's device: on a
    CUDA tensor, torch divides by a Python number as a multiply by its
    reciprocal, which rounds differently from jnp's division."""
    xf = x.float()
    d127 = torch.tensor(127.0, device=xf.device)
    scale = xf.abs().amax(dim=1, keepdim=True) / d127 + 1e-30
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``q * scale`` in f32, then rounded to ``dtype``."""
    return (q.float() * scale).to(dtype)


def quantize_flat_ref(x: torch.Tensor, block: int = 256):
    """Any-shape x -> (q (nblk, block) int8, scale (nblk,) f32): x
    flattened, zero-padded to whole blocks and quantized by
    ``quantize_ref`` (``repro/core/compression.py:69-77``)."""
    flat = x.reshape(-1).float()
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    q, scale = quantize_ref(flat.view(-1, block))
    return q, scale[:, 0]


def dequantize_flat_ref(q: torch.Tensor, scale: torch.Tensor, shape,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The first prod(shape) values of ``q * scale`` (scale (nblk,)) as
    ``shape`` in ``dtype`` (``repro/core/compression.py:80-85``)."""
    n = math.prod(shape)
    return dequantize_ref(q, scale[:, None], dtype).reshape(-1)[:n].reshape(shape)
