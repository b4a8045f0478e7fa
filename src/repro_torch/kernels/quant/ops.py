"""Wrappers of the CUDA int8 blockwise quantization kernels
(``csrc/quant.cu``): ``quantize`` (K4a) and ``dequantize`` (K4b).

``quantize`` flattens a tensor of any shape into blocks of ``block``
values, the tail past its size read as zeros, and returns (q (nblk,
block) int8, scale (nblk,) f32); ``dequantize`` returns the first
``prod(shape)`` values of ``q * scale`` as ``shape`` in f32 or bf16. The
kernels take f32 or bf16 input and blocks of 256 values (the AdamW
block: 32 lanes of a warp, 8 values each); the plain versions take any
block.

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.py``: ``quantize_flat_ref``, ``dequantize_flat_ref``). ``quantize.launches`` and ``dequantize.launches``
count the launches of the kernels.

``quantize_int8`` and ``dequantize_int8`` are the JAX package's names and
signatures (``repro/kernels/quant/ops.py``), with its scale of shape
(nblk, 1); they call ``quantize`` and ``dequantize``.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.quant.ref import dequantize_flat_ref, quantize_flat_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
BLOCK = 256                       # the kernels' block


def _check_block(block: int, cuda: bool) -> None:
    if block <= 0:
        raise ValueError(f"quant: block must be positive, got {block}")
    if cuda and block != BLOCK:
        raise ValueError(f"quant: the CUDA kernels take blocks of {BLOCK} "
                         f"values, got {block}")


def _check_tensor(name: str, t: torch.Tensor) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"quant: {name} must be contiguous and 16-byte aligned")


def quantize(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape x (f32 or bf16) -> (q (nblk, block) int8, scale (nblk,) f32)."""
    _check_block(block, x.is_cuda)
    if x.device.type == "cpu":
        return quantize_flat_ref(x, block)
    if not x.is_cuda or x.dtype not in DTYPES:
        raise TypeError(f"quantize: want a CUDA tensor of float32 or bfloat16, "
                        f"got {x.dtype} on {x.device}")
    _check_tensor("x", x)
    refuse_grad("quantize", x)
    n = x.numel()
    nblk = -(-n // block)
    q = torch.empty((nblk, block), dtype=torch.int8, device=x.device)
    scale = torch.empty((nblk,), dtype=torch.float32, device=x.device)
    if n == 0:
        return q, scale
    lib = _build.library("quant")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.quant_quantize(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                                 DTYPES[x.dtype], n, nblk, stream)
    _build.check(err, "quantize launch")
    quantize.launches += 1
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (nblk, block) int8, scale (nblk,) f32 -> the first prod(shape)
    values of ``q * scale`` as ``shape`` in ``dtype``."""
    shape = tuple(int(d) for d in shape)
    n = math.prod(shape)
    if q.dim() != 2 or scale.shape != (q.shape[0],):
        raise ValueError(f"dequantize: want q (nblk, block) and scale (nblk,), "
                         f"got {tuple(q.shape)}, {tuple(scale.shape)}")
    if n > q.numel():
        raise ValueError(f"dequantize: shape {shape} holds more than the "
                         f"{q.numel()} quantized values")
    _check_block(q.shape[1], q.is_cuda)
    if q.device.type == "cpu":
        return dequantize_flat_ref(q, scale, shape, dtype)
    if q.dtype != torch.int8 or scale.dtype != torch.float32 \
            or scale.device != q.device or dtype not in DTYPES:
        raise TypeError(f"dequantize: want int8 q and f32 scale on one CUDA "
                        f"device and a float32 or bfloat16 result, got "
                        f"{q.dtype}, {scale.dtype} on {scale.device}, {dtype}")
    _check_tensor("q", q)
    if not scale.is_contiguous():
        raise ValueError("dequantize: scale must be contiguous")
    out = torch.empty(shape, dtype=dtype, device=q.device)
    if n == 0:
        return out
    lib = _build.library("quant")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.quant_dequantize(q.data_ptr(), scale.data_ptr(), out.data_ptr(),
                                   DTYPES[dtype], n, stream)
    _build.check(err, "dequantize launch")
    dequantize.launches += 1
    return out


def quantize_int8(x: torch.Tensor, block: int = 256) -> Tuple[torch.Tensor, torch.Tensor]:
    """Any-shape x -> (q (nblk, block) int8, scale (nblk, 1) f32): x read
    as f32 (bf16 as it is: widening is exact), as the JAX function casts."""
    q, scale = quantize(x if x.dtype in DTYPES else x.float(), block)
    return q, scale[:, None]


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor, shape: Sequence[int],
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """q (nblk, block) int8, scale (nblk, 1) f32 -> the first prod(shape)
    values of ``q * scale`` as ``shape`` in ``dtype``."""
    if scale.shape != (q.shape[0], 1):
        raise ValueError(f"dequantize_int8: want scale (nblk, 1) for q "
                         f"{tuple(q.shape)}, got {tuple(scale.shape)}")
    return dequantize(q, scale[:, 0], shape, dtype)


quantize.launches = 0
dequantize.launches = 0
