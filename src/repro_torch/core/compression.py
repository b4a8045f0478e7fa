"""Blockwise int8 compression, the counterpart of the quantization half
of ``repro/core/compression.py``.

- ``quantize_int8_blockwise`` / ``dequantize_int8_blockwise``: symmetric
  per-block int8 (``scale = max|x|/127 + 1e-30``), used for the AdamW
  moments. A CUDA tensor runs the CUDA kernels K4a / K4b
  (``kernels/quant``), a CPU tensor their plain versions.
- ``ErrorFeedback`` / ``compress_with_feedback``: the residual carry that
  keeps lossy gradient sync unbiased over time.

The byte codecs and the §5.1 "when does compression win" model of the
JAX module wait for the checkpoint slice.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.quant.ops import dequantize, quantize


class Quantized(NamedTuple):
    q: torch.Tensor        # int8 payload (nblk, block)
    scale: torch.Tensor    # f32 per-block scales (nblk,)


def quantize_int8_blockwise(x: torch.Tensor, block: int = 256) -> Quantized:
    """Symmetric per-block int8 of ``x`` flattened; the tail of the last
    block is read as zeros."""
    return Quantized(*quantize(x, block))


def dequantize_int8_blockwise(qt: Quantized, shape: Sequence[int],
                              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return dequantize(qt.q, qt.scale, shape, dtype)


def quantized_nbytes(qt: Quantized) -> int:
    return qt.q.numel() + qt.scale.numel() * 4


class ErrorFeedback(NamedTuple):
    """Residual state for unbiased lossy gradient sync."""
    residual: torch.Tensor

    @staticmethod
    def init(shape, dtype: torch.dtype = torch.float32, device=None) -> "ErrorFeedback":
        """Zero residual on ``device`` (``cuda`` unless the caller asks
        for the CPU)."""
        return ErrorFeedback(residual=torch.zeros(shape, dtype=dtype,
                                                  device=resolve_device(device)))


def compress_with_feedback(g: torch.Tensor, ef: ErrorFeedback,
                           block: int = 256) -> Tuple[Quantized, ErrorFeedback]:
    """q = Q(g + residual); residual' = (g + residual) - deq(q)."""
    corrected = g.float() + ef.residual
    qt = quantize_int8_blockwise(corrected, block)
    deq = dequantize_int8_blockwise(qt, g.shape)
    return qt, ErrorFeedback(residual=corrected - deq)
