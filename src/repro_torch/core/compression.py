"""Compression substrate, the counterpart of ``repro/core/compression.py``.

- the byte codecs (``BYTE_CODECS``, ``byte_codec``, ``default_codec``):
  the checkpoint payload compressors, recorded by name in every
  manifest (``ckpt/checkpoint.py``) and run by the offload tier
  (``offload/compression.py``); ``zstd`` only where the ``zstandard``
  module is installed, else ``zlib``, as in the JAX package;
- ``quantize_int8_blockwise`` / ``dequantize_int8_blockwise``: symmetric
  per-block int8 (``scale = max|x|/127 + 1e-30``), used for the AdamW
  moments. A CUDA tensor runs the CUDA kernels K4a / K4b
  (``kernels/quant``), a CPU tensor their plain versions.
- ``ErrorFeedback`` / ``compress_with_feedback``: the residual carry that
  keeps lossy gradient sync unbiased over time.
- the §5.1 analytic model of when compress-then-send wins
  (``offload_path_bandwidth``, ``compression_wins``,
  ``grad_sync_seconds``): the JAX module's functions, line for line.
"""
from __future__ import annotations

import math
import zlib
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.kernels.quant.ops import dequantize, quantize

try:  # optional: fall back to zlib when the wheel is absent
    import zstandard as zstd
except ImportError:
    zstd = None

#: codec name -> (extension, compress fn, decompress fn)
BYTE_CODECS: Dict[str, Tuple[str, Callable[[bytes], bytes],
                             Callable[[bytes], bytes]]] = {
    "zstd": (".zst",
             lambda b: zstd.ZstdCompressor(level=3).compress(b),
             lambda b: zstd.ZstdDecompressor().decompress(b)),
    "zlib": (".zz",
             lambda b: zlib.compress(b, 6),
             lambda b: zlib.decompress(b)),
    "none": ("", lambda b: b, lambda b: b),
}


def byte_codec(name: str) -> Tuple[str, Callable[[bytes], bytes],
                                   Callable[[bytes], bytes]]:
    """Look up a byte codec, failing early when the backing wheel is
    absent (a zstd-written checkpoint cannot restore without it)."""
    if name not in BYTE_CODECS:
        raise KeyError(f"unknown codec {name!r} (have {sorted(BYTE_CODECS)})")
    if name == "zstd" and zstd is None:
        raise IOError("codec 'zstd' needs the zstandard module")
    return BYTE_CODECS[name]


def default_codec(compress: bool) -> str:
    if not compress:
        return "none"
    return "zstd" if zstd is not None else "zlib"


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


# ----------------------------------------------------------------------
# §5.1 analytic model: when does compress-then-send win?
# ----------------------------------------------------------------------

def offload_path_bandwidth(P: float, ratio: float) -> float:
    """Paper: A1 file bandwidth over the double-crossed internal link is
    P / (1 + ratio)."""
    return P / (1.0 + ratio)


def compression_wins(N: float, P: float, ratio: float,
                     compress_rate: Optional[float] = None) -> bool:
    """Is compress-and-offload (A1) faster than direct send (A3)?
    Paper threshold: ratio < P/N − 1 (equals 28% on their testbed).
    An optional compressor-throughput cap (wimpy SoC) tightens it."""
    a1 = min(offload_path_bandwidth(P, ratio), N / max(ratio, 1e-12))
    if compress_rate is not None:
        a1 = min(a1, compress_rate)
    return a1 > N


def grad_sync_seconds(nbytes: float, n: int, bw: float, *,
                      ratio: float = 1.0, compress_rate: float = math.inf) -> float:
    """Ring all-reduce time for nbytes with optional compression: wire
    bytes scale by `ratio`, plus quantize/dequantize at `compress_rate`."""
    wire = 2.0 * nbytes * ratio * (n - 1) / n / bw
    comp = 0.0 if math.isinf(compress_rate) else 2.0 * nbytes / compress_rate
    return wire + comp
