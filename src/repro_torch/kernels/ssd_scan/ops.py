"""Wrapper of the CUDA SSD scan kernel (``csrc/ssd_scan.cu``) in the
model zoo's layout: x (B,S,H,P) and Bm/C (B,S,N) in float32 or bfloat16,
dt (B,S,H) and A (H,) in float32 (as the model makes them).

A CUDA tensor launches the kernel or raises; a CPU tensor takes the plain
version (``ref.ssd_chunked_ref`` on f32 inputs). ``ssd_scan.launches``
counts the launches of the kernel.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256


def _check(x, dt, A, Bm, C):
    dev = x.device
    if not (x.is_cuda and all(t.device == dev for t in (dt, A, Bm, C))):
        raise ValueError("ssd_scan: x, dt, A, Bm, C must lie on one CUDA device")
    if x.dtype not in DTYPES or Bm.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x, Bm, C must share a dtype of float32 or "
                        f"bfloat16, got {x.dtype}, {Bm.dtype}, {C.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_scan: dt and A must be float32, got {dt.dtype}, "
                        f"{A.dtype}")
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or Bm.dim() != 3 \
            or C.shape != Bm.shape:
        raise ValueError(f"ssd_scan: want x (B,S,H,P), dt (B,S,H), A (H,), "
                         f"Bm/C (B,S,N), got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(Bm.shape)}, {tuple(C.shape)}")
    b, s, h, _ = x.shape
    if dt.shape != (b, s, h) or A.shape != (h,) or Bm.shape[:2] != (b, s):
        raise ValueError("ssd_scan: dt, A, Bm, C must match x's batch, length "
                         "and heads")
    n = Bm.shape[2]
    if n % 4 or n > MAX_STATE:
        raise ValueError(f"ssd_scan: state size {n} must be a multiple of 4 "
                         f"and at most {MAX_STATE}")
    if b > 65535 or h > 65535:
        raise ValueError(f"ssd_scan: batch {b} and heads {h} must be at most 65535")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("Bm", Bm), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} must be contiguous")
    if Bm.data_ptr() % 16 or C.data_ptr() % 16:          # read as 4-wide quads
        raise ValueError("ssd_scan: Bm and C must be 16-byte aligned")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32).

    ``chunk`` is the plain version's chunk length (the JAX signature's);
    the kernel walks its own 64-token tiles, the same function up to
    rounding, at any S."""
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked_ref(x.float(), dt, A, Bm, C, chunk=chunk)
    _check(x, dt, A, Bm, C)
    refuse_grad("ssd_scan", x, dt, A, Bm, C)
    b, s, h, p = x.shape
    n = Bm.shape[2]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if hout.numel() == 0:
        return y, hout
    lib = _build.library("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_forward(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                                   Bm.data_ptr(), C.data_ptr(), y.data_ptr(),
                                   hout.data_ptr(), DTYPES[x.dtype], b, s, h, p, n,
                                   stream)
    _build.check(err, "ssd_scan launch")
    ssd_scan.launches += 1
    return y, hout


ssd_scan.launches = 0
