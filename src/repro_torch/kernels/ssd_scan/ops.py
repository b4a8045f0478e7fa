"""Wrapper of the CUDA SSD scan kernels (``csrc/ssd_scan.cu``) in the
model zoo's layout: x (B,S,H,P) and Bm/C (B,S,N) in float32 or bfloat16,
dt (B,S,H) and A (H,) in float32 (as the model makes them).

A CUDA tensor launches the kernels or raises; a CPU tensor takes the
plain version (``ref.ssd_chunked_ref`` on f32 inputs). The C entry picks
the path by dtype and shape: bf16 x/B/C with P a multiple of 16 and N 64
or 128 (mamba2's prefill) run on the tensor cores in two launches (the
states, walking the chunks; the output, chunk by chunk in parallel)
through an f32 scratch allocated here at the size the library names, one
launch at S <= 64; any other input runs the CUDA-core kernel.
``ssd_scan.launches`` counts the calls that launched either.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, refuse_grad
from repro_torch.kernels.ssd_scan.ref import ssd_chunked_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256


@functools.lru_cache(maxsize=256)
def _scratch_bytes(x_dtype: int, b: int, s: int, h: int, p: int, n: int) -> int:
    """The library's answer (``ssd_scan_scratch_bytes``): the scratch the
    tensor-core path needs, -1 for inputs it does not take."""
    return _build.library("ssd_scan").ssd_scan_scratch_bytes(x_dtype, b, s, h, p, n)


def tensor_core_path(x: torch.Tensor, Bm: torch.Tensor) -> bool:
    """Does a scan of these inputs run on the tensor cores? The library's
    rule (``tensor_core_path`` in ``csrc/ssd_scan.cu``), so it builds the
    kernels first."""
    return _scratch_bytes(DTYPES[x.dtype], *x.shape, Bm.shape[2]) >= 0


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
    if x.data_ptr() % 16 or Bm.data_ptr() % 16 or C.data_ptr() % 16:
        raise ValueError("ssd_scan: x, Bm and C must be 16-byte aligned")  # quads, TMA


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, C: torch.Tensor, *, chunk: int = 128
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: returns (y (B,S,H,P) f32, final_state (B,H,P,N) f32).

    ``chunk`` is the plain version's chunk length (the JAX signature's);
    the kernels walk their own 64-token chunks, the same function up to
    rounding, at any S."""
    if chunk <= 0:
        raise ValueError(f"ssd_scan: chunk must be positive, got {chunk}")
    if x.device.type == "cpu":
        return ssd_chunked_ref(x.float(), dt, A, Bm, C, chunk=chunk)
    _check(x, dt, A, Bm, C)
    refuse_grad("ssd_scan", x, dt, A, Bm, C)
    if x.device.index != torch.cuda.current_device():    # launch from x's device
        with torch.cuda.device(x.device):
            return ssd_scan(x, dt, A, Bm, C, chunk=chunk)
    b, s, h, p = x.shape
    n = Bm.shape[2]
    y = torch.empty((b, s, h, p), dtype=torch.float32, device=x.device)
    hout = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if hout.numel() == 0:
        return y, hout
    dtype = DTYPES[x.dtype]
    need = _scratch_bytes(dtype, b, s, h, p, n)
    scratch = torch.empty(need // 4, dtype=torch.float32, device=x.device) if need > 0 else None
    # the raw handle: torch.cuda.current_stream(...).cuda_stream builds a
    # Stream object, 4-7 us of host time, near an 8-token prompt's kernel
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    err = _build.library("ssd_scan").ssd_scan_forward(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), C.data_ptr(), y.data_ptr(),
        hout.data_ptr(), None if scratch is None else scratch.data_ptr(), max(need, 0), dtype,
        b, s, h, p, n, stream)
    _build.check(err, "ssd_scan launch")
    ssd_scan.launches += 1
    return y, hout


ssd_scan.launches = 0
