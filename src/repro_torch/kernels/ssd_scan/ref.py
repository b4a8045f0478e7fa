"""Plain PyTorch versions of the SSD scan kernel: the chunked-parallel
SSD and the sequential recurrence of the port's model zoo (one source of
truth), as ``repro/kernels/ssd_scan/ref.py`` re-exports them; and
``ssd_tensor_core_emulation``, the tensor-core path's arithmetic, which
only the tests use."""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import ssd_chunked as ssd_chunked_ref  # noqa: F401
from repro_torch.models.ssm import ssd_ref as ssd_sequential_ref   # noqa: F401


TERMS = 3   # bf16 terms of an f32 operand (``TERMS`` in csrc/ssd_scan.cu)


def _split(v: torch.Tensor) -> List[torch.Tensor]:
    """An f32 operand as the kernel feeds it to the tensor cores: TERMS
    bf16 terms, each the rounding of what the earlier ones leave, in f32."""
    terms = []
    for _ in range(TERMS):
        terms.append(v.to(torch.bfloat16).float())
        v = v - terms[-1]
    return terms


def _split_einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """einsum with ``a`` split into its bf16 terms, summed in f32."""
    return sum(torch.einsum(eq, t, b) for t in _split(a))


def ssd_tensor_core_emulation(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                              Bm: torch.Tensor, C: torch.Tensor, *, chunk: int = 64
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The arithmetic of ``csrc/ssd_scan.cu``'s tensor-core path in plain
    PyTorch: 64-token chunks (zero-padded, dt = 0), each chunk's own state
    (w∘x)ᵀ·B, the states passed between chunks in f32, and the output
    exp(cum[t]) C·h_in + M·x; every f32 operand of a product (w∘x, h_in,
    M) split into TERMS bf16 terms, x, B and C taken as they are, f32
    sums. Returns (y (B,S,H,P) f32, final state (B,H,P,N) f32)."""
    b, s, h, p = x.shape
    n = Bm.shape[-1]
    pad = (-s) % chunk
    xf, dtf, Bf, Cf = (F.pad(t.float(), (0, 0) * (t.dim() - 2) + (0, pad))
                       for t in (x, dt, Bm, C))
    g = (s + pad) // chunk
    xf = xf.reshape(b, g, chunk, h, p)
    dtf = dtf.reshape(b, g, chunk, h)
    Bf = Bf.reshape(b, g, chunk, n)
    Cf = Cf.reshape(b, g, chunk, n)
    cum = torch.cumsum(dtf * A.float(), dim=2)                      # (B,G,L,H)
    last = cum[:, :, -1]                                            # (B,G,H)

    # the state pass: each chunk's own state, and its decay
    w = torch.exp(last[:, :, None] - cum) * dtf                     # (B,G,L,H)
    states = _split_einsum("bgshp,bgsn->bghpn", w[..., None] * xf, Bf)
    decay = torch.exp(last)
    # ... and the state entering each chunk, carried in f32
    hstate = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    h_in = []
    for gi in range(g):
        h_in.append(hstate)
        hstate = hstate * decay[:, gi, :, None, None] + states[:, gi]
    h_in = torch.stack(h_in, dim=1)                                 # (B,G,H,P,N)
    # the output pass
    inter = _split_einsum("bghpn,bgtn->bgthp", h_in, Cf) * torch.exp(cum)[..., None]
    CB = torch.einsum("bgtn,bgsn->bgts", Cf, Bf)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]           # (B,G,t,s,H)
    e = torch.exp(diff.masked_fill(~tri[None, None, :, :, None], float("-inf")))
    M = CB[..., None] * e * dtf[:, :, None, :, :]
    y = inter + _split_einsum("bgtsh,bgshp->bgthp", M, xf)
    return y.reshape(b, g * chunk, h, p)[:, :s], hstate
