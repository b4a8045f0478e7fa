"""Pieces every family shares: RMSNorm, rotary embedding, the product
in f32 or in the control's fp8, and the cross-entropy with z-loss."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

FP8_MAX = 448.0                      # largest finite float8_e4m3fn


class _RoundFP8(torch.autograd.Function):
    """x rounded to float8_e4m3fn on a scale of its own over ``dim``
    (the largest magnitude maps to 448); the gradient passes straight."""

    @staticmethod
    def forward(ctx, x, dim):
        amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
        scale = amax / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    @staticmethod
    def backward(ctx, g):
        return g, None


def mm(a: torch.Tensor, w: torch.Tensor, lowp: Optional[str] = None) -> torch.Tensor:
    """a (..., K) @ w (K, N) in f32; ``lowp="fp8"`` rounds a per row and w
    per output column to fp8 first (the control's precision)."""
    a, w = a.float(), w.float()
    if lowp == "fp8":
        a, w = _RoundFP8.apply(a, -1), _RoundFP8.apply(w, 0)
    elif lowp is not None:
        raise ValueError(f"unknown precision {lowp!r}")
    return a @ w


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale.float()


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding on (S, H, hd), the halves of each head rotated
    together (GPT-NeoX layout): pair (i, i + hd/2) turns by pos·θ^(-2i/hd)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    ang = (positions.double()[:, None] * freqs).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def ce_sum(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor, z_loss: float,
           lowp: Optional[str] = None) -> torch.Tensor:
    """Sum over rows of ``lse - logit[label] + z_loss * lse**2`` for hidden
    rows h (R, D) against the head (V, D)."""
    logits = mm(h, head.t(), lowp)
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[:, None])[:, 0]
    return (lse - ll).sum() + z_loss * (lse * lse).sum()


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)
