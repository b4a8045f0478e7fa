"""Shared layer primitives, the counterpart of ``repro/models/layers.py``:
RMSNorm, RoPE, activations, the gated MLP.

One card, no tensor parallelism: the JAX package's ``row_parallel`` is a
plain product here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Math in f32, result in ``x.dtype``."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope(q: torch.Tensor, positions: torch.Tensor, theta: float,
         fraction: float = 1.0) -> torch.Tensor:
    """Rotary embedding, half-split (NeoX) layout on the first
    ``fraction`` of head dims. q (..., S, H, hd); positions (S,) or (B,S)."""
    hd = q.shape[-1]
    rot = int(hd * fraction)
    rot -= rot % 2
    if rot == 0:
        return q
    qr, qp = q[..., :rot], q[..., rot:]
    half = rot // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions[..., None].float() * freqs               # (..., S, half)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    q1, q2 = qr[..., :half], qr[..., half:]                  # broadcast over heads
    out = torch.cat([q1 * cos - q2 * sin, q2 * cos + q1 * sin], dim=-1)
    return torch.cat([out.to(q.dtype), qp], dim=-1)


def activation_fn(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


def mlp(x: torch.Tensor, params: dict, activation) -> torch.Tensor:
    """Gated MLP (SwiGLU / GeGLU) in bf16. w_in (D,2,F), w_out (F,D)."""
    d, _, f = params["w_in"].shape
    xc = x.to(torch.bfloat16)
    h = (xc @ params["w_in"].to(torch.bfloat16).reshape(d, 2 * f))
    h = h.unflatten(-1, (2, f))
    h = activation(h[..., 0, :]) * h[..., 1, :]
    out = h @ params["w_out"].to(torch.bfloat16)
    return out.to(x.dtype)
