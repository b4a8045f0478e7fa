"""Plain PyTorch version of the flash-attention kernel: the quadratic
reference of ``repro/models/attention.py::attention_ref``.

Shapes: q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd); GQA via Hq % Hkv == 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def softcap_(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return scores if cap is None else cap * torch.tanh(scores / cap)


def expand_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd) by repetition."""
    return x if groups == 1 else x.repeat_interleave(groups, dim=2)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  q_offset: int = 0, scale: Optional[float] = None) -> torch.Tensor:
    """Quadratic reference in f32; returns v.dtype. q_offset: absolute
    position of q[0] (suffix attention against a longer KV prefix);
    ``scale`` the scores' factor, 1/sqrt(hd) where None."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float()
    kf = expand_kv(k, hq // hkv).float()
    vf = expand_kv(v, hq // hkv).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    scores = softcap_(scores / math.sqrt(d) if scale is None else scores * scale, softcap)
    qpos = torch.arange(sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, vf).to(v.dtype)
