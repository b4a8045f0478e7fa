"""Plain PyTorch version of the flash-decoding kernel: the one-token
attention of ``repro/models/attention.py::decode_attention``."""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import NEG_INF, expand_kv, softcap_


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """q (B, 1, Hq, hd); caches (B, S, Hkv, hd); cache_len (an int, a
    scalar tensor or (B,)) = number of valid cache rows, the token
    written this step included. Returns (B, 1, Hq, hd) in the cache dtype."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    groups = hq // hkv
    qf = q.float()[:, 0]                                      # (B, Hq, d)
    kf = expand_kv(k_cache, groups).float()                   # (B, S, Hq, d)
    vf = expand_kv(v_cache, groups).float()
    scores = torch.einsum("bhd,bkhd->bhk", qf, kf) / math.sqrt(d)
    scores = softcap_(scores, softcap)
    kpos = torch.arange(s, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    mask = kpos < clen
    if window is not None:
        mask &= kpos >= clen - window
    scores = torch.where(mask[:, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs, vf)
    return out[:, None].to(v_cache.dtype)


def decode_attention_split_emulation(q: torch.Tensor, k_cache: torch.Tensor,
                                     v_cache: torch.Tensor, cache_len, split_rows: int,
                                     *, window: Optional[int] = None,
                                     softcap: Optional[float] = None) -> torch.Tensor:
    """The CUDA kernel's split and merge in plain tensor ops, on any device.

    Cache rows are cut into splits of ``split_rows``; a split that meets
    no row of ``[lo, clen)`` is skipped, as the kernel's split pass skips
    it. Each other split's partial state is (m, l, acc): the largest
    score, the sum of e^(s - m) and the e^(s - m)-weighted sum of v over
    its visible rows, with q scaled by 1/sqrt(hd) before the product as
    the kernel does. The merge takes them in split order by the
    log-sum-exp rule, M = max m_j, out = sum acc_j e^(m_j - M) /
    max(sum l_j e^(m_j - M), 1e-30), so a row with no visible key gives 0
    (the Pallas kernel's value; ``decode_attention`` averages v there).
    Inside a split the kernel's warps keep their own online states and
    merge them by the same rule: equal to this up to f32 rounding.
    Returns (B, 1, Hq, hd) in the cache dtype."""
    b, _, hq, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    g = hq // hkv
    dev = q.device
    qf = q.float()[:, 0].reshape(b, hkv, g, d) * (1.0 / math.sqrt(d))
    clen = torch.as_tensor(cache_len, device=dev).long().expand(b).clamp(0, s)
    lo = (clen - window).clamp(min=0) if window is not None else torch.zeros_like(clen)
    parts = []
    for r0 in range(0, s, split_rows):
        r1 = min(r0 + split_rows, s)
        live = (torch.maximum(lo, torch.tensor(r0, device=dev))
                < torch.minimum(clen, torch.tensor(r1, device=dev)))          # (B,)
        if not bool(live.any()):
            continue
        kpos = torch.arange(r0, r1, device=dev)[None, :]
        mask = ((kpos < clen[:, None]) & (kpos >= lo[:, None]))[:, None, None, :]
        sc = softcap_(torch.einsum("bhgd,bkhd->bhgk", qf, k_cache[:, r0:r1].float()), softcap)
        sc = torch.where(mask, sc, torch.tensor(NEG_INF, device=dev))
        m = sc.amax(-1)                                                      # (B,Hkv,G)
        p = torch.exp(sc - m[..., None]) * mask
        acc = torch.einsum("bhgk,bkhd->bhgd", p, v_cache[:, r0:r1].float())
        parts.append((live[:, None, None], m, p.sum(-1), acc))
    mx = torch.full((b, hkv, g), NEG_INF, device=dev)
    for live, m, _, _ in parts:
        mx = torch.where(live, torch.maximum(mx, m), mx)
    num = torch.zeros((b, hkv, g, d), device=dev)
    den = torch.zeros((b, hkv, g), device=dev)
    for live, m, l, acc in parts:
        c = torch.where(live, torch.exp(m - mx), torch.zeros_like(m))
        den = den + l * c
        num = num + acc * c[..., None]
    out = num / torch.clamp(den, min=1e-30)[..., None]
    return out.reshape(b, 1, hq, d).to(v_cache.dtype)
