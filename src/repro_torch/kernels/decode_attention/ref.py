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
