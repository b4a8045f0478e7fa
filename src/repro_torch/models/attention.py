"""Attention, the counterpart of ``repro/models/attention.py``.

- ``attention_ref``     : quadratic reference (the plain version of K1).
- ``attention_blocked`` : flash-style online softmax over q/kv blocks in
  plain tensor ops, skipping fully-masked kv blocks; the attention of
  training from 2048 tokens, as in the JAX package.
- ``decode_attention``  : one-token attention against a KV cache, with a
  scalar or per-row ``(B,)`` cache length (the plain version of K2).
- ``decode_attention_context_parallel`` : the same with the cache's
  sequence split over a mesh axis, each rank's partial (m, l, o) merged
  by a log-sum-exp reduction over the axis (flash-decoding across
  ranks).
- ``attention`` / ``decode`` : dispatch between those and the CUDA
  kernels. ``impl="auto"`` takes the kernel for CUDA tensors at every
  length and the plain version for CPU tensors; ``"ref"`` always takes
  the plain version; ``"blocked"`` the blocked scan.
- ``train_impl`` : the ``impl`` of a training forward, JAX's own rule.

Shapes: q (B, Sq, Hq, hd); k/v (B, Skv, Hkv, hd); GQA via Hq % Hkv == 0.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.collectives import all_reduce
from repro_torch.kernels import use_kernel
from repro_torch.kernels.decode_attention.ops import decode_attention_kernel
from repro_torch.kernels.decode_attention.ref import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (NEG_INF, attention_ref, expand_kv,
                                                     softcap_)

__all__ = ["NEG_INF", "attention_ref", "attention_blocked", "decode_attention",
           "decode_attention_context_parallel", "attention", "decode", "train_impl"]

#: JAX's ``attention(impl="auto")`` takes the blocked scan from this length
BLOCKED_FROM = 2048


def attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: Optional[float] = None, q_block: int = 512,
                      kv_block: int = 512, scale: Optional[float] = None) -> torch.Tensor:
    """Flash-style attention with online softmax, blocked over q and kv,
    in f32 (``repro/models/attention.py:68-157``); returns v.dtype.

    Fully-masked kv blocks (above the causal diagonal, left of the
    window) are skipped, as JAX's ``lax.cond`` skips them. A length that
    is not a multiple of both blocks falls back to ``attention_ref``, as
    there. Differentiable: the training forward's attention from 2048
    tokens. ``scale`` multiplies the scores, 1/sqrt(hd) where None."""
    b, s, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if s != skv:
        raise ValueError("attention_blocked is for self-attention (train/prefill)")
    if s % q_block or s % kv_block:
        return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                             scale=scale)
    groups = hq // hkv
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    qt = q.transpose(1, 2).float() * scale               # (B, Hq, S, d)
    kt = k.transpose(1, 2).float()                       # (B, Hkv, S, d)
    vt = v.transpose(1, 2).float()
    if groups > 1:                                       # (B,Hkv,S,d)->(B,Hq,S,d)
        kt, vt = (x[:, :, None].expand(b, hkv, groups, s, d).reshape(b, hq, s, d)
                  for x in (kt, vt))
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=q.device)
    pos = torch.arange(max(q_block, kv_block), device=q.device)

    blocks = []
    for q0 in range(0, s, q_block):
        qblk = qt[:, :, q0:q0 + q_block]
        m = torch.full((b, hq, q_block), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((b, hq, q_block), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, hq, q_block, d), dtype=torch.float32, device=q.device)
        for k0 in range(0, s, kv_block):
            if causal and k0 > q0 + q_block - 1:        # above the diagonal
                continue
            if window is not None and k0 + kv_block - 1 <= q0 - window:
                continue                                 # left of the window
            sc = softcap_(qblk @ kt[:, :, k0:k0 + kv_block].transpose(-1, -2), softcap)
            # the mask where a block meets the diagonal or the window's
            # edge; elsewhere every entry is kept and JAX's where(mask) and
            # mask-multiply leave the block as it is
            msk = None
            if (causal and k0 + kv_block - 1 > q0) or \
                    (window is not None and k0 <= q0 + q_block - 1 - window):
                qpos = (q0 + pos[:q_block])[:, None]
                kpos = (k0 + pos[:kv_block])[None, :]
                msk = torch.ones((q_block, kv_block), dtype=torch.bool, device=q.device)
                if causal:
                    msk &= kpos <= qpos
                if window is not None:
                    msk &= kpos > qpos - window
                sc = torch.where(msk, sc, neg_inf)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            if msk is not None:                          # rows with no valid
                p = p * msk                              # column contribute 0
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vt[:, :, k0:k0 + kv_block]
            m = m_new
        blocks.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(v.dtype))
    return torch.cat(blocks, dim=2).transpose(1, 2)     # (B, S, Hq, d)


def decode_attention_context_parallel(q: torch.Tensor, k_cache: torch.Tensor,
                                      v_cache: torch.Tensor, cache_len, *, mesh,
                                      axis: str = "data", window: Optional[int] = None,
                                      softcap: Optional[float] = None,
                                      scale: Optional[float] = None) -> torch.Tensor:
    """One-token attention against a cache whose sequence dim is split
    over the mesh axis ``axis`` (``attention.py:184-250``), on this
    rank's local tensors: q (B,1,Hq,hd) whole, the caches this rank's
    ``S/n`` rows (B, S/n, Hkv, hd), rank i holding rows [i·S/n, (i+1)·S/n);
    ``cache_len`` (scalar or (B,)) counts the valid rows of the whole
    cache. Batch rows split over other axes are the caller's: the merge
    runs over ``axis`` only.

    Each rank takes its rows' partial (m, l, o) in f32 (an all-masked
    shard gives l = o = 0), then ``pmax`` of m and one ``psum`` of l·corr
    and o·corr (one all-reduce of both, the same sums) merge them:
    out = o / max(l, 1e-30). Serves (a) long-context decode (axis="data")
    and (b) GQA models whose KV heads do not divide the TP axis
    (axis="model"). Returns (B,1,Hq,hd) in the cache dtype on every rank.

    Paper mapping: the query visits a remote, sharded value store and
    the partial results combine, DrTM-KV's multi-path get with the LSE
    merge as the client-side combine. ``scale`` multiplies the scores,
    1/sqrt(hd) where None."""
    b, _, hq, d = q.shape
    s_local, hkv = k_cache.shape[1], k_cache.shape[2]
    groups = hq // hkv
    group = mesh.get_group(axis)
    idx = dist.get_rank(group)
    qf = q.float()[:, 0]
    kf = expand_kv(k_cache, groups).float()
    vf = expand_kv(v_cache, groups).float()
    scores = torch.einsum("bhd,bkhd->bhk", qf, kf)
    scores = softcap_(scores / math.sqrt(d) if scale is None else scores * scale, softcap)
    kpos = idx * s_local + torch.arange(s_local, device=q.device)[None, :]
    clen = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    mask = kpos < clen
    if window is not None:
        mask &= kpos >= clen - window
    scores = torch.where(mask[:, None, :], scores,
                         torch.tensor(NEG_INF, dtype=scores.dtype, device=q.device))
    m = scores.amax(dim=-1)                                        # (B,H)
    # an all-masked shard: exp(NEG_INF - NEG_INF) = 1, zeroed by the mask
    p = torch.exp(scores - m[..., None]) * mask[:, None, :]
    l = p.sum(dim=-1)
    o = torch.einsum("bhk,bkhd->bhd", p, vf)
    # LSE merge across the shards
    m_glob = all_reduce(m, group, dist.ReduceOp.MAX)
    corr = torch.exp(m - m_glob)
    lo = all_reduce(torch.cat([(l * corr)[..., None], o * corr[..., None]], dim=-1), group)
    out = lo[..., 1:] / torch.clamp(lo[..., :1], min=1e-30)
    return out[:, None].to(v_cache.dtype)


def train_impl(seq_len: int) -> str:
    """The attention a training forward takes: JAX's ``attention(
    impl="auto")`` rule (``repro/models/attention.py:262``), the plain
    quadratic reference below 2048 tokens and the blocked scan from 2048.
    It never takes the CUDA kernels: they are forward-only, as their
    Pallas originals are, and JAX's ``auto`` never takes those either."""
    return "blocked" if seq_len >= BLOCKED_FROM else "ref"


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              softcap: Optional[float] = None, impl: str = "auto",
              scale: Optional[float] = None):
    """Self-attention for train / prefill: q (B,S,Hq,hd), k/v (B,S,Hkv,hd);
    ``scale`` multiplies the scores, 1/sqrt(hd) where None."""
    if use_kernel(impl, q):
        return flash_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap, scale=scale)
    if impl == "blocked":
        return attention_blocked(q, k, v, causal=causal, window=window,
                                 softcap=softcap, scale=scale)
    return attention_ref(q, k, v, causal=causal, window=window, softcap=softcap,
                         scale=scale)


def decode(q, k_cache, v_cache, cache_len, *, window: Optional[int] = None,
           softcap: Optional[float] = None, impl: str = "auto",
           scale: Optional[float] = None):
    """One-token attention: q (B,1,Hq,hd), caches (B,S,Hkv,hd), cache_len
    scalar or (B,); ``scale`` as in ``attention``. Returns the cache dtype."""
    if use_kernel(impl, q):
        return decode_attention_kernel(q, k_cache, v_cache, cache_len,
                                       window=window, softcap=softcap, scale=scale)
    return decode_attention(q, k_cache, v_cache, cache_len, window=window,
                            softcap=softcap, scale=scale)
