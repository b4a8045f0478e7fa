"""The decoder LM, the counterpart of ``repro/models/model.py`` for
attention layers with a dense MLP.

``forward`` covers train and prefill without a cache; ``prefill`` builds
the cache; ``decode_step`` advances one token against it. Layers run as a
Python loop over period groups (the JAX package's ``lax.scan``). The
dtype flow is the JAX one: the residual stream in ``cfg.dtype`` (bf16),
every product in bf16, norms and softmax in f32.

Unlike the JAX functions, ``decode_step`` writes the new token's K/V into
the cache it is given, in place, and returns that same cache: JAX's
``.at[].set`` builds a new array, which on the card would copy the whole
cache every step.

Codebooks, frontends, MoE and SSM layers raise (later slices).
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple, Union

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.layers import activation_fn, mlp, rmsnorm, rope
from repro_torch.models.params import (check_supported, layer_period,
                                       num_groups, slot_kind)

PyTree = Any


class ForwardResult(NamedTuple):
    hidden: torch.Tensor       # (B, S, D)
    aux_loss: torch.Tensor     # MoE load-balance loss (0: no MoE here)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _group(slot_params: dict, g: int) -> dict:
    """Layer ``g`` of a stacked per-slot tree (views, no copies)."""
    return {k: _group(v, g) if isinstance(v, dict) else v[g]
            for k, v in slot_params.items()}


def _layers(cfg: ModelConfig, params: PyTree):
    """Yield (slot, group, layer params) in layer order."""
    for g in range(num_groups(cfg)):
        for slot in range(layer_period(cfg)):
            yield slot, g, _group(params["layers"][slot], g)


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------

def embed_tokens(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor) -> torch.Tensor:
    check_supported(cfg)
    x = params["embed"]["table"][tokens.long()].to(_dtype(cfg))
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


# ----------------------------------------------------------------------
# single layer
# ----------------------------------------------------------------------

def _project_qkv(cfg: ModelConfig, p: dict, h: torch.Tensor, positions):
    """bf16 q/k/v (B,S,H,hd), roped. Each is a (B·S, D) x (D, H·hd)
    product viewed as (B,S,H,hd), so it comes out contiguous."""
    b, s, d = h.shape
    xc = h.to(torch.bfloat16).reshape(b * s, d)

    def proj(w):
        return (xc @ w.to(torch.bfloat16).reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])

    q = rope(proj(p["wq"]), positions, cfg.rope_theta, cfg.rope_fraction)
    k = rope(proj(p["wk"]), positions, cfg.rope_theta, cfg.rope_fraction)
    return q, k, proj(p["wv"])


def _out_proj(p: dict, out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    b, s, h, hd = out.shape
    y = out.to(torch.bfloat16).reshape(b, s, h * hd) \
        @ p["wo"].to(torch.bfloat16).reshape(h * hd, -1)
    return y.to(dtype)


def _write_cache(cache: dict, k, v, pos: torch.Tensor) -> None:
    """Put this step's k/v (B,1,Hkv,hd) at ``pos`` (scalar or (B,)), in
    place. Out-of-range positions behave as in JAX: a scalar start is
    clamped to the last row (``dynamic_update_slice``), and a per-row
    write past the end is dropped (``.at[].set``). An idle slot whose
    last request filled its cache keeps ``pos == max_len``."""
    last = cache["k"].shape[1] - 1
    if pos.dim() == 0:         # aligned batch: one shared position
        idx = pos.reshape(1).long().clamp(0, last)
        cache["k"].index_copy_(1, idx, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, idx, v.to(cache["v"].dtype))
    else:                      # continuous batching: per-row positions
        bidx = torch.arange(k.shape[0], device=k.device)
        idx = pos.long().clamp(0, last)
        keep = (pos <= last)[:, None, None]
        for name, new in (("k", k), ("v", v)):
            c = cache[name]
            c[bidx, idx] = torch.where(keep, new[:, 0].to(c.dtype), c[bidx, idx])


def _attention_mixer(cfg: ModelConfig, kind: dict, p: dict, x: torch.Tensor, *,
                     positions, impl: str, cache: Optional[dict] = None,
                     pos: Optional[torch.Tensor] = None):
    window = cfg.window_size if kind["local"] else None
    q, k, v = _project_qkv(cfg, p, x, positions)
    if cache is None:
        out = attn_mod.attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_logit_softcap, impl=impl)
    else:
        _write_cache(cache, k, v, pos)
        out = attn_mod.decode(q, cache["k"], cache["v"], pos + 1, window=window,
                              softcap=cfg.attn_logit_softcap, impl=impl)
    return _out_proj(p, out, x.dtype)


def _ffn(cfg: ModelConfig, kind: dict, p: dict, x: torch.Tensor) -> torch.Tensor:
    if not kind["has_ffn"]:
        return x
    h = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps)
    return x + mlp(h, p["mlp"], activation_fn(cfg.mlp_activation))


def apply_layer(cfg: ModelConfig, slot: int, p: dict, x: torch.Tensor, *,
                positions, impl: str = "auto", cache: Optional[dict] = None,
                pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One attention + dense-MLP layer. With ``cache`` (one layer's
    ``{"k","v"}`` of shape (B,max_len,Hkv,hd)) it is a decode step that
    writes the cache in place."""
    kind = slot_kind(cfg, slot)
    h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
    x = x + _attention_mixer(cfg, kind, p["attn"], h, positions=positions,
                             impl=impl, cache=cache, pos=pos)
    return _ffn(cfg, kind, p, x)


# ----------------------------------------------------------------------
# forward (train / prefill without a cache)
# ----------------------------------------------------------------------

def forward(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor, *,
            impl: str = "auto") -> ForwardResult:
    x = embed_tokens(cfg, params, tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    for slot, _, p in _layers(cfg, params):
        x = apply_layer(cfg, slot, p, x, positions=positions, impl=impl)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return ForwardResult(hidden=x, aux_loss=torch.zeros((), device=x.device))


def logits_for(cfg: ModelConfig, params: PyTree, hidden: torch.Tensor) -> torch.Tensor:
    """Full f32 logits (B,S,V) from bf16 products."""
    table = (params["embed"]["table"] if cfg.tie_embeddings
             else params["lm_head"]["w"]).to(torch.bfloat16)
    logits = (hidden.to(torch.bfloat16) @ table.T).float()
    if cfg.final_logit_softcap:
        logits = cfg.final_logit_softcap * torch.tanh(logits / cfg.final_logit_softcap)
    return logits


# ----------------------------------------------------------------------
# KV cache + decode
# ----------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, device=None) -> Tuple[dict, ...]:
    """A tuple of per-slot ``{"k","v"}`` of shape (G,B,max_len,Hkv,hd)."""
    check_supported(cfg)
    device = resolve_device(device)
    shp = (num_groups(cfg), batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return tuple({"k": torch.zeros(shp, dtype=dtype, device=device),
                  "v": torch.zeros(shp, dtype=dtype, device=device)}
                 for _ in range(layer_period(cfg)))


def decode_step(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
                cache: Tuple[dict, ...], pos: Union[int, torch.Tensor], *,
                impl: str = "auto"):
    """One decode step. tokens (B,1); pos a scalar (aligned batch) or (B,)
    int tensor (continuous batching). Writes the cache in place.
    Returns (logits (B,1,V), cache)."""
    x = embed_tokens(cfg, params, tokens)
    pos = torch.as_tensor(pos, device=x.device)
    positions = pos[None] if pos.dim() == 0 else pos[:, None]
    for slot, g, p in _layers(cfg, params):
        c = {"k": cache[slot]["k"][g], "v": cache[slot]["v"][g]}
        x = apply_layer(cfg, slot, p, x, positions=positions, impl=impl,
                        cache=c, pos=pos)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    return logits_for(cfg, params, x), cache


def prefill(cfg: ModelConfig, params: PyTree, tokens: torch.Tensor,
            max_len: int, *, impl: str = "auto",
            cache_dtype: torch.dtype = torch.bfloat16,
            length: Optional[int] = None):
    """Run the whole prompt and build a cache for decode.
    Returns (logits (B,1,V), cache, next_pos).

    ``length`` supports right-padded prompts (the serving engine's
    power-of-two buckets): logits come from the token at ``length - 1``
    and ``next_pos`` is ``length``. Causal attention keeps the pad tail
    out of the real tokens, and decode masks cache rows ``>= pos``, so
    the pad K/V are never read."""
    x = embed_tokens(cfg, params, tokens)
    b, s, _ = x.shape
    if s > max_len:
        raise ValueError(f"prompt of {s} tokens exceeds max_len {max_len}")
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, cache_dtype, x.device)
    for slot, g, p in _layers(cfg, params):
        kind = slot_kind(cfg, slot)
        h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
        q, k, v = _project_qkv(cfg, p["attn"], h, positions)
        window = cfg.window_size if kind["local"] else None
        out = attn_mod.attention(q, k, v, causal=True, window=window,
                                 softcap=cfg.attn_logit_softcap, impl=impl)
        x = x + _out_proj(p["attn"], out, x.dtype)
        cache[slot]["k"][g, :, :s] = k
        cache[slot]["v"][g, :, :s] = v
        x = _ffn(cfg, kind, p, x)
    x = rmsnorm(x, params["final_norm"]["scale"], cfg.norm_eps)
    npos = s if length is None else int(length)
    return logits_for(cfg, params, x[:, npos - 1:npos]), cache, npos
