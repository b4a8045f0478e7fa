"""Parameter initialization, the counterpart of ``repro/models/params.py``.

Layers are stacked as in the JAX package: ``params["layers"]`` is a tuple
of per-slot dicts whose tensors carry a leading ``G = L / period`` group
dim. Layouts are the JAX ones: ``wq (D,H,hd)``, ``wo (H,hd,D)``,
``w_in (D,2,F)``, ``w_out (F,D)``. Master weights are f32.

Only attention slots with a dense MLP exist in the port so far; MoE and
SSM slots raise.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig

PyTree = Any


def layer_period(cfg: ModelConfig) -> int:
    period = 1
    for p in (cfg.attn_period, cfg.local_global_period,
              cfg.moe_period if cfg.num_experts else 1):
        if p:
            period = math.lcm(period, p)
    if cfg.num_layers % period:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not divide "
                         f"into period {period}")
    return period


def num_groups(cfg: ModelConfig) -> int:
    return cfg.num_layers // layer_period(cfg)


def slot_kind(cfg: ModelConfig, slot: int) -> Dict[str, Any]:
    """Static description of the layer at period-slot `slot`."""
    return dict(
        kind=cfg.layer_kind(slot),
        local=cfg.is_local_layer(slot),
        moe=cfg.is_moe_layer(slot),
        has_ffn=bool(cfg.d_ff),
    )


def check_supported(cfg: ModelConfig) -> None:
    """Raise on what the port cannot run yet (later slices add it)."""
    if cfg.num_codebooks > 1 or cfg.frontend:
        raise NotImplementedError(f"{cfg.name}: codebooks and frontends are "
                                  "not ported yet")
    for slot in range(layer_period(cfg)):
        kind = slot_kind(cfg, slot)
        if kind["kind"] != "attn":
            raise NotImplementedError(f"{cfg.name}: SSM layers are not ported yet")
        if kind["moe"]:
            raise NotImplementedError(f"{cfg.name}: MoE layers are not ported yet")


def _normal(shape, std, generator, device):
    """N(0, std²) in f32, as ``_init_dense`` draws it (``params.py:97``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=generator)
    return t.mul_(std)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> PyTree:
    """Random f32 params with the JAX package's distributions and layout.

    ``generator`` must live on ``device``. Torch cannot reproduce
    ``jax.random``: tests that compare with the JAX package bridge its
    params instead (``repro_torch.bridge.params_from_numpy``)."""
    device = resolve_device(device)
    check_supported(cfg)
    g = num_groups(cfg)
    d, f = cfg.d_model, cfg.d_ff
    hq, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def dense(shape, fan_in):
        return _normal((g,) + shape, 1.0 / math.sqrt(max(fan_in, 1)),
                       generator, device)

    def ones(n):
        return torch.ones((g, n), dtype=torch.float32, device=device)

    vshape = (cfg.vocab_size, d)
    params: dict = {"embed": {"table": _normal(vshape, 0.02, generator, device)}}
    layers = []
    for slot in range(layer_period(cfg)):
        p = {"norm1": {"scale": ones(d)},
             "attn": {"wq": dense((d, hq, hd), d),
                      "wk": dense((d, hkv, hd), d),
                      "wv": dense((d, hkv, hd), d),
                      "wo": dense((hq, hd, d), cfg.q_dim)}}
        if slot_kind(cfg, slot)["has_ffn"]:
            p["norm2"] = {"scale": ones(d)}
            p["mlp"] = {"w_in": dense((d, 2, f), d), "w_out": dense((f, d), f)}
        layers.append(p)
    params["layers"] = tuple(layers)
    params["final_norm"] = {"scale": torch.ones((d,), dtype=torch.float32,
                                                device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _normal(vshape, 0.02, generator, device)}
    return params


def compute_copy(params: PyTree) -> PyTree:
    """A bf16 copy of every matrix, made once at load.

    The JAX model casts each f32 master weight to bf16 right before its
    product (``model.py:62-64,94-95``, ``layers.py:94-99``); a copy cast
    once holds the same values and saves the cast on every step. Norm
    scales and the embedding table stay f32: ``rmsnorm`` reads scales in
    f32, and ``embed_tokens`` gathers f32 rows and casts only those."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, name) for v in node)
        return node if name in ("scale", "table") else node.to(torch.bfloat16)
    return walk(params)
