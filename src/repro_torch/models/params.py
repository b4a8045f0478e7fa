"""Parameter initialization, the counterpart of ``repro/models/params.py``.

Layers are stacked as in the JAX package: ``params["layers"]`` is a tuple
of per-slot dicts whose tensors carry a leading ``G = L / period`` group
dim. Layouts are the JAX ones: ``wq (D,H,hd)``, ``wo (H,hd,D)``,
``w_in (D,2,F)``, ``w_out (F,D)``. Master weights are f32.

Every slot kind of the JAX package: attention (``wq``, ``wk``, ``wv``,
``wo``) or Mamba2 SSM (``w_xz (D,2,Di)``, ``w_bc (D,2,N)``, ``w_dt (D,H)``,
``conv_* (K,·)``, ``out (Di,D)``), then a dense MLP or an MoE FFN
(``router (D,E)``, ``w_in (E,D,2,F)``, ``w_out (E,F,D)``; E the experts
held here, ``held_experts``, and the router over every expert), beside
it a shared expert where the config has one (``shared``: ``w_in
(D,2,Fs)``, ``w_out (Fs,D)``), and a Mamba2 slot of a config with
``ssm_conv_bias`` the conv biases ``conv_x_bias (Di,)``,
``conv_b_bias``/``conv_c_bias (N,)``. Codebook
configs embed and unembed with ``(C,V,D)`` tables; a frontend adds no
params (its embeddings come precomputed, as in the JAX package).

A parallel tree of logical-axis tuples (``_logical_only``) drives
sharding (``parallel/sharding.py``); ``abstract_params`` gives the shapes
on the ``meta`` device, with no allocation.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch._device import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.port import held_experts, option
from repro_torch.parallel.sharding import is_logical, tree_map

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
    """Raise on a config the model cannot run: query heads that do not
    group over the kv heads, more experts a token than the layer has, or
    more experts held than it has. Every arch of the registry passes."""
    layer_period(cfg)
    if cfg.num_heads and (not cfg.num_kv_heads or cfg.num_heads % cfg.num_kv_heads):
        raise ValueError(f"{cfg.name}: {cfg.num_heads} q heads do not group over "
                         f"{cfg.num_kv_heads} kv heads")
    if cfg.num_experts and not 0 < cfg.num_experts_per_tok <= cfg.num_experts:
        raise ValueError(f"{cfg.name}: top-{cfg.num_experts_per_tok} routing over "
                         f"{cfg.num_experts} experts")
    if not 0 <= option(cfg, "experts_held") <= cfg.num_experts:
        raise ValueError(f"{cfg.name}: {option(cfg, 'experts_held')} experts held of "
                         f"{cfg.num_experts}")


def _attn_shapes(cfg: ModelConfig):
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {
        "wq": ((d, hq, hd), ("fsdp", "heads", None)),
        "wk": ((d, hkv, hd), ("fsdp", "kv_heads", None)),
        "wv": ((d, hkv, hd), ("fsdp", "kv_heads", None)),
        "wo": ((hq, hd, d), ("heads", None, "fsdp")),
    }
    return shapes


def _mlp_shapes(cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_in": ((d, 2, f), ("fsdp", None, "mlp")),
        "w_out": ((f, d), ("mlp", "fsdp")),
    }


def _moe_shapes(cfg: ModelConfig):
    d, f, e = cfg.d_model, cfg.d_ff, held_experts(cfg)
    return {
        "router": ((d, e), ("fsdp", None)),
        "w_in": ((e, d, 2, f), ("experts", "fsdp", None, None)),
        "w_out": ((e, f, d), ("experts", None, "fsdp")),
    }


def _ssm_shapes(cfg: ModelConfig):
    d, din, n, h, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                       cfg.ssm_heads, cfg.ssm_conv)
    return {
        "w_xz": ((d, 2, din), ("fsdp", None, "ssm_inner")),
        "w_bc": ((d, 2, n), ("fsdp", None, None)),
        "w_dt": ((d, h), ("fsdp", "ssm_inner")),
        "conv_x": ((k, din), (None, "ssm_inner")),
        "conv_b": ((k, n), (None, None)),
        "conv_c": ((k, n), (None, None)),
        "A_log": ((h,), ("ssm_inner",)),
        "D": ((h,), ("ssm_inner",)),
        "dt_bias": ((h,), ("ssm_inner",)),
        "norm": ((din,), ("ssm_inner",)),
        "out": ((din, d), ("ssm_inner", "fsdp")),
        **({"conv_x_bias": ((din,), ("ssm_inner",)), "conv_b_bias": ((n,), (None,)),
            "conv_c_bias": ((n,), (None,))} if option(cfg, "ssm_conv_bias") else {}),
    }


def _shared_shapes(cfg: ModelConfig):
    """The always-on shared expert beside the MoE: a gated MLP of width
    ``shared_d_ff``."""
    d, f = cfg.d_model, option(cfg, "shared_d_ff")
    return {
        "w_in": ((d, 2, f), ("fsdp", None, "mlp")),
        "w_out": ((f, d), ("mlp", "fsdp")),
    }


def _normal(shape, std, generator, device):
    """N(0, std²) in f32, as ``_init_dense`` draws it (``params.py:97``)."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    t.normal_(0.0, 1.0, generator=generator)
    return t.mul_(std)


def _init_ssm(cfg: ModelConfig, g: int, dense, ones, generator, device) -> dict:
    """One SSM slot with the JAX distributions (``params.py:79-94,119-139``):
    A = U[1, 16] stored as its log; dt_bias the inverse softplus of dt
    log-uniform in [1e-3, 1e-1]; D and the gated norm's scale ones;
    ``conv_*`` of fan-in ``ssm_conv``; the products of fan-in ``shape[0]``."""
    d, din, n, h, k = (cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads,
                       cfg.ssm_conv)

    def uniform(lo, hi):
        u = torch.empty((g, h), dtype=torch.float32, device=device)
        return u.uniform_(lo, hi, generator=generator)

    dt = torch.exp(uniform(0.0, 1.0) * (math.log(0.1) - math.log(1e-3))
                   + math.log(1e-3))
    bias = ({"conv_x_bias": dense((din,), k), "conv_b_bias": dense((n,), k),
             "conv_c_bias": dense((n,), k)} if option(cfg, "ssm_conv_bias") else {})
    return {**bias,
            "w_xz": dense((d, 2, din), d),
            "w_bc": dense((d, 2, n), d),
            "w_dt": dense((d, h), d),
            "conv_x": dense((k, din), k),
            "conv_b": dense((k, n), k),
            "conv_c": dense((k, n), k),
            "A_log": torch.log(uniform(1.0, 16.0)),
            "D": ones(h),
            "dt_bias": dt + torch.log(-torch.expm1(-dt)),
            "norm": ones(din),
            "out": dense((din, d), din)}


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

    vshape = ((cfg.num_codebooks, cfg.vocab_size, d) if cfg.num_codebooks > 1
              else (cfg.vocab_size, d))
    params: dict = {"embed": {"table": _normal(vshape, 0.02, generator, device)}}
    layers = []
    for slot in range(layer_period(cfg)):
        kind = slot_kind(cfg, slot)
        p: dict = {"norm1": {"scale": ones(d)}}
        if kind["kind"] == "attn":
            p["attn"] = {"wq": dense((d, hq, hd), d),
                         "wk": dense((d, hkv, hd), d),
                         "wv": dense((d, hkv, hd), d),
                         "wo": dense((hq, hd, d), cfg.q_dim)}
        else:
            p["ssm"] = _init_ssm(cfg, g, dense, ones, generator, device)
        if kind["has_ffn"]:
            p["norm2"] = {"scale": ones(d)}
        if kind["has_ffn"] and kind["moe"]:        # params.py:70-76, fan-in D, D, F
            e = held_experts(cfg)
            p["moe"] = {"router": dense((d, cfg.num_experts), d),
                        "w_in": dense((e, d, 2, f), d), "w_out": dense((e, f, d), f)}
            fs = option(cfg, "shared_d_ff")
            if fs:
                p["shared"] = {"w_in": dense((d, 2, fs), d), "w_out": dense((fs, d), fs)}
        elif kind["has_ffn"]:
            p["mlp"] = {"w_in": dense((d, 2, f), d), "w_out": dense((f, d), f)}
        layers.append(p)
    params["layers"] = tuple(layers)
    params["final_norm"] = {"scale": torch.ones((d,), dtype=torch.float32,
                                                device=device)}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": _normal(vshape, 0.02, generator, device)}
    return params


def param_count_tree(params: PyTree) -> int:
    """The number of values in a tree of tensors (dicts, tuples and lists
    of them), as the JAX function sums ``x.size`` over its leaves."""
    if isinstance(params, dict):
        return sum(param_count_tree(v) for v in params.values())
    if isinstance(params, (tuple, list)):
        return sum(param_count_tree(v) for v in params)
    return params.numel()


#: leaves that ``compute_copy`` keeps in f32
F32_LEAVES = ("scale", "table", "A_log", "D", "dt_bias", "norm", "router")


def compute_copy(params: PyTree) -> PyTree:
    """A bf16 copy of every matrix, made once at load.

    The JAX model casts each f32 master weight to bf16 right before its
    product (``model.py:62-64,94-95,104-108``, ``layers.py:94-99``) and
    the SSM conv weights to the bf16 activations' dtype (``:115-117``); a
    copy cast once holds the same values and saves the cast on every
    step. Norm scales, the embedding table, the SSM's ``A_log``, ``D``,
    ``dt_bias`` and gated-norm ``norm``, and the MoE router stay f32: the
    JAX model reads them in f32 (``model.py:111,119,127,143``,
    ``moe.py:40``), and ``embed_tokens`` gathers f32 rows and casts only
    those."""
    def walk(node, name=""):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        if isinstance(node, tuple):
            return tuple(walk(v, name) for v in node)
        return node if name in F32_LEAVES else node.to(torch.bfloat16)
    return walk(params)


def abstract_params(cfg: ModelConfig) -> Tuple[PyTree, PyTree]:
    """(``init_params``'s tree on the ``meta`` device, logical axes): the
    shapes and dtypes with no allocation (the dry-run's)."""
    _, logical = _logical_only(cfg)
    return init_params(cfg, None, "meta"), logical


def _logical_only(cfg: ModelConfig):
    """The logical-axis tree, touching no tensor (``params.py:208-218``)."""
    vlogical = ((None, "vocab", "fsdp") if cfg.num_codebooks > 1
                else ("vocab", "fsdp"))
    logical: dict = {"embed": {"table": vlogical}}
    logical["layers"] = tuple(_slot_logical(cfg, slot)
                              for slot in range(layer_period(cfg)))
    logical["final_norm"] = {"scale": ("embed",)}
    if not cfg.tie_embeddings:
        logical["lm_head"] = {"w": vlogical}
    return None, logical


def _slot_logical(cfg: ModelConfig, slot: int):
    """One period slot's logical axes, each behind a leading
    "layer_group" (the stacked groups' dim)."""
    kind = slot_kind(cfg, slot)
    logical = {"norm1": {"scale": ("embed",)}}
    if kind["kind"] == "attn":
        logical["attn"] = {n: lg for n, (s, lg) in _attn_shapes(cfg).items()}
    else:
        logical["ssm"] = {n: lg for n, (s, lg) in _ssm_shapes(cfg).items()}
    if kind["has_ffn"]:
        logical["norm2"] = {"scale": ("embed",)}
        if kind["moe"]:
            logical["moe"] = {n: lg for n, (s, lg) in _moe_shapes(cfg).items()}
            if option(cfg, "shared_d_ff"):
                logical["shared"] = {n: lg for n, (s, lg) in _shared_shapes(cfg).items()}
        else:
            logical["mlp"] = {n: lg for n, (s, lg) in _mlp_shapes(cfg).items()}
    return tree_map(lambda lg: ("layer_group",) + lg, logical, is_leaf=is_logical)
