"""Input stand-ins and their shardings, the counterpart of
``repro/launch/inputs.py``: every model input as a tensor on the
``meta`` device (shape and dtype, no allocation: the dry-run's
contract), and the ``NamedSharding`` of each on a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import model as M
from repro_torch.models.model import init_cache_logical
from repro_torch.models.params import abstract_params
from repro_torch.optim.adamw import AdamWState, abstract_state, opt_logical
from repro_torch.parallel.sharding import (CONTEXT_PARALLEL_OVERRIDES, is_logical,
                                           named_sharding, tree_layout, tree_map,
                                           tree_shardings)


def Spec(shape, dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` (``jax.ShapeDtypeStruct``)."""
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Training/prefill batch: tokens/labels/mask (+ frontend embeds)."""
    b, s = shape.global_batch, shape.seq_len
    ft = cfg.frontend_tokens if cfg.frontend else 0
    s_text = s - ft
    cb = cfg.num_codebooks
    tok_shape = (b, s_text, cb) if cb > 1 else (b, s_text)
    lab_shape = (b, s, cb) if cb > 1 else (b, s)
    out = {
        "tokens": Spec(tok_shape, torch.int32),
        "labels": Spec(lab_shape if ft else tok_shape, torch.int32),
        "loss_mask": Spec((b, s), torch.float32),
    }
    if ft:
        out["frontend_embeds"] = Spec((b, ft, cfg.d_model), torch.float32)
    return out


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh) -> Dict[str, Any]:
    specs = batch_specs(cfg, shape)
    out = {}
    for k, v in specs.items():
        logical = ("batch",) + (None,) * (len(v.shape) - 1)
        out[k] = named_sharding(logical, mesh, dim_sizes=v.shape)
    return out


def decode_specs(cfg: ModelConfig, shape: ShapeConfig,
                 cache_dtype=torch.bfloat16) -> Tuple[Dict[str, torch.Tensor], Any, torch.Tensor]:
    """(token specs, cache specs, pos spec) for a decode step."""
    b, s = shape.global_batch, shape.seq_len
    cb = cfg.num_codebooks
    tok_shape = (b, 1, cb) if cb > 1 else (b, 1)
    tokens = {"tokens": Spec(tok_shape, torch.int32)}
    cache = M.abstract_cache(cfg, b, s, cache_dtype)[0]
    return tokens, cache, Spec((), torch.int32)


def decode_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                     context_parallel: bool = False):
    overrides = {}
    if context_parallel:
        overrides.update(CONTEXT_PARALLEL_OVERRIDES)
    elif cfg.num_kv_heads and "model" in mesh.shape and \
            cfg.num_kv_heads % mesh.shape["model"] != 0:
        # KV heads don't divide TP: shard the cache on its sequence dim
        # instead of replicating it TP-fold (the value store placed on the
        # path where reads stay cheap: no all-gather of the whole cache
        # every step)
        overrides["kv_seq"] = "model"
    overrides = overrides or None
    tokens, cache, _ = decode_specs(cfg, shape)
    tok_sh = {k: named_sharding(("batch",) + (None,) * (len(v.shape) - 1),
                                mesh, dim_sizes=v.shape, overrides=overrides)
              for k, v in tokens.items()}
    cache_sh = tree_map(
        lambda lg, spec: named_sharding(lg, mesh, dim_sizes=spec.shape,
                                        overrides=overrides),
        init_cache_logical(cfg), cache, is_leaf=is_logical)
    return tok_sh, cache_sh


def param_shardings(cfg: ModelConfig, mesh):
    shapes, logical = abstract_params(cfg)
    return shapes, logical, tree_shardings(logical, shapes, mesh)


def train_layout(cfg: ModelConfig, mesh, moments: str = "f32") -> Tuple[Any, AdamWState]:
    """(the params' ``BlockSpec`` tree, the AdamW state's) on ``mesh``:
    JAX's ``param_shardings`` and ``_opt_logical``, the layout a rank of
    the train step holds (``parallel/sharding.place``)."""
    shapes, logical = abstract_params(cfg)
    params = tree_layout(logical, shapes, mesh)
    if moments != "int8":
        return params, AdamWState(step=None, m=params, v=params)
    return params, tree_layout(opt_logical(logical, True),
                               abstract_state(shapes, moments=moments), mesh)
