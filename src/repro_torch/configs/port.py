"""Model config fields of the port alone, beside ``configs/base.py``.

The JAX package has none of these fields, and ``configs/base.py`` must
stay its copy, so they live on a subclass of the port's own
(``HybridMoEConfig``); a config module that needs them builds its
``CONFIG`` from it, and ``registry.get_config`` resolves it from a table
beside the JAX package's ten archs. The model reads each field through
``option``, which gives a plain ``ModelConfig`` the default: every
default leaves the other archs as they are.

``experts_held`` is the chip's share of an expert-parallel deployment:
the router keeps all ``num_experts`` outputs and its top-k, and the
layer computes the part of the result that experts ``[0,
experts_held)`` give (``models/moe.py``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class HybridMoEConfig(ModelConfig):
    """``ModelConfig`` with the granitemoehybrid fields."""

    experts_held: int = 0                # 0 => every expert; else experts [0, n) here
    shared_d_ff: int = 0                 # the always-on shared expert's width (0 => none)
    embedding_multiplier: float = 1.0    # x = m * E[ids]
    residual_multiplier: float = 1.0     # x = x + m * branch(x)
    attention_multiplier: Optional[float] = None   # softmax scale; None => 1/sqrt(head_dim)
    logits_scaling: float = 1.0          # logits = head(x) / s
    rope: bool = True                    # False => NoPE: no rotary embedding
    ssm_conv_bias: bool = False          # a bias on the Mamba depthwise conv

    def param_count(self) -> int:
        """What ``models/params.py`` builds: the held experts of each MoE
        layer, the shared expert, the conv biases."""
        d, f = self.d_model, self.d_ff
        total = super().param_count()
        for i in range(self.num_layers):
            if self.is_moe_layer(i):
                total -= (self.num_experts - held_experts(self)) * 3 * d * f
                total += 3 * d * self.shared_d_ff
            if not self.is_attention_layer(i) and self.ssm_state and self.ssm_conv_bias:
                total += self.d_inner + 2 * self.ssm_state
        return total


_DEFAULTS = {f.name: f.default for f in dataclasses.fields(HybridMoEConfig)
             if f.name not in {g.name for g in dataclasses.fields(ModelConfig)}}


def option(cfg: ModelConfig, name: str):
    """``cfg``'s value of a ``HybridMoEConfig`` field, or its default where
    ``cfg`` is a plain ``ModelConfig``."""
    return getattr(cfg, name, _DEFAULTS[name])


def held_experts(cfg: ModelConfig) -> int:
    """The experts an MoE layer computes here: ``experts_held``, or all."""
    return option(cfg, "experts_held") or cfg.num_experts
