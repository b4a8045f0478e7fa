"""Jamba-1.5-large 398B  [arXiv:2403.19887] — hybrid Mamba+attention 1:7
interleave, MoE 16 experts top-2 every other layer.

Deviation (as in the JAX package): Mamba-2 (SSD) blocks are used in place
of Mamba-1 so the SSD scan kernel is shared with mamba2-2.7b.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    num_experts=16,
    num_experts_per_tok=2,
    moe_period=2,
    attn_period=8,           # 1 attention layer per 8 (1:7 mamba:attn)
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    mlp_activation="silu",
    source="arXiv:2403.19887",
)
