"""IBM Granite 4.0-H Small, 32B-A9B
[hf:ibm-granite/granite-4.0-h-small, ``model_type`` granitemoehybrid]: 40
layers, 36 Mamba-2 and 4 GQA attention layers without position
embedding (NoPE, at layers 5, 15, 25 and 35), every layer followed by a
MoE of 72 experts (top-10) beside one always-on shared SwiGLU expert;
scalar multipliers on the embedding, on each residual branch, on the
attention scores and on the logits; a bias on the Mamba conv.

The JAX package has no such model: its fields beyond ``ModelConfig``'s
are ``configs/port.py``'s. ``CONFIG`` holds every expert; a
deployment's share is laid over it (``dataclasses.replace`` of
``experts_held``).
"""
from __future__ import annotations

from repro_torch.configs.port import HybridMoEConfig


CONFIG = HybridMoEConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,
    vocab_size=100352,
    num_experts=72,
    num_experts_per_tok=10,
    moe_period=1,
    attn_period=10,          # attention at slot 5 of each 10: layers 5, 15, 25, 35
    ssm_state=128,
    ssm_expand=2,            # 128 heads of 64
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=256,
    mlp_activation="silu",
    norm_eps=1 / 100_000,  # rms_norm_eps 1e-5, a quotient: the literal is a TPU constant
    tie_embeddings=True,
    shared_d_ff=1536,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    rope=False,
    ssm_conv_bias=True,
    source="hf:ibm-granite/granite-4.0-h-small",
)
