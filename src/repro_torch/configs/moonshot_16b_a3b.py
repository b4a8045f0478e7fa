"""Moonlight 16B-A3B  [hf:moonshotai/Moonlight-16B-A3B] — MoE 64 experts
top-6, per-expert d_ff=1408."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    num_experts_per_tok=6,
    mlp_activation="silu",
    source="hf:moonshotai/Moonlight-16B-A3B",
)
