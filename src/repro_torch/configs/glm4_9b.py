"""GLM-4 9B  [hf:THUDM/glm-4-9b] — dense, RoPE (partial rotary), GQA kv=2."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=151552,
    rope_theta=10000.0,
    rope_fraction=0.5,
    mlp_activation="silu",
    source="hf:THUDM/glm-4-9b",
)
