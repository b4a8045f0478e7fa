"""Gemma-2 9B  [arXiv:2408.00118] — local+global alternating attention,
logit softcapping, GeGLU."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    rope_theta=10000.0,
    window_size=4096,
    local_global_period=2,
    attn_logit_softcap=50.0,
    final_logit_softcap=30.0,
    mlp_activation="gelu",
    tie_embeddings=True,
    embed_scale=True,
    source="arXiv:2408.00118",
)
