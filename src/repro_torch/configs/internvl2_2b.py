"""InternVL2 2B  [arXiv:2404.16821] — InternViT frontend (STUB: precomputed
patch embeddings) + InternLM2-1.8B backbone."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=92553,
    rope_theta=1000000.0,
    mlp_activation="silu",
    frontend="vision",
    frontend_tokens=256,     # 448x448 / 14 patch / pixel-shuffle 0.5 => 256
    source="arXiv:2404.16821",
)
