"""MusicGen-large  [arXiv:2306.05284] — decoder-only over EnCodec tokens,
4 codebooks (delay pattern handled by the audio frontend STUB), MHA."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_activation="gelu",
    frontend="audio",
    frontend_tokens=64,      # conditioning frames from the stub
    num_codebooks=4,
    source="arXiv:2306.05284",
)
