"""repro_torch: the PyTorch + CUDA port of ``repro`` for one NVIDIA H100.

It imports torch and never jax, and nothing of the JAX package ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
