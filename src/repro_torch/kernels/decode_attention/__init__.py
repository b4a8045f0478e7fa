from repro_torch.kernels.decode_attention.ops import decode_attention_kernel  # noqa: F401
