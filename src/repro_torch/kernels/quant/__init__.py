from repro_torch.kernels.quant.ops import dequantize, quantize  # noqa: F401
