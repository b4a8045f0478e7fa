from repro_torch.kernels.quant.ops import (dequantize, dequantize_int8,  # noqa: F401
                                           quantize, quantize_int8)
