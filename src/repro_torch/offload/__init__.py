"""The SoC compute tier (paper premise: an off-path SoC that computes).

``device``       per-device rooflines (BF-2 ARM complex, DCA engine,
                 host socket) as compute-tier fabric Paths.
``program``      transfer-in -> compute -> transfer-out pipelines as
                 tenant Processes, plus the smartnic-idiom OffloadStats.
``compression``  checkpoint-compression offload: the real codecs as an
                 SoC tenant (bit-identical bytes, relocated cycles).

Copies of the JAX package's modules of the same names, imports pointed
at this package. The KV filter (``kvfilter``) is not ported yet.
"""
from repro_torch.offload.device import (BF2_ARM, BF2_DCA, DEVICES, HOST_CPU,
                                        DeviceSpec, node_compute_paths)
from repro_torch.offload.program import OFFLOAD, OffloadProgram, OffloadStats
from repro_torch.offload.compression import (CKPT_RATIO, CODEC_OPS_PER_BYTE,
                                             SoCCompressor, codec_ops,
                                             compression_program, host_compressor)

__all__ = [
    "BF2_ARM", "BF2_DCA", "DEVICES", "HOST_CPU", "DeviceSpec",
    "node_compute_paths",
    "OFFLOAD", "OffloadProgram", "OffloadStats",
    "CKPT_RATIO", "CODEC_OPS_PER_BYTE", "SoCCompressor", "codec_ops",
    "compression_program", "host_compressor",
]
