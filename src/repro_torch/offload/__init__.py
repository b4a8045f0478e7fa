"""The SoC compute tier (paper premise: an off-path SoC that computes).

``device``       per-device rooflines (BF-2 ARM complex, DCA engine,
                 host socket) as compute-tier fabric Paths.
``program``      transfer-in -> compute -> transfer-out pipelines as
                 tenant Processes, plus the smartnic-idiom OffloadStats.
``compression``  checkpoint-compression offload: the real codecs as an
                 SoC tenant (bit-identical bytes, relocated cycles).
``kvfilter``     DrTM-KV-style get/put filtering on the SoC path.
"""
from repro_torch.offload.device import (BF2_ARM, BF2_DCA, DEVICES, HOST_CPU,
                                        DeviceSpec, node_compute_paths)
from repro_torch.offload.program import OFFLOAD, OffloadProgram, OffloadStats
from repro_torch.offload.compression import (CKPT_RATIO, CODEC_OPS_PER_BYTE,
                                             SoCCompressor, codec_ops,
                                             compression_program, host_compressor)
from repro_torch.offload.kvfilter import (FilterPlan, FilterScan, HOST_FILTER,
                                          KVFilter, SOC_FILTER,
                                          kv_filter_alternatives,
                                          plan_filter_placement)

__all__ = [
    "BF2_ARM", "BF2_DCA", "DEVICES", "HOST_CPU", "DeviceSpec",
    "node_compute_paths",
    "OFFLOAD", "OffloadProgram", "OffloadStats",
    "CKPT_RATIO", "CODEC_OPS_PER_BYTE", "SoCCompressor", "codec_ops",
    "compression_program", "host_compressor",
    "FilterPlan", "FilterScan", "HOST_FILTER", "KVFilter", "SOC_FILTER",
    "kv_filter_alternatives", "plan_filter_placement",
]
