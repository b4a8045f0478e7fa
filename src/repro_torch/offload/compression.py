"""Checkpoint-compression offload (the LineFS §5.1 workload, computed).

Two halves, deliberately separated:

*The bytes are real.* ``SoCCompressor`` is a ``save_checkpoint``
``compressor=`` hook that runs the *canonical* codec from
core/compression.py (the same table ckpt/checkpoint.py uses), so a
checkpoint "compressed on the SoC" is bit-identical to one compressed
on the host — placement moves cycles, never bytes (asserted in
tests/test_offload.py). What changes is the accounting: every run is
recorded as host cycles saved in ``OffloadStats``.

*The cycles are simulated.* ``compression_program`` runs the same save
as a FabricRuntime pipeline: stage the raw shard toward the device,
spend ``bytes x CODEC_OPS_PER_BYTE`` ops on the device's roofline,
stage the compressed bytes out. train/cluster.py's soc-compress /
host-compress staging modes inline this shape into the step loop (with
pause-safe re-issue), which is what makes the host-vs-SoC crossover
*emerge* from scheduling: under host-side load the compressed-bytes
win on the loaded wire beats the DCA's slower codec; idle, the host's
fat cores win outright.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

from repro_torch.core.compression import byte_codec, default_codec
from repro_torch.core.fabric import OUT
from repro_torch.core.runtime import FabricRuntime, Process
from repro_torch.offload.device import BF2_ARM, DeviceSpec
from repro_torch.offload.program import OFFLOAD, OffloadProgram, OffloadStats

#: modeled codec cost in ops per input byte (1 op == 1 byte through the
#: codec at the device's roofline; zlib is the slower, denser codec)
CODEC_OPS_PER_BYTE: Dict[str, float] = {"zstd": 1.0, "zlib": 2.5, "none": 0.0}

#: modeled compressed fraction for mixed fp32/int8 training state — the
#: wire sees this many bytes per raw byte after a compress-then-stage
CKPT_RATIO = 0.5


def codec_ops(nbytes: float, codec: Optional[str] = None) -> float:
    """Ops to push ``nbytes`` through ``codec`` (default: the codec a
    compressing save would pick)."""
    codec = codec if codec is not None else default_codec(True)
    return nbytes * CODEC_OPS_PER_BYTE.get(codec, 1.0)


class SoCCompressor:
    """``save_checkpoint(compressor=...)`` hook: same codec, same bytes,
    SoC-side accounting.

    The host-side twin is ``host_compressor(stats)`` — it runs the
    identical codec and records the run with ``offloaded=False``, so a
    bench comparing placements has both denominators."""

    def __init__(self, *, device: DeviceSpec = BF2_ARM,
                 stats: Optional[OffloadStats] = None):
        self.device = device
        self.stats = stats if stats is not None else OffloadStats()

    def __call__(self, codec: str, raw: bytes) -> bytes:
        _ext, comp, _decomp = byte_codec(codec)
        payload = comp(raw)
        self.stats.record_compression(len(raw), len(payload),
                                      ops=codec_ops(len(raw), codec))
        return payload


def host_compressor(stats: OffloadStats):
    """The host-placement twin of ``SoCCompressor``: identical codec and
    bytes, recorded without crediting offload savings."""
    def run(codec: str, raw: bytes) -> bytes:
        _ext, comp, _decomp = byte_codec(codec)
        payload = comp(raw)
        stats.record_compression(len(raw), len(payload), offloaded=False)
        return payload
    return run


def compression_program(runtime: FabricRuntime, *, nbytes: float,
                        compute: str, stage_path: str,
                        ratio: float = CKPT_RATIO,
                        codec: Optional[str] = None,
                        tenant: Optional[str] = OFFLOAD,
                        stats: Optional[OffloadStats] = None,
                        flow: str = "ckpt-compress") -> Process:
    """One compress-then-stage checkpoint save as a runtime pipeline:
    ``nbytes`` through the codec on ``compute``, then ``ratio * nbytes``
    over ``stage_path`` (compress where the cycles live, stage the
    compressed bytes over that side's wire). Returns the Process."""
    stats = stats if stats is not None else OffloadStats()
    prog = OffloadProgram(runtime, flow, tenant=tenant, stats=stats)
    stats.record_compression(int(nbytes), int(ratio * nbytes),
                             ops=codec_ops(nbytes, codec))
    return prog.launch(compute=compute, ops=codec_ops(nbytes, codec),
                       out_path=stage_path, out_bytes=ratio * nbytes,
                       out_direction=OUT, flow=flow)
