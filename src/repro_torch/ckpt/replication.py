"""Replication planning + simulation — the LineFS §5.1 decision,
parameterized by the checkpoint's measured compression ratio and the
live fabric budgets.

`plan_replication` builds the LineFS fabric, ranks A1/A2/A3 with the
MultipathRouter and returns the greedy combination plus predicted
bandwidths; CheckpointManager and the bench
(benchmarks/bench_replication.py) consume it. The same analysis drives
RunConfig.ckpt_compress.

`simulate_replication` executes the chosen offload path on the
event-driven fabric runtime as chunked two-stage transfers — stage the
raw chunk over the offload path (A2's ③* DMA by default, A1's shared
internal link optionally), then send the compressed chunk over the
network — either sequentially or pipelined (chunk i+1 stages while
chunk i is on the wire). The pipeline overlap is the paper's ~30%
LineFS win, reproduced as a simulated-latency assertion in
tests/test_runtime.py.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional

from repro_torch.core import hw
from repro_torch.core.fabric import (Allocation, Fabric, MultipathRouter,
                               linefs_fabric, linefs_replication_alternatives)
from repro_torch.core.runtime import FabricRuntime, Signal


@dataclass
class ReplicationPlan:
    ranked: List[str]
    allocations: List[Allocation]
    total_rate: float                # bytes/s of checkpoint data replicated
    use_compression: bool
    notes: str


def plan_replication(*, ratio: float,
                     net_bw: float = hw.DCN_BW_PER_CHIP,
                     staging_bw: float = hw.PCIE_BW,
                     soc_rate: Optional[float] = None,
                     fabric: Optional[Fabric] = None) -> ReplicationPlan:
    """ratio = compressed/raw (from the last checkpoint's stats).

    net_bw: replication network budget per host (DCN).
    staging_bw: host staging link (PCIe), the paper's P.
    soc_rate: compression throughput cap (None = unbounded).
    fabric: pre-built fabric to plan on (defaults to the LineFS fabric
    at the given bandwidths).
    """
    fabric = fabric if fabric is not None else linefs_fabric(net_bw, staging_bw)
    alts = linefs_replication_alternatives(
        net_bw, staging_bw, ratio,
        soc_rate=soc_rate if soc_rate else math.inf)
    router = MultipathRouter(fabric)
    # paper §5.1: A2 dominates A1 (same traffic, no double-crossing);
    # rank A2 vs A3 by solo rate, then combine greedily.
    a1, a2, a3 = alts
    ranked = router.rank([a2, a3])
    allocs, total = router.allocate(ranked)
    use_comp = ranked[0].name == "A2"
    return ReplicationPlan(
        ranked=[a.name for a in ranked],
        allocations=allocs,
        total_rate=total,
        use_compression=use_comp,
        notes=(f"ratio={ratio:.2f}: A1={a1.solo_rate(fabric)/1e9:.1f} "
               f"A2={a2.solo_rate(fabric)/1e9:.1f} "
               f"A3={a3.solo_rate(fabric)/1e9:.1f} GB/s; "
               f"combined={total/1e9:.1f} GB/s"),
    )


# ----------------------------------------------------------------------
# simulated-time execution (LineFS pipelining, paper §5.1)
# ----------------------------------------------------------------------

@dataclass
class ReplicationTiming:
    """Result of a simulated chunked replication."""
    seconds: float                    # completion time of the last chunk
    pipelined: bool
    chunks: int
    chunk_bytes: float
    ratio: float
    stage_path: str
    net_path: str
    chunk_finish_s: List[float] = field(default_factory=list)
    # per-chunk completion timestamps (since start) — percentile columns

    def percentile(self, q: float) -> float:
        """q-th percentile (0..100) of the chunk *completion times*
        since start (cumulative timestamps, not per-chunk transfer
        latencies): percentile(50) is when half the chunks were durable
        on the replica — the replication-progress curve."""
        lats = sorted(self.chunk_finish_s)
        if not lats:
            return 0.0
        idx = min(len(lats) - 1, int(math.ceil(q / 100.0 * len(lats))) - 1)
        return lats[max(idx, 0)]


def simulate_replication(total_bytes: float, ratio: float, *,
                         chunks: int = 8, pipelined: bool = True,
                         net_bw: float = hw.DCN_BW_PER_CHIP,
                         staging_bw: float = hw.PCIE_BW,
                         fabric: Optional[Fabric] = None,
                         stage_path: str = "dma", net_path: str = "net",
                         runtime: Optional[FabricRuntime] = None,
                         ) -> ReplicationTiming:
    """Replicate ``total_bytes`` of checkpoint data as ``chunks``
    two-stage transfers on the LineFS fabric: stage the raw chunk over
    ``stage_path`` (③* DMA for A2, "internal" for A1's double-crossing
    path), then send ``ratio`` x the bytes over ``net_path``.

    ``pipelined=False`` runs stage->send->stage->send strictly in
    order; ``pipelined=True`` lets chunk i+1 stage while chunk i is on
    the network — the transfers live on different interference groups,
    so the runtime overlaps them and the LineFS pipelining win falls
    out of the timeline instead of being asserted as a constant."""
    if chunks < 1:
        raise ValueError("chunks must be >= 1")
    fabric = fabric if fabric is not None else linefs_fabric(net_bw, staging_bw)
    rt = runtime if runtime is not None else FabricRuntime(fabric)
    start = rt.clock.now
    chunk = total_bytes / chunks
    finish: List[float] = []

    if pipelined:
        staged_upto = [0]               # chunks staged so far
        advanced = Signal(rt.clock)

        def stage_proc():
            for i in range(chunks):
                yield rt.transfer(stage_path, chunk, flow=f"stage:{i}")
                staged_upto[0] = i + 1
                advanced.fire()

        def send_proc():
            for i in range(chunks):
                while staged_upto[0] <= i:
                    yield advanced
                yield rt.transfer(net_path, chunk * ratio, flow=f"send:{i}")
                finish.append(rt.clock.now - start)

        rt.process(stage_proc(), name="replication-stage")
        rt.process(send_proc(), name="replication-send")
    else:
        def serial_proc():
            for i in range(chunks):
                yield rt.transfer(stage_path, chunk, flow=f"stage:{i}")
                yield rt.transfer(net_path, chunk * ratio, flow=f"send:{i}")
                finish.append(rt.clock.now - start)

        rt.process(serial_proc(), name="replication-serial")

    # stop at our own completion: a shared runtime's later events stay put
    rt.clock.run(stop=lambda: len(finish) == chunks)
    if len(finish) != chunks:
        raise RuntimeError(f"replication stalled: {len(finish)}/{chunks} "
                           "chunks completed (insufficient path budget?)")
    return ReplicationTiming(seconds=finish[-1], pipelined=pipelined,
                             chunks=chunks, chunk_bytes=chunk, ratio=ratio,
                             stage_path=stage_path, net_path=net_path,
                             chunk_finish_s=finish)
