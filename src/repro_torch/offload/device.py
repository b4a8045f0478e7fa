"""Per-device compute rooflines for the offload tier.

The paper's premise is an off-path SoC that *computes*; this module is
where each computing device's envelope lives, calibrated against
"Performance Characteristics of the BlueField-2 SmartNIC" (PAPERS.md):
the BF-2's 8 ARM A72 cores are "wimpy" — a fraction of a host socket on
throughput work — and its single-channel DDR4 feeds them ~19 GB/s, so
byte-granular work (compression, filtering) is memory-shaped long
before it is core-shaped. "Demystifying Datapath Accelerator Enhanced
Off-path SmartNIC" (PAPERS.md) adds the third device class: a DCA-style
fixed-function engine with far higher streaming throughput than the
ARM complex but a real per-dispatch cost.

A ``DeviceSpec`` turns into a fabric ``Path`` (fabric.compute_path /
dca_path) whose capacity is the classic roofline
``min(peak_ops, intensity * mem_bw)`` at the workload's operational
intensity — for the byte-granular offload workloads in this repo one
op is one byte processed, so intensity defaults to 1 op/byte. Once the
device is a Path, ``FabricRuntime.compute`` reservations fair-share it
exactly like a wire: occupancy, QoS weights, the §4.1 discount on a
``shared_group``, and ledger conservation all come for free.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.fabric import COMPUTE, DCA, Path, compute_path, dca_path


@dataclass(frozen=True)
class DeviceSpec:
    """One computing device's roofline envelope.

    ``ops_per_core`` is sustained ops/s per core on the offload
    workloads (byte-granular: 1 op == 1 byte through a codec or
    predicate), ``mem_bw`` the memory system feeding the cores — the
    BF-2 lesson is that the second number binds first on the SoC."""
    name: str
    cores: int
    ops_per_core: float
    mem_bw: float
    dispatch_latency: float = 0.0      # doorbell/IPI cost per program
    kind: str = COMPUTE

    def __post_init__(self):
        if self.cores < 1 or self.ops_per_core <= 0 or self.mem_bw <= 0:
            raise ValueError(f"device {self.name}: non-positive envelope")

    @property
    def peak_ops(self) -> float:
        return self.cores * self.ops_per_core

    def roofline(self, intensity: float = 1.0) -> float:
        """Attainable ops/s at ``intensity`` ops per memory byte — the
        compute ceiling or the memory ceiling, whichever binds."""
        if intensity <= 0:
            raise ValueError("operational intensity must be > 0")
        return min(self.peak_ops, intensity * self.mem_bw)

    def path(self, name: Optional[str] = None, *, intensity: float = 1.0,
             shared_group: Optional[str] = None) -> Path:
        """This device as a compute-tier fabric Path (capacity = the
        roofline at ``intensity``)."""
        rate = self.roofline(intensity)
        if self.kind == DCA:
            return dca_path(name or self.name, rate,
                            latency=self.dispatch_latency,
                            shared_group=shared_group)
        return compute_path(name or self.name, rate,
                            latency=self.dispatch_latency,
                            shared_group=shared_group, kind=self.kind)


#: BlueField-2 ARM complex: 8x A72, single-channel DDR4. Codec-grade
#: throughput ~0.4 GB/s/core — wimpy next to a host socket (§3.2).
BF2_ARM = DeviceSpec("bf2-arm", cores=8, ops_per_core=0.4e9, mem_bw=19e9,
                     dispatch_latency=2e-6)

#: DCA-style datapath accelerator on the NIC: one fixed-function engine
#: with high streaming throughput but a real per-dispatch doorbell cost
#: (the "Demystifying DCA" characterization).
BF2_DCA = DeviceSpec("bf2-dca", cores=1, ops_per_core=10e9, mem_bw=12e9,
                     dispatch_latency=5e-6, kind=DCA)

#: The host socket the offload competes with: many fat cores behind a
#: multi-channel memory system.
HOST_CPU = DeviceSpec("host-cpu", cores=32, ops_per_core=0.5e9, mem_bw=80e9,
                      dispatch_latency=1e-6)

#: canonical specs by name (benches/launchers select by string)
DEVICES = {d.name: d for d in (BF2_ARM, BF2_DCA, HOST_CPU)}


def node_compute_paths(index: int, *, host=HOST_CPU, soc=BF2_ARM,
                       dca=BF2_DCA, intensity: float = 1.0) -> list:
    """The compute tier of one trainer node, as fabric Paths:
    ``cpu:host:i`` (the host socket), ``cpu:soc:i`` (the SoC's ARM
    complex) and ``dca:i`` (the NIC's datapath accelerator). Merged into
    the node's wire paths by train/cluster.train_fabric, so staging
    bytes and codec cycles live in one ledger."""
    return [
        host.path(f"cpu:host:{index}", intensity=intensity),
        soc.path(f"cpu:soc:{index}", intensity=intensity),
        dca.path(f"dca:{index}", intensity=intensity),
    ]
