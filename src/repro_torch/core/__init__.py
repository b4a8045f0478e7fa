"""core: the fabric of communication paths (``fabric``), the
event-driven runtime that runs transfers over it in simulated time
(``runtime``), and the dry-run's path model, collective characterizer
and roofline (``paths``, ``charz``, ``roofline``); the package exports
the JAX package's ``repro.core`` names.

These are copies of the JAX package's jax-free modules of the same names
with the imports pointed at this package (``import repro`` loads jax):
the arithmetic is kept expression for expression, so simulated times,
rates and ledger state equal the JAX package's exactly. ``hw`` holds the
H100 constants the simulated fabric is built from, under the JAX
package's names. ``compression`` (the port's own int8 quantizer with the
JAX module's byte codecs and §5.1 model) and ``collectives`` (over
``torch.distributed``) are not imported here.
"""
from repro_torch.core import hw
from repro_torch.core.fabric import (Allocation, Alternative, BudgetLedger,
                                     Fabric, MultipathRouter, Path, Use,
                                     BYTES_PER_S, OPS_PER_S)
from repro_torch.core.runtime import (Event, FabricRuntime, Process, Signal,
                                      SimClock, Transfer)
from repro_torch.core.paths import PathSpec, enumerate_paths, collective_bytes_per_chip
from repro_torch.core.charz import parse_collectives, replay, summarize_traffic
from repro_torch.core.roofline import RooflineReport, build_report, model_flops_for

__all__ = [
    "hw",
    # fabric API (canonical)
    "Fabric", "Path", "Use", "Alternative", "Allocation",
    "BudgetLedger", "MultipathRouter", "BYTES_PER_S", "OPS_PER_S",
    # event-driven runtime
    "SimClock", "Event", "Signal", "Transfer", "Process", "FabricRuntime",
    # TPU fabric + traffic model
    "PathSpec", "enumerate_paths", "collective_bytes_per_chip",
    "parse_collectives", "summarize_traffic", "replay",
    "RooflineReport", "build_report", "model_flops_for",
]
