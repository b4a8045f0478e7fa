"""SoC programs: transfer-in -> compute -> transfer-out pipelines.

An ``OffloadProgram`` is the offload tier's unit of work, run as a
tenant ``Process`` on a ``FabricRuntime``: stage the operands onto the
device (a ``Transfer`` in the shared ledger), execute the ops on the
device's roofline (a ``Compute`` reservation, fair-shared and
QoS-weighted like any flow), and stage results back. Because all three
stages live in one ledger, an offload program *contends honestly*: its
staging bytes fight the gradient traffic for the PCIe group and its
ops fight other programs for the device — nothing is a free lunch.

``OffloadStats`` is the host-cycles-saved / offload-hit accounting in
the idiom of SNIPPETS.md's smartnic_offload.py — backed by
an ``obs.metrics.MetricsRegistry`` (one ``Counter`` per field) with the
same public surface: a ``counters`` dict view plus a
``get_performance_stats()`` snapshot with the derived ratios.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from repro_torch.core.fabric import IN, OUT
from repro_torch.core.runtime import FabricRuntime, Process
from repro_torch.obs.metrics import MetricsRegistry

#: default QoS tag for offload-tier traffic (tenancy/qos registers it)
OFFLOAD = "offload"


class OffloadStats:
    """Offload accounting (smartnic_offload.py idiom): what ran on the
    SoC, and what the host therefore did not have to do.

    ``cpu_cycles_saved`` counts host ops avoided 1:1 with the ops
    executed off-host (byte-granular work: one op per byte, so this is
    also "host bytes not touched"); ``packets_offloaded`` counts results
    filtered out on the SoC that never crossed the host wire.

    The fields live as ``Counter`` metrics in a ``MetricsRegistry``
    (pass one to share a registry across consumers); ``counters``
    remains the dict-shaped snapshot the pre-obs implementation
    exposed."""

    _FIELDS = ("cpu_cycles_saved", "compression_operations_offloaded",
               "compression_bytes_in", "compression_bytes_out",
               "packets_offloaded", "packets_total", "programs_run",
               "ops_executed")

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.metrics = registry if registry is not None else MetricsRegistry()
        for name in self._FIELDS:
            self.metrics.counter(name)
        # cycles/ops accumulate fractional op counts; start them float
        self.metrics.counter("cpu_cycles_saved").value = 0.0
        self.metrics.counter("ops_executed").value = 0.0

    @property
    def counters(self) -> Dict[str, float]:
        return {name: self.metrics.counter(name).value
                for name in self._FIELDS}

    # -- recording ------------------------------------------------------
    def record_program(self, ops: float) -> None:
        self.metrics.counter("programs_run").inc(1)
        self.metrics.counter("ops_executed").inc(ops)

    def record_compression(self, bytes_in: int, bytes_out: int, *,
                           ops: Optional[float] = None,
                           offloaded: bool = True) -> None:
        """One codec run. ``offloaded=False`` records a host-side run
        for the comparison denominators without crediting savings."""
        self.metrics.counter("compression_bytes_in").inc(bytes_in)
        self.metrics.counter("compression_bytes_out").inc(bytes_out)
        if offloaded:
            self.metrics.counter("compression_operations_offloaded").inc(1)
            self.metrics.counter("cpu_cycles_saved").inc(
                ops if ops is not None else float(bytes_in))

    def record_filter(self, scanned: int, matched: int, *,
                      ops: Optional[float] = None) -> None:
        """One SoC-side filter pass: ``scanned`` candidates examined on
        the SoC, ``matched`` survivors forwarded to the host — the
        difference never crossed the wire."""
        self.metrics.counter("packets_total").inc(scanned)
        self.metrics.counter("packets_offloaded").inc(scanned - matched)
        self.metrics.counter("cpu_cycles_saved").inc(
            ops if ops is not None else float(scanned))

    # -- reporting ------------------------------------------------------
    def get_performance_stats(self) -> Dict[str, float]:
        c = dict(self.counters)
        c["compression_ratio"] = (
            c["compression_bytes_out"] / c["compression_bytes_in"]
            if c["compression_bytes_in"] else 0.0)
        c["offload_hit_rate"] = (
            c["packets_offloaded"] / c["packets_total"]
            if c["packets_total"] else 0.0)
        return c

    def __repr__(self) -> str:
        s = self.get_performance_stats()
        return (f"OffloadStats(cycles_saved={s['cpu_cycles_saved']:.3g}, "
                f"compressions={s['compression_operations_offloaded']}, "
                f"hit_rate={s['offload_hit_rate']:.2f})")


class OffloadProgram:
    """One transfer-in -> compute -> transfer-out pipeline template.

    ``launch`` spawns the pipeline as a Process; every stage carries the
    program's tenant tag, so a QoS policy weighs offload traffic
    against the serve/train tenants it shares paths and devices with.
    Stages with zero amount are skipped (a filter program that reads
    device-resident data has no transfer-in)."""

    def __init__(self, runtime: FabricRuntime, name: str, *,
                 tenant: Optional[str] = OFFLOAD,
                 stats: Optional[OffloadStats] = None):
        self.runtime = runtime
        self.name = name
        self.tenant = tenant
        self.stats = stats if stats is not None else OffloadStats()

    def launch(self, *, compute: str, ops: float,
               in_path: Optional[str] = None, in_bytes: float = 0.0,
               out_path: Optional[str] = None, out_bytes: float = 0.0,
               in_direction: str = OUT, out_direction: str = IN,
               max_rate: float = math.inf, flow: Optional[str] = None,
               on_done: Optional[Callable[[Process], None]] = None,
               ) -> Process:
        """Run one pipeline instance. Returns its Process (yieldable;
        ``result`` is the simulated completion time)."""
        flow = flow if flow is not None else self.name
        proc = self.runtime.process(
            self._body(compute, ops, in_path, in_bytes, out_path, out_bytes,
                       in_direction, out_direction, max_rate, flow),
            name=f"offload:{self.name}")
        if on_done is not None:
            proc._waiters.append(lambda _res: on_done(proc))
        return proc

    def _body(self, compute, ops, in_path, in_bytes, out_path, out_bytes,
              in_direction, out_direction, max_rate, flow):
        rt = self.runtime
        span = rt.tracer.begin_phase(f"offload:{self.name}",
                                     tenant=self.tenant, flow=flow,
                                     compute=compute, ops=ops) \
            if rt._trace else None
        if in_path is not None and in_bytes > 0:
            yield rt.transfer(in_path, in_bytes, direction=in_direction,
                              flow=f"{flow}:in", tenant=self.tenant)
        if ops > 0:
            yield rt.compute(compute, ops, flow=f"{flow}:ops",
                             max_rate=max_rate, tenant=self.tenant)
        if out_path is not None and out_bytes > 0:
            yield rt.transfer(out_path, out_bytes, direction=out_direction,
                              flow=f"{flow}:out", tenant=self.tenant)
        self.stats.record_program(ops)
        if span is not None:
            rt.tracer.end_phase(span)
        return rt.clock.now
