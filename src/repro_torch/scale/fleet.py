"""An SLO tenant fleet: N serving engines on one FabricRuntime.

The third leg of the scale/ subsystem: ``ServeFleet`` runs one
``StagedServeEngine`` per ``FleetTenantSpec`` as tenants of a single
runtime/ledger, fed open-loop by per-tenant ``ArrivalGenerator``s.
Every tenant's prefill *and* base decode ride one shared host path
(``fleet:host``), so the §4.1 concurrency discount, weighted fair
shares, and cross-tenant interference all emerge from the one timeline
— and scaling a tenant's decode out to a ``fleet:replica:<r>`` path
(``Autoscaler`` + the engine's decode replica pool) visibly returns
host bandwidth to everyone's prefill.

Tenant knobs per spec: a ``TraceSpec`` (its load), a TTFT SLO, a QoS
class/weight (fair-share rates), a priority (K-tenant admission
arbitration order: ``FleetAdmissionController`` pauses the
lowest-priority tenant's intake when a higher-priority tenant's SLO is
violated), and optionally an ``AutoscaleConfig`` (its decode
autoscaler, drawing replica paths from the fleet-shared
``ReplicaPool``).

Determinism: arrivals are seeded per tenant, engine compute is the sim
token stream, and every control action (scale, pause) only moves bytes
between paths or defers dispatch — so a tenant's served token streams
are bit-identical across static vs autoscaled vs arbitrated runs of
the same specs (asserted in tests/test_scale.py).

``headline_fleet`` pins the paper-style experiment: a latency tenant
under a 10x diurnal burst next to a steady standard tenant; the static
fleet's attainment collapses during the burst, the autoscaled fleet
holds its SLO (benchmarks/bench_scale.py reports both).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from repro_torch.core import hw
from repro_torch.core.fabric import Fabric, Path
from repro_torch.core.runtime import FabricRuntime
from repro_torch.scale.arrivals import ArrivalGenerator, TraceSpec, burst_trace
from repro_torch.scale.autoscale import (AutoscaleConfig, Autoscaler, ReplicaPool,
                                         ttft_attainment)
from repro_torch.serve.engine import Request, ServeTimeModel, StagedServeEngine
from repro_torch.tenancy.admission import AdmittedTenant, FleetAdmissionController
from repro_torch.tenancy.colocation import _OccupancySampler, serve_metrics
from repro_torch.tenancy.qos import LATENCY, QoSPolicy, Tenant


def fleet_fabric(*, host_bw: float = 1000.0, replica_bw: float = 400.0,
                 replicas: int = 3,
                 concurrency_discount: float = 0.1) -> Fabric:
    """The fleet substrate: one shared host path every tenant's prefill
    and base decode contend on, plus ``replicas`` pre-provisioned
    replica-private paths the autoscalers can move decode traffic to.
    Units are abstract (the serve time models speak path-units, not
    bytes); the discount is the §4.1 concurrency penalty."""
    paths = [Path("fleet:host", host_bw, latency=hw.PCIE_LAT, kind="pcie")]
    for r in range(replicas):
        paths.append(Path(f"fleet:replica:{r}", replica_bw,
                          latency=hw.PCIE_LAT, kind="pcie"))
    return Fabric.of(*paths, concurrency_discount=concurrency_discount)


def replica_paths_of(fabric: Fabric) -> List[str]:
    return [name for name in fabric if name.startswith("fleet:replica:")]


@dataclass(frozen=True)
class FleetTenantSpec:
    """One tenant of the fleet: its load, SLO, QoS standing, and
    (optionally) its autoscaling policy."""
    name: str
    trace: TraceSpec
    slo_ttft: float
    tenant_class: str = LATENCY
    weight: float = 1.0
    priority: int = 0
    seed: int = 0
    slots: int = 8
    max_inflight_prefills: int = 4
    autoscale: Optional[AutoscaleConfig] = field(
        default_factory=AutoscaleConfig)

    def __post_init__(self):
        if self.slo_ttft <= 0:
            raise ValueError(f"tenant {self.name}: slo_ttft must be > 0")

    def tenant(self) -> Tenant:
        return Tenant(self.name, self.tenant_class, self.weight,
                      self.priority)


# ----------------------------------------------------------------------
# reports
# ----------------------------------------------------------------------

@dataclasses.dataclass
class TenantReport:
    """One tenant's outcome: serve metrics + SLO attainment + the scale
    trail (engine-side scale events and autoscaler decisions)."""
    name: str
    slo_ttft: float
    attainment: float
    metrics: Dict[str, float]
    scale_events: List[dict]
    autoscaler_events: List[dict]
    peak_replicas: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class FleetReport:
    """The fleet run: per-tenant reports on one shared timeline, the
    occupancy attribution, admission-arbitration events, and the
    runtime's executed-event count (the events/s capacity figure)."""
    sim_seconds: float
    tenants: Dict[str, TenantReport]
    occupancy: Dict[str, Dict[str, float]]
    admission_events: List[dict]
    events_processed: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def attainment(self, name: str) -> float:
        return self.tenants[name].attainment


# ----------------------------------------------------------------------
# the fleet
# ----------------------------------------------------------------------

class ServeFleet:
    """N engines, one runtime, one ledger (module docstring). Single
    use: build a fresh fleet per run — engines and arrival generators
    are stateful."""

    def __init__(self, specs: Sequence[FleetTenantSpec], *,
                 fabric: Optional[Fabric] = None,
                 host_bw: float = 1000.0, replica_bw: float = 400.0,
                 replicas: int = 3,
                 prefill_units_per_token: float = 1.0,
                 decode_units_per_slot: float = 4.0,
                 arbitration: bool = False,
                 arbitration_check_every: float = 0.05,
                 sample_every: float = 0.05,
                 vocab: int = 32000,
                 tracer=None):
        if not specs:
            raise ValueError("ServeFleet needs at least one tenant spec")
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.specs = list(specs)
        self.fabric = fabric if fabric is not None else fleet_fabric(
            host_bw=host_bw, replica_bw=replica_bw, replicas=replicas)
        if "fleet:host" not in self.fabric:
            raise ValueError("fleet fabric must provide a 'fleet:host' path")
        self.replica_paths = replica_paths_of(self.fabric)
        qos = QoSPolicy.fleet([s.tenant() for s in self.specs])
        self.runtime = FabricRuntime(self.fabric, qos=qos, tracer=tracer)
        tm = ServeTimeModel(
            prefill_path="fleet:host", decode_path="fleet:host",
            prefill_units_per_token=prefill_units_per_token,
            decode_units_per_slot=decode_units_per_slot)
        self.engines: Dict[str, StagedServeEngine] = {}
        self.generators: Dict[str, ArrivalGenerator] = {}
        for i, s in enumerate(self.specs):
            self.engines[s.name] = StagedServeEngine(
                None, None, compute="sim", slots=s.slots,
                runtime=self.runtime, time_model=tm,
                max_inflight_prefills=s.max_inflight_prefills,
                tenant=s.name, decode_pool=True)
            self.generators[s.name] = ArrivalGenerator(
                s.trace, seed=s.seed, vocab=vocab,
                rid_base=(i + 1) * 1_000_000)
        self.arbitration = arbitration
        self.arbitration_check_every = arbitration_check_every
        self.sample_every = sample_every
        self.pool = ReplicaPool(self.replica_paths)
        self.autoscalers: Dict[str, Autoscaler] = {}
        self.controller: Optional[FleetAdmissionController] = None
        self.served: Dict[str, List[Request]] = {}
        self._ran = False

    def run(self, *, autoscale: bool = False,
            max_sim_seconds: Optional[float] = None) -> FleetReport:
        """Start every feeder, engine, and controller on the shared
        clock, drive it to quiescence (or ``max_sim_seconds`` of
        simulated time), and report per-tenant attainment."""
        if self._ran:
            raise RuntimeError("ServeFleet is single-use; build a new one")
        self._ran = True
        rt = self.runtime
        t0, ev0 = rt.clock.now, rt.clock.processed
        feeders = []
        for s in self.specs:
            eng = self.engines[s.name]
            eng.start()
            feeders.append(self.generators[s.name].feed(eng))
        if self.arbitration:
            self.controller = FleetAdmissionController(
                rt,
                [AdmittedTenant(name=s.name, priority=s.priority,
                                slo_ttft=s.slo_ttft,
                                engine=self.engines[s.name],
                                pause=self.engines[s.name].pause_intake,
                                resume=self.engines[s.name].resume_intake)
                 for s in self.specs],
                check_every=self.arbitration_check_every).start()
        if autoscale:
            for s in self.specs:
                if s.autoscale is None:
                    continue
                self.autoscalers[s.name] = Autoscaler(
                    rt, self.engines[s.name], slo_ttft=s.slo_ttft,
                    pool=self.pool, config=s.autoscale,
                    name=f"autoscaler:{s.name}").start()
        sampler = _OccupancySampler(rt, self.sample_every)
        until = None if max_sim_seconds is None else t0 + max_sim_seconds

        def quiescent():
            return (all(f.done for f in feeders)
                    and all(e.idle for e in self.engines.values()))

        rt.clock.run(until=until, stop=quiescent)
        for a in self.autoscalers.values():
            a.stop()
        if self.controller is not None:
            self.controller.stop()
            # a resumed tenant may still hold deferred work: drain it
            rt.clock.run(
                until=None if max_sim_seconds is None
                else rt.clock.now + max_sim_seconds,
                stop=quiescent)
        occupancy = sampler.finish()
        for a in self.autoscalers.values():
            a.release_all()
        elapsed = rt.clock.now - t0
        tenants: Dict[str, TenantReport] = {}
        for s in self.specs:
            eng = self.engines[s.name]
            served, eng.finished = list(eng.finished), []
            self.served[s.name] = served
            ttfts = [ttft for _, ttft in eng.ttft_log]
            auto = self.autoscalers.get(s.name)
            peaks = [e["replicas"] for e in eng.scale_events
                     if e["event"] == "scale_out"]
            tenants[s.name] = TenantReport(
                name=s.name, slo_ttft=s.slo_ttft,
                attainment=ttft_attainment(ttfts, s.slo_ttft),
                metrics=serve_metrics(served, elapsed),
                scale_events=list(eng.scale_events),
                autoscaler_events=list(auto.events) if auto else [],
                peak_replicas=max(peaks, default=0))
        return FleetReport(
            sim_seconds=elapsed,
            tenants=tenants,
            occupancy=occupancy,
            admission_events=(list(self.controller.events)
                              if self.controller else []),
            events_processed=rt.clock.processed - ev0)


# ----------------------------------------------------------------------
# the headline experiment
# ----------------------------------------------------------------------

def headline_specs(*, duration: float = 120.0,
                   autoscale: Optional[AutoscaleConfig] = None,
                   ) -> List[FleetTenantSpec]:
    """The canonical two-tenant burst experiment: ``premium`` (tight
    TTFT SLO, heavy weight, high priority) rides a 10x diurnal burst
    trace; ``standard`` (loose SLO, weight 1) offers steady load."""
    cfg = autoscale if autoscale is not None else AutoscaleConfig()
    return [
        FleetTenantSpec(
            name="premium",
            trace=burst_trace(base_rate=2.0, duration=duration,
                              burst_multiplier=10.0, burst_start=30.0,
                              burst_duration=45.0, diurnal_amplitude=0.25),
            slo_ttft=0.4, tenant_class=LATENCY, weight=8.0, priority=1,
            seed=7, autoscale=cfg),
        FleetTenantSpec(
            name="standard",
            trace=TraceSpec(name="steady", base_rate=2.0, duration=duration,
                            diurnal_amplitude=0.25, diurnal_period=duration),
            slo_ttft=2.0, tenant_class=LATENCY, weight=1.0, priority=0,
            seed=11, autoscale=cfg),
    ]


def headline_fleet(*, duration: float = 120.0,
                   autoscale_cfg: Optional[AutoscaleConfig] = None,
                   **fleet_kw) -> ServeFleet:
    """A fresh fleet wired for the headline run; call
    ``.run(autoscale=False)`` for the static baseline and build another
    for ``.run(autoscale=True)``. The host path is provisioned so the
    burst fits once decode is moved off it (autoscaled holds the SLO)
    but not while decode contends on it (static collapses)."""
    fleet_kw.setdefault("host_bw", 1400.0)
    return ServeFleet(headline_specs(duration=duration,
                                     autoscale=autoscale_cfg), **fleet_kw)
