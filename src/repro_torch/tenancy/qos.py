"""Tenant classes and QoS weights for fabric sharing (paper §6).

The paper's multi-tenant observation is that host- and SoC-side paths
degrade very differently once a co-runner loads one direction; the
conclusion this module encodes is that path sharing must be *policied*,
not emergent. Two tenant classes cover the serving+training colocation
study:

``LATENCY``      a tenant whose SLO is a tail-latency bound (time to
                 first token for the serve engine). It gets a large
                 fair-share weight so its short transfers see most of a
                 path's capacity even mid-gradient-burst.
``THROUGHPUT``   a tenant whose metric is aggregate progress (train
                 tokens/s). Weight 1: it soaks up whatever the latency
                 tenants leave idle, which on a mostly-idle path is
                 almost everything.

``QoSPolicy`` is the object a ``FabricRuntime`` consults per transfer
(duck-typed: the runtime only calls ``weight(tenant)``); the weighted
max-min split in ``FabricRuntime._rebalance`` does the rest. Weights
are *ratios*, not reservations — an absent tenant costs nothing, and
the §4.1 concurrency discount still emerges from flow count exactly as
in the unweighted runtime.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional

LATENCY = "latency"
THROUGHPUT = "throughput"
_CLASSES = (LATENCY, THROUGHPUT)

#: canonical tenant tags used by the colocation harness; OFFLOAD tags
#: the SoC compute tier's programs (offload/) when they share a fabric
SERVE, TRAIN = "serve", "train"
OFFLOAD = "offload"


@dataclass(frozen=True)
class Tenant:
    """One workload sharing the fabric: a name (the tag on its
    transfers), a class, its fair-share weight, and an admission
    ``priority`` — higher-priority latency tenants are protected first
    when K tenants contend (tenancy/admission.FleetAdmissionController);
    weights shape *rates*, priorities order *deferral*."""
    name: str
    tenant_class: str = THROUGHPUT
    weight: float = 1.0
    priority: int = 0

    def __post_init__(self):
        if self.tenant_class not in _CLASSES:
            raise ValueError(f"tenant {self.name}: unknown class "
                             f"{self.tenant_class!r} (have {_CLASSES})")
        if not self.weight > 0:
            raise ValueError(f"tenant {self.name}: weight must be > 0, "
                             f"got {self.weight}")


class QoSPolicy:
    """Tenant registry + weight lookup for the runtime's weighted
    fair-share. Unregistered tenants (and untagged transfers) weigh
    ``default_weight`` — colocating an unpolicied flow degrades
    gracefully to equal sharing instead of starving anyone."""

    def __init__(self, tenants: Iterable[Tenant] = (), *,
                 default_weight: float = 1.0):
        if not default_weight > 0:
            raise ValueError("default_weight must be > 0")
        self.default_weight = float(default_weight)
        self._tenants: Dict[str, Tenant] = {}
        for t in tenants:
            self.add(t)

    def add(self, tenant: Tenant) -> "QoSPolicy":
        if tenant.name in self._tenants:
            raise ValueError(f"duplicate tenant {tenant.name!r}")
        self._tenants[tenant.name] = tenant
        return self

    # -- the runtime's contract ----------------------------------------
    def weight(self, tenant: Optional[str]) -> float:
        t = self._tenants.get(tenant) if tenant is not None else None
        return t.weight if t is not None else self.default_weight

    # -- introspection --------------------------------------------------
    def tenant_class(self, tenant: Optional[str]) -> str:
        t = self._tenants.get(tenant) if tenant is not None else None
        return t.tenant_class if t is not None else THROUGHPUT

    def __getitem__(self, name: str) -> Tenant:
        return self._tenants[name]

    def __contains__(self, name: str) -> bool:
        return name in self._tenants

    def __iter__(self):
        return iter(self._tenants.values())

    def __repr__(self) -> str:
        parts = ", ".join(f"{t.name}({t.tenant_class})x{t.weight:g}"
                          for t in self)
        return f"QoSPolicy({parts}; default={self.default_weight:g})"

    @classmethod
    def serve_train(cls, serve_weight: float = 16.0,
                    train_weight: float = 1.0) -> "QoSPolicy":
        """The colocation study's policy: a latency-class serve tenant
        promised ``serve_weight/(serve_weight+train_weight)`` of any
        path it contends on, over a throughput-class train tenant."""
        return cls([Tenant(SERVE, LATENCY, serve_weight),
                    Tenant(TRAIN, THROUGHPUT, train_weight)])

    @classmethod
    def serve_train_offload(cls, serve_weight: float = 16.0,
                            train_weight: float = 1.0,
                            offload_weight: float = 2.0) -> "QoSPolicy":
        """``serve_train`` plus the offload tier as a third
        throughput-class tenant: SoC programs (checkpoint compression,
        KV filtering) get a modest weight so they drain promptly on the
        devices they own without starving train staging on the wires
        they share."""
        return cls.serve_train(serve_weight, train_weight).add(
            Tenant(OFFLOAD, THROUGHPUT, offload_weight))

    @classmethod
    def fleet(cls, tenants: Iterable[Tenant]) -> "QoSPolicy":
        """A serving-fleet policy from explicit per-tenant specs (the
        scale/ ServeFleet builds one from its FleetTenantSpecs): weights
        shape each tenant's fair share on the paths it contends on,
        priorities feed the K-tenant admission arbitration."""
        return cls(tenants)
