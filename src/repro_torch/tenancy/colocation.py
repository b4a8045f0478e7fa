"""Serve + train colocation on one FabricRuntime/BudgetLedger (§6).

The paper's multi-tenant angle, made executable: a latency-class
``StagedServeEngine`` and a throughput-class ``TrainCluster`` run as
*tenants* of a single merged fabric, drawing on the same budget ledger,
so every interference effect — the §4.1 concurrency discount, direction
budgets, weighted fair shares, admission-control deferral — emerges
from scheduling on one shared timeline instead of being asserted.

Topology (``colocation_fabric``): the train cluster's ``host:i`` /
``soc:i`` / ``net`` paths merged (``merge_fabrics``) with a
serve-private ``serve:decode`` path. The serve tenant's prefill
KV-cache shipment rides ``host:<serve_node>`` — the *same* path, same
direction, same budget as that node's gradient staging, which is
exactly the co-runner-loads-one-direction experiment of §6; decode
cache reads stay on the private path so steady-state decode is not the
confounder.

``Colocation.run`` launches both tenants, optionally under a
``QoSPolicy`` and an ``AdmissionController``, and produces an
``InterferenceReport``: per-tenant p50/p99 TTFT and tokens/s, plus a
per-(path, tenant) occupancy attribution sampled from the live ledger
reservations. Determinism note: overlap moves *when* tokens and losses
happen on the clock, never *what* they are — the serve tenant's greedy
tokens and the train tenant's loss curve are bit-identical to solo
runs of the same tenants (asserted in tests/test_tenancy.py).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core import hw
from repro_torch.core.fabric import Fabric, OUT, Path, merge_fabrics
from repro_torch.core.runtime import FabricRuntime
from repro_torch.obs.metrics import OccupancyTimeSeries
from repro_torch.serve.engine import Request, ServeTimeModel, StagedServeEngine
from repro_torch.tenancy.admission import (AdmissionConfig, AdmissionController,
                                           percentile)
from repro_torch.tenancy.qos import QoSPolicy, SERVE, TRAIN
from repro_torch.train.cluster import TrainCluster, train_fabric


def colocation_fabric(nodes: int = 2, *, host_bw: float = hw.PCIE_BW,
                      soc_frac: float = 0.7,
                      net_bw_per_node: float = hw.DCN_BW_PER_CHIP,
                      decode_bw: Optional[float] = None,
                      concurrency_discount: float = 0.1) -> Fabric:
    """The merged multi-tenant fabric: train paths + a serve-private
    decode path (prefill deliberately has no private path — it shares
    ``host:<serve_node>`` with gradient staging)."""
    serve_private = Fabric.of(
        Path("serve:decode", decode_bw if decode_bw is not None else host_bw,
             latency=hw.PCIE_LAT, kind="pcie"))
    return merge_fabrics(
        train_fabric(nodes, host_bw=host_bw, soc_frac=soc_frac,
                     net_bw_per_node=net_bw_per_node,
                     concurrency_discount=concurrency_discount),
        serve_private)


def colocation_time_model(serve_node: int = 0, *,
                          prefill_units_per_token: float = 1.0,
                          decode_units_per_slot: float = 1.0,
                          ) -> ServeTimeModel:
    """The serve tenant's cost mapping onto the merged fabric."""
    return ServeTimeModel(
        prefill_path=f"host:{serve_node}", decode_path="serve:decode",
        prefill_units_per_token=prefill_units_per_token,
        decode_units_per_slot=decode_units_per_slot)


# ----------------------------------------------------------------------
# the report
# ----------------------------------------------------------------------

@dataclasses.dataclass
class InterferenceReport:
    """What colocation did to each tenant, on one shared ledger.

    ``serve``      p50/p99 TTFT (s), tokens/s, request/token counts.
    ``train``      the cluster summary (steps, sim_seconds, tokens/s,
                   loss when the numeric stream ran).
    ``occupancy``  path -> tenant -> average fraction of the path's
                   outbound capacity held by that tenant's transfers
                   (sampled from live ledger reservations).
    ``events``     admission-controller + cluster events, time-ordered.
    ``throttles``  admission pause count (0 without a controller).
    """
    sim_seconds: float
    serve: Dict[str, float]
    train: Dict[str, object]
    occupancy: Dict[str, Dict[str, float]]
    events: List[dict]
    throttles: int = 0

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def placement_ledger(self, fabric: Fabric, *,
                         tenant: Optional[str] = None):
        """A fresh ledger over ``fabric`` seeded with the *other*
        tenants' measured occupancy — the input that makes
        ``plan_decode_placement`` tenant-aware: the planner sees the
        co-runners' held capacity as external reservations without
        mistaking ``tenant``'s own traffic for contention."""
        exclude = (tenant,) if tenant is not None else ()
        return occupancy_ledger(fabric, self.occupancy, exclude=exclude)


def occupancy_ledger(fabric: Fabric, occupancy: Dict[str, Dict[str, float]],
                     *, exclude: Sequence[str] = ()):
    """Seed ``fabric.ledger()`` with per-path outbound reservations from
    a measured occupancy attribution (``path -> tenant -> fraction``,
    the ``InterferenceReport.occupancy`` shape), skipping the tenants in
    ``exclude``. Fractions are clamped to the path's capacity and
    reserved non-strict (a sampled attribution can momentarily exceed
    1.0 across tenants on a discounted path)."""
    ledger = fabric.ledger()
    for path, per_tenant in occupancy.items():
        if path not in fabric:
            continue
        frac = sum(f for t, f in per_tenant.items() if t not in exclude)
        if frac <= 0:
            continue
        cap = fabric[path].capacity
        ledger.reserve(path, out=min(frac, 1.0) * cap,
                       flow="occupancy", strict=False)
    return ledger


def serve_metrics(requests: Sequence[Request], elapsed: float) -> Dict[str, float]:
    """p50/p99 TTFT + decode throughput for a served request set."""
    ttfts = [r.ttft for r in requests if r.ttft is not None]
    tokens = sum(len(r.out_tokens) for r in requests)
    return {
        "requests": float(len(requests)),
        "tokens": float(tokens),
        "p50_ttft": percentile(ttfts, 50) if ttfts else float("nan"),
        "p99_ttft": percentile(ttfts, 99) if ttfts else float("nan"),
        "tokens_per_s": tokens / elapsed if elapsed > 0 else 0.0,
    }


class _OccupancySampler(OccupancyTimeSeries):
    """Periodic attribution of ledger-held *outbound* rate to tenants —
    a thin alias over ``obs.metrics.OccupancyTimeSeries``
    (OUT-only, same charge rule, same ``busy``/``finish()`` surface).
    (IN traffic draws on the opposite direction budget — mixing the two
    against one capacity would double-count a bidirectional path.)"""

    def __init__(self, runtime: FabricRuntime, every: float):
        super().__init__(runtime, every, directions=(OUT,))


# ----------------------------------------------------------------------
# the harness
# ----------------------------------------------------------------------

class Colocation:
    """Runs two tenants on one runtime and reports interference.

    ``make_engine`` / ``make_cluster`` receive the shared runtime and
    must build their tenant *on it* (``StagedServeEngine(runtime=rt)``,
    ``TrainCluster(runtime=rt, fabric=rt.fabric)``); the harness tags
    untagged tenants with the canonical ``serve``/``train`` names so
    the QoS policy and occupancy attribution line up. ``qos=None``
    gives unmanaged (equal-share) colocation — the baseline the
    QoS-weighted run is measured against.
    """

    def __init__(self, *, fabric: Fabric,
                 make_engine: Callable[[FabricRuntime], StagedServeEngine],
                 make_cluster: Callable[[FabricRuntime], TrainCluster],
                 qos: Optional[QoSPolicy] = None,
                 admission: Optional[AdmissionConfig] = None,
                 sample_every: float = 0.01, tracer=None):
        self.runtime = FabricRuntime(fabric, qos=qos, tracer=tracer)
        self.engine = make_engine(self.runtime)
        self.cluster = make_cluster(self.runtime)
        if self.engine.runtime is not self.runtime \
                or self.cluster.runtime is not self.runtime:
            raise ValueError("tenants must be built on the shared runtime "
                             "(pass runtime=rt in the factories)")
        if self.engine.tenant is None:
            self.engine.tenant = SERVE
        if self.cluster.tenant is None:
            self.cluster.tenant = TRAIN
        self.admission_cfg = admission
        self.controller: Optional[AdmissionController] = None
        self.sample_every = sample_every

    def run(self, requests: Sequence[Request], train_steps: int,
            *, max_sim_seconds: Optional[float] = None) -> InterferenceReport:
        """Launch both tenants, drive the shared clock until both are
        quiescent (or ``max_sim_seconds``), and report."""
        rt = self.runtime
        t0 = rt.clock.now
        self.cluster.begin(train_steps)
        for r in requests:
            self.engine.submit(r)
        self.engine.start()
        if self.admission_cfg is not None:
            self.controller = AdmissionController(
                rt, self.engine, self.cluster, self.admission_cfg).start()
        sampler = _OccupancySampler(rt, self.sample_every)
        until = None if max_sim_seconds is None else t0 + max_sim_seconds
        rt.clock.run(until=until,
                     stop=lambda: self.cluster.done and self.engine.idle)
        if self.controller is not None:
            self.controller.stop()
            # stop() resumed a still-paused cluster: drain the re-issued
            # transfers under a fresh deadline budget
            rt.clock.run(
                until=None if max_sim_seconds is None
                else rt.clock.now + max_sim_seconds,
                stop=lambda: self.cluster.done and self.engine.idle)
        train = self.cluster.finish()
        occupancy = sampler.finish()
        served, self.engine.finished = list(self.engine.finished), []
        elapsed = rt.clock.now - t0
        # the serve tenant's own makespan: its throughput must not be
        # diluted by the train tenant's tail (mirrors the cluster's
        # _done_at stamp)
        serve_end = max((r.finish_time for r in served
                         if r.finish_time is not None), default=rt.clock.now)
        events = sorted(
            (list(self.controller.events) if self.controller else [])
            + list(train.get("events", [])),
            key=lambda e: e["t"])
        return InterferenceReport(
            sim_seconds=elapsed,
            serve=serve_metrics(served, serve_end - t0),
            train=train,
            occupancy=occupancy,
            events=events,
            throttles=self.controller.throttles if self.controller else 0)


# ----------------------------------------------------------------------
# solo baselines (same fabric, one tenant absent)
# ----------------------------------------------------------------------

def solo_serve(fabric: Fabric,
               make_engine: Callable[[FabricRuntime], StagedServeEngine],
               requests: Sequence[Request]) -> Dict[str, float]:
    """The serve tenant alone on the merged fabric — the SLO baseline
    QoS/admission results are normalized against."""
    rt = FabricRuntime(fabric)
    eng = make_engine(rt)
    if eng.tenant is None:
        eng.tenant = SERVE
    t0 = rt.clock.now
    for r in requests:
        eng.submit(r)
    done = eng.run()
    return serve_metrics(done, rt.clock.now - t0)


def solo_train(fabric: Fabric,
               make_cluster: Callable[[FabricRuntime], TrainCluster],
               steps: int) -> Dict[str, object]:
    """The train tenant alone on the merged fabric."""
    rt = FabricRuntime(fabric)
    cluster = make_cluster(rt)
    if cluster.tenant is None:
        cluster.tenant = TRAIN
    return cluster.run(steps)
