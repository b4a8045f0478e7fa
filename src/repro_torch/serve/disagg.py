"""DrTM-KV on an off-path SmartNIC, the paper's §5.2 case study: the
serving part of ``repro/serve/disagg.py``.

The performance plane is the calibrated path ``Fabric`` of the §5.2
RDMA fabric (latencies and per-endpoint rate caps from the paper's
Figure 3/17 measurements, as ops/s paths; every number is in
``PathCosts``), with the five offload alternatives of Figure 16:

  A1  client READ index on host + READ value on host          (path ①x2)
  A2  client SEND to SoC; SoC walks index + DMA-reads value   (②+③*)
  A3  A2 with the index held in SoC memory                    (②+③*)
  A4  client READ index on SoC + READ value on host           (②+①)
  A5  client READ index on SoC + READ value from SoC cache    (②x2)
      (miss -> SoC returns the address; client falls back to A4)

The serving engines use it through ``kv_fabric``,
``kv_serve_time_model`` and ``plan_decode_placement``, which routes the
alternatives through the fabric's ``MultipathRouter`` (the §4.1
concurrency discount applied once, by the fabric). The code is the JAX
package's, expression for expression, so the plans are the same.

The numpy data plane (``DisaggKV``: hash index, value store, SoC cache)
and the tenant-occupancy input of ``plan_decode_placement`` are not
here yet: the occupancy ledger belongs to the tenancy modules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.core.fabric import (Allocation, Alternative, Fabric,
                                     MultipathRouter, OPS_PER_S, Path, Use)


@dataclasses.dataclass(frozen=True)
class PathCosts:
    """Calibrated against the paper (64 B payloads, µs / Mop/s)."""
    read_host_us: float = 2.6        # Fig 3: READ via ① on SNIC
    read_soc_us: float = 2.2         # Fig 3: READ via ② (≈15% faster)
    send_host_us: float = 3.6        # SEND/RECV ①
    send_soc_us: float = 4.6         # SEND/RECV ② (wimpy SoC, §3.2)
    dma_soc_host_us: float = 1.9     # ③* 64 B (§3.3)
    read_host_rate: float = 100e6    # one-sided ops/s the host path sustains
    read_soc_rate: float = 140e6     # §3.2: 1.08–1.48x faster to SoC
    rnic_read_rate: float = 110e6    # plain ConnectX-6 one-sided ops/s
    nic_core_rate: float = 195e6     # total NIC processing ops/s
    mixed_nic_efficiency: float = 0.6  # §4.1: host+SoC endpoints share most
    #                                    NIC cores; mixing costs efficiency
    send_soc_rate: float = 21.6e6    # §5.2: SoC SEND/RECV cap
    soc_cpu_rate: float = 25e6       # SoC index-walk ops/s
    dma_rate: float = 30e6           # ③* small-payload ops/s (Fig 11)
    concurrency_discount: float = 0.125  # §4.1: paths running concurrently
    #                                      lose 7–15% on shared resources


def kv_fabric(costs: PathCosts = PathCosts()) -> Fabric:
    """The §5.2 RDMA fabric: every endpoint rate cap is an ops/s path;
    each path is its own interference group, and the fabric carries the
    §4.1 concurrency discount (applied once, by the ledger/router —
    never at call sites)."""
    c = costs
    mk = lambda name, rate: Path(name, rate, OPS_PER_S, latency=1e-6,
                                 kind="rdma")
    return Fabric.of(
        mk("host_read", c.read_host_rate),
        mk("soc_read", c.read_soc_rate),
        mk("nic_cores", c.nic_core_rate),
        mk("soc_send", c.send_soc_rate),
        mk("soc_cpu", c.soc_cpu_rate),
        mk("dma", c.dma_rate),
        concurrency_discount=c.concurrency_discount,
    )


def kv_serve_time_model(units_per_token: float = 1e5):
    """The §5.2 ``ServeTimeModel`` for serving over ``kv_fabric()``:
    prefill ships the prompt KV over the ③* DMA path, decode cache
    reads go to the SoC cache or the host per the placement decision.
    One calibration, shared by the bench (fig18/staged_engine_ttft) and
    the --staged launcher so they cannot drift apart."""
    from repro_torch.serve.engine import ServeTimeModel
    return ServeTimeModel(
        prefill_path="dma", decode_path="host_read",
        prefill_units_per_token=units_per_token,
        decode_units_per_slot=units_per_token,
        placement_paths={"soc_cache": "soc_read", "host": "host_read"})


def kv_alternatives(costs: PathCosts = PathCosts(),
                    reads_per_index: float = 1.0) -> Dict[str, Alternative]:
    """The five offload alternatives of Figure 16, declared in ops/s
    units against kv_fabric()."""
    c, r, ops = costs, reads_per_index, OPS_PER_S
    return {
        "A1": Alternative("A1", uses=[
            Use("host_read", out=r + 1, units=ops),
            Use("nic_cores", out=r + 1, units=ops)],
            criteria={"latency_us": (r + 1) * c.read_host_us}),
        "A2": Alternative("A2", uses=[
            Use("soc_send", out=1, units=ops), Use("soc_cpu", out=1, units=ops),
            Use("dma", out=1, units=ops), Use("nic_cores", out=1, units=ops)],
            criteria={"latency_us": c.send_soc_us + c.dma_soc_host_us}),
        "A3": Alternative("A3", uses=[
            Use("soc_send", out=1, units=ops), Use("soc_cpu", out=1, units=ops),
            Use("dma", out=1, units=ops), Use("nic_cores", out=1, units=ops)],
            criteria={"latency_us": c.send_soc_us + c.dma_soc_host_us}),
        "A4": Alternative("A4", uses=[
            Use("soc_read", out=r, units=ops),
            Use("host_read", out=1, units=ops),
            # mixed host+SoC endpoints underuse the shared NIC cores
            Use("nic_cores", out=(r + 1) / c.mixed_nic_efficiency, units=ops)],
            criteria={"latency_us": r * c.read_soc_us + c.read_host_us}),
        "A5": Alternative("A5", uses=[
            Use("soc_read", out=r + 1, units=ops),
            Use("nic_cores", out=r + 1, units=ops)],
            criteria={"latency_us": (r + 1) * c.read_soc_us}),
    }


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    """Decode-cache placement decision for the serving engine (§5.2
    wired into serving): where the hot value/KV-cache reads should land
    and the predicted get rate of that choice."""
    location: str                      # "soc_cache" | "host"
    rate: float                        # predicted gets/s of the choice
    baseline_rate: float               # host-only (A1) rate
    hit_mass: float
    allocations: List[Allocation]


def plan_decode_placement(fabric: Fabric, *, hit_mass: float = 0.7,
                          costs: Optional[PathCosts] = None,
                          reads_per_index: float = 1.0,
                          ledger=None, occupancy=None,
                          tenant: Optional[str] = None) -> PlacementPlan:
    """Choose where the decode cache lives by routing the §5.2
    alternatives over `fabric`: SoC cache placement (A5 hits + A4
    misses, blended at `hit_mass`) vs the best cache-less alternative
    (A1 host-only or A4 SoC-index). Pass the same `costs` the fabric
    was calibrated with (use coefficients like mixed_nic_efficiency
    come from it, not from the fabric).

    With a ``ledger`` (a ``BudgetLedger`` over the same fabric, e.g.
    the fabric runtime's), the plan is made from *live* occupancy: the
    current holders count toward the §4.1 discount and their
    reservations shrink every path budget — so the staged engine's
    AdmitStage can re-plan per admitted request and flip to the host
    path once the SoC-side budgets are eaten.

    ``occupancy`` (the ``InterferenceReport.occupancy`` attribution,
    ``path -> tenant -> fraction``, with ``tenant`` the caller's own
    tenant) makes JAX's plan tenant-aware through the tenancy modules'
    occupancy ledger; the port raises ``NotImplementedError`` for it
    until those modules are ported. Ignored when an explicit ``ledger``
    is given."""
    if ledger is None and occupancy is not None:
        raise NotImplementedError(
            "plan_decode_placement(occupancy=...) needs the tenancy "
            "modules' occupancy_ledger, which the port does not have yet "
            "(it comes with tenancy/colocation, after TrainCluster); pass "
            "a live ledger= instead")
    alts = kv_alternatives(costs if costs is not None else PathCosts(),
                           reads_per_index)
    router = MultipathRouter(fabric)
    for alt in alts.values():
        fabric.validate(alt)
    base_alt = max(("A1", "A4"),
                   key=lambda n: alts[n].solo_rate(fabric, ledger=ledger))
    base_rate = alts[base_alt].solo_rate(fabric, ledger=ledger)
    total, allocs = router.blend([(alts["A5"], hit_mass),
                                  (alts["A4"], 1.0 - hit_mass)],
                                 ledger=ledger)
    if total > base_rate:
        return PlacementPlan("soc_cache", total, base_rate, hit_mass, allocs)
    return PlacementPlan("host", base_rate, base_rate, hit_mass,
                         [Allocation(base_alt, base_rate, "solo")])
