"""DrTM-KV on an off-path SmartNIC — the paper's §5.2 case study.

A disaggregated key-value store with a cluster-chaining hash index
(one READ usually locates the value) and five offload alternatives
(paper Figure 16):

  A1  client READ index on host + READ value on host          (path ①x2)
  A2  client SEND to SoC; SoC walks index + DMA-reads value   (②+③*)
  A3  A2 with the index held in SoC memory                    (②+③*)
  A4  client READ index on SoC + READ value on host           (②+①)
  A5  client READ index on SoC + READ value from SoC cache    (②x2)
      (miss -> SoC returns the address; client falls back to A4)

The data plane is real: numpy hash index (cluster chaining), value
store, SoC-memory value cache with hot-key replication (Advice #1).
The *performance* plane is the calibrated path Fabric (latencies and
per-endpoint rate caps from the paper's Figure 3/17 measurements, as
ops/s paths), because the reproduction runs without an RDMA fabric — every number
used is listed in PathCosts and cross-checked against the paper in
benchmarks/bench_kvserve.py. Throughput composition (e.g. A4+A5) goes
through the fabric's MultipathRouter, with the §4.1 concurrency
discount applied once by the fabric, not per call site.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

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
    ``path -> tenant -> fraction``) makes the plan *tenant-aware*
    without a live ledger: the other tenants' measured shares become
    external reservations, while ``tenant``'s own traffic is excluded —
    a tenant should not flee a path it is itself the load on. Ignored
    when an explicit ``ledger`` is given."""
    if ledger is None and occupancy is not None:
        # lazy import: tenancy builds on serve, not the other way round
        from repro_torch.tenancy.colocation import occupancy_ledger
        ledger = occupancy_ledger(
            fabric, occupancy, exclude=(tenant,) if tenant is not None else ())
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


@dataclasses.dataclass
class KVStoreParams:
    n_keys: int = 100_000
    value_bytes: int = 64
    key_bytes: int = 8
    buckets_factor: float = 1.5
    soc_cache_keys: int = 10_000     # SoC memory capacity (values)
    hot_replicas: int = 3            # Advice #1: replicate hot entries
    zipf_theta: float = 0.99


class DisaggKV:
    """Real index/value arrays + modeled path costs."""

    def __init__(self, params: KVStoreParams, costs: PathCosts = PathCosts(),
                 seed: int = 0):
        self.p, self.c = params, costs
        rng = np.random.default_rng(seed)
        n = params.n_keys
        self.nbuckets = int(n * params.buckets_factor)
        # cluster-chaining hash index: bucket -> up to 4 (key, addr) slots
        self.index_keys = np.full((self.nbuckets, 4), -1, np.int64)
        self.index_addr = np.zeros((self.nbuckets, 4), np.int64)
        self.values = rng.integers(0, 256, size=(n, params.value_bytes),
                                   dtype=np.uint8)
        self.overflow: Dict[int, int] = {}
        for k in range(n):
            b = hash((k, 0x9E3779B9)) % self.nbuckets
            slot = np.argmax(self.index_keys[b] == -1)
            if self.index_keys[b, slot] == -1:
                self.index_keys[b, slot] = k
                self.index_addr[b, slot] = k
            else:
                self.overflow[k] = k
        # SoC value cache: hottest keys under zipf (key id == hotness rank)
        self.soc_cached = set(range(min(params.soc_cache_keys, n)))

    # ------------------------------------------------------------------
    def _index_lookup(self, key: int) -> Tuple[int, int]:
        """Returns (addr, n_reads needed)."""
        b = hash((key, 0x9E3779B9)) % self.nbuckets
        hit = np.where(self.index_keys[b] == key)[0]
        if hit.size:
            return int(self.index_addr[b, hit[0]]), 1
        return self.overflow[key], 2

    def get(self, key: int, alternative: str) -> Tuple[np.ndarray, float]:
        """Executes the data plane, returns (value, modeled latency s)."""
        c = self.c
        addr, nidx = self._index_lookup(key)
        val = self.values[addr]
        if alternative == "A1":
            lat = nidx * c.read_host_us + c.read_host_us
        elif alternative == "A2":
            lat = c.send_soc_us + c.dma_soc_host_us
        elif alternative == "A3":
            lat = c.send_soc_us + c.dma_soc_host_us   # index walk on-SoC memory
        elif alternative == "A4":
            lat = nidx * c.read_soc_us + c.read_host_us
        elif alternative == "A5":
            if key in self.soc_cached:
                lat = nidx * c.read_soc_us + c.read_soc_us
            else:  # miss: SoC returns address, client READs host (=A4 tail)
                lat = nidx * c.read_soc_us + c.read_host_us
        else:
            raise ValueError(alternative)
        return val, lat * 1e-6

    # ------------------------------------------------------------------
    # throughput model (paper Fig 17b/18): fabric + alternatives
    # ------------------------------------------------------------------
    def fabric(self) -> Fabric:
        """The §5.2 RDMA fabric (see module-level kv_fabric)."""
        return kv_fabric(self.c)

    def alternatives(self, reads_per_index: float = 1.0) -> Dict[str, Alternative]:
        return kv_alternatives(self.c, reads_per_index)

    def cache_hit_mass(self) -> float:
        """Zipf probability mass of the SoC-cached (hottest) keys — the
        fraction of gets A5 can serve."""
        ranks = np.arange(1, self.p.n_keys + 1, dtype=np.float64)
        w = 1.0 / ranks ** self.p.zipf_theta
        w /= w.sum()
        return float(w[:len(self.soc_cached)].sum())

    def combined_a4_a5(self) -> Tuple[float, List[Allocation]]:
        """Paper's winning combination: cache hits go A5, misses A4; the
        hit fraction is the zipf mass of the cached keys ("cache misses
        are rare", §5.2). The MultipathRouter scales the fixed mix up to
        the first saturated resource, with the §4.1 discount applied by
        the fabric to resources touched by both members."""
        m = self.cache_hit_mass()
        alts = self.alternatives()
        router = MultipathRouter(self.fabric())
        return router.blend([(alts["A5"], m), (alts["A4"], 1.0 - m)])

    def filtered_scan(self, keys, predicate, *, where: str = "soc-filter",
                      ledger=None, stats=None):
        """DrTM-KV get/put filtering (the offload tier's §5.2 workload):
        run ``predicate`` over the candidate values on the SoC cores so
        only matches cross the wire (``where="soc-filter"``), or read
        everything over the host path and filter client-side
        (``where="host-filter"``). Results are bit-identical either way;
        see offload/kvfilter.KVFilter for the placement planner."""
        from repro_torch.offload.kvfilter import KVFilter
        return KVFilter(self, stats=stats).scan(keys, predicate,
                                                where=where, ledger=ledger)

    def zipf_keys(self, n: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        # standard YCSB zipfian over key ranks
        ranks = np.arange(1, self.p.n_keys + 1, dtype=np.float64)
        w = 1.0 / ranks ** self.p.zipf_theta
        w /= w.sum()
        return rng.choice(self.p.n_keys, size=n, p=w)
