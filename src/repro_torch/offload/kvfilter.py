"""DrTM-KV-style get/put filtering on the SoC path (paper §5.2).

A filtered scan asks "of these candidate keys, which values satisfy a
predicate?". Placed on the host path, every candidate value crosses the
host wire and the client discards the misses. Placed on the SoC, the
wimpy ARM cores run the predicate next to the data and only the
*matches* cross (via the ③* DMA path) — the classic offload trade:
slower cores, radically fewer bytes on the contended wire.

The data plane is real (numpy predicate over the DisaggKV value store,
bit-identical results for either placement); the performance plane is
the same calibrated kv_fabric the §5.2 alternatives use, optionally
against a live ``BudgetLedger`` — which is where the win comes from:
idle, the host path's 100 Mop/s beats the SoC's 25 Mop/s cores; once a
serving tenant holds the host path, the SoC placement keeps its rate
and wins (benchmarks/bench_offload.py sweeps exactly this flip).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.fabric import Alternative, BudgetLedger, Fabric, OPS_PER_S, Use
from repro_torch.offload.program import OffloadStats

HOST_FILTER, SOC_FILTER = "host-filter", "soc-filter"


def kv_filter_alternatives(costs=None, selectivity: float = 0.1,
                           ) -> Dict[str, Alternative]:
    """The two filter placements as §4.2 alternatives over kv_fabric(),
    per scanned key: host-filter READs every candidate value over the
    host path; soc-filter spends one SoC-core op per candidate and only
    ``selectivity`` of them cross the ③* DMA path."""
    from repro_torch.serve.disagg import PathCosts
    c = costs if costs is not None else PathCosts()
    if not 0.0 <= selectivity <= 1.0:
        raise ValueError(f"selectivity must be in [0, 1], got {selectivity}")
    ops = OPS_PER_S
    return {
        HOST_FILTER: Alternative(HOST_FILTER, uses=[
            Use("host_read", out=1.0, units=ops),
            Use("nic_cores", out=1.0, units=ops)],
            criteria={"latency_us": c.read_host_us}),
        SOC_FILTER: Alternative(SOC_FILTER, uses=[
            Use("soc_cpu", out=1.0, units=ops),
            Use("dma", out=selectivity, units=ops),
            Use("nic_cores", out=selectivity, units=ops)],
            criteria={"latency_us": c.send_soc_us + c.dma_soc_host_us}),
    }


@dataclasses.dataclass(frozen=True)
class FilterPlan:
    """Where the filter should run, per live occupancy."""
    location: str                   # "soc-filter" | "host-filter"
    rate: float                     # predicted scans/s of the choice
    host_rate: float                # host placement's rate (baseline)
    soc_rate: float                 # SoC placement's rate
    selectivity: float


def plan_filter_placement(fabric: Fabric, *, selectivity: float = 0.1,
                          costs=None,
                          ledger: Optional[BudgetLedger] = None) -> FilterPlan:
    """Route both placements over ``fabric`` (against the ledger's live
    budgets when given) and pick the faster — the same decision shape as
    serve/disagg.plan_decode_placement. Ties prefer the host (no
    dispatch to a remote complex for nothing)."""
    alts = kv_filter_alternatives(costs, selectivity)
    for alt in alts.values():
        fabric.validate(alt)
    host = alts[HOST_FILTER].solo_rate(fabric, ledger=ledger)
    soc = alts[SOC_FILTER].solo_rate(fabric, ledger=ledger)
    loc = SOC_FILTER if soc > host else HOST_FILTER
    return FilterPlan(loc, max(soc, host), host, soc, selectivity)


@dataclasses.dataclass(frozen=True)
class FilterScan:
    """One executed scan: real results + modeled cost."""
    keys: np.ndarray                # matching keys
    values: np.ndarray              # their values (n_matched, value_bytes)
    where: str                      # placement that ran
    scanned: int
    matched: int
    seconds: float                  # modeled wall time of the scan


class KVFilter:
    """Filtered scans over a ``DisaggKV``, placement-aware.

    ``predicate`` is vectorized: ``(n, value_bytes) uint8 -> (n,) bool``.
    Both placements run the *same* predicate over the *same* value
    store, so results are bit-identical; only the modeled seconds and
    the ``OffloadStats`` accounting differ (SoC placement credits the
    misses as packets that never crossed the wire)."""

    def __init__(self, kv, *, stats: Optional[OffloadStats] = None):
        self.kv = kv
        self.stats = stats if stats is not None else OffloadStats()
        self._fabric = kv.fabric()

    def _rate(self, resource: str, ledger: Optional[BudgetLedger]) -> float:
        if ledger is not None:
            return max(ledger.available(resource, "out", joining="kvfilter"),
                       1e-30)
        return self._fabric[resource].capacity

    def scan(self, keys: np.ndarray,
             predicate: Callable[[np.ndarray], np.ndarray], *,
             where: str = SOC_FILTER,
             ledger: Optional[BudgetLedger] = None) -> FilterScan:
        if where not in (HOST_FILTER, SOC_FILTER):
            raise ValueError(f"where must be {HOST_FILTER!r} or "
                             f"{SOC_FILTER!r}, got {where!r}")
        keys = np.asarray(keys)
        addrs = np.fromiter((self.kv._index_lookup(int(k))[0] for k in keys),
                            dtype=np.int64, count=len(keys))
        values = self.kv.values[addrs]
        mask = np.asarray(predicate(values), dtype=bool)
        n, m = int(len(keys)), int(mask.sum())
        if where == SOC_FILTER:
            secs = n / self._rate("soc_cpu", ledger) \
                + m / self._rate("dma", ledger)
            self.stats.record_filter(n, m, ops=float(n))
        else:
            secs = n / self._rate("host_read", ledger)
        return FilterScan(keys[mask], values[mask], where, n, m, secs)

    def plan(self, *, selectivity: float = 0.1,
             ledger: Optional[BudgetLedger] = None) -> FilterPlan:
        return plan_filter_placement(self._fabric, selectivity=selectivity,
                                     costs=self.kv.c, ledger=ledger)
