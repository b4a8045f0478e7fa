"""Straggler detection + mitigation hooks.

Detection is two-signal:

- per-step wall (or simulated) times per node: a node whose EMA exceeds
  ``threshold`` x the fleet median is flagged — the lagging indicator;
- per-node *path occupancy* read straight from the BudgetLedger
  (``observe_ledger``): the fraction of a node's host-direction budget
  already reserved by other flows — the leading indicator. A node whose
  host path is spoken for will straggle on its next allreduce whether
  or not its step times have degraded yet (the paper's §6.1 host-load
  effect).

Mitigation on a real fleet: (1) deprioritize its DCN traffic (planner
slack rule), (2) shrink its microbatch share (skewed-batch rebalance),
(3) if persistent, treat as failed -> elastic re-mesh. Here the
detector + rebalance math are real; tests and the simulated
TrainCluster drive them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class StragglerDetector:
    alpha: float = 0.3            # EMA coefficient
    threshold: float = 1.5        # x median => straggler
    occupancy_threshold: float = 0.5   # reserved fraction => straggler
    ema: Dict[str, float] = field(default_factory=dict)
    occupancy: Dict[str, float] = field(default_factory=dict)

    def observe(self, node: str, step_seconds: float):
        prev = self.ema.get(node)
        self.ema[node] = (step_seconds if prev is None
                          else self.alpha * step_seconds + (1 - self.alpha) * prev)

    def observe_occupancy(self, node: str, fraction: float):
        """Record the externally-reserved fraction of a node's path."""
        prev = self.occupancy.get(node)
        self.occupancy[node] = (fraction if prev is None
                                else self.alpha * fraction + (1 - self.alpha) * prev)

    def observe_ledger(self, node: str, ledger, path: str,
                       direction: str = "out") -> float:
        """Sample a node's path occupancy from a live BudgetLedger —
        call *before* the node's own flow joins the path, so the
        reading is what everyone else holds."""
        cap = ledger.fabric.direction_capacity(path, direction)
        frac = ledger.reserved(path, direction) / cap if cap > 0 else 0.0
        self.observe_occupancy(node, frac)
        return frac

    def occupied(self) -> List[str]:
        """Nodes whose host-direction occupancy EMA exceeds the cutoff."""
        return [n for n, v in self.occupancy.items()
                if v > self.occupancy_threshold]

    def stragglers(self) -> List[str]:
        """Union of time-lagging nodes and occupancy-flagged nodes."""
        flagged = set(self.occupied())
        if len(self.ema) >= 2:
            med = float(np.median(list(self.ema.values())))
            flagged |= {n for n, v in self.ema.items()
                        if v > self.threshold * med}
        return sorted(flagged)

    def rebalanced_shares(self, total_microbatches: int,
                          nodes: Optional[List[str]] = None) -> Dict[str, int]:
        """Give each node work inversely proportional to its step time —
        the skew-taming advice (#1) applied to compute instead of memory.
        ``nodes`` restricts the split to the named (live) nodes; dead
        nodes' stale EMA entries must not absorb shares."""
        ema = self.ema if nodes is None \
            else {n: self.ema[n] for n in nodes if n in self.ema}
        if not ema:
            return {}
        inv = {n: 1.0 / v for n, v in ema.items()}
        z = sum(inv.values())
        raw = {n: total_microbatches * w / z for n, w in inv.items()}
        shares = {n: max(1, int(round(r))) for n, r in raw.items()}
        # fix rounding drift
        drift = total_microbatches - sum(shares.values())
        order = sorted(shares, key=lambda n: -raw[n])
        i = 0
        while drift != 0 and order:
            n = order[i % len(order)]
            if drift > 0:
                shares[n] += 1; drift -= 1
            elif shares[n] > 1:
                shares[n] -= 1; drift += 1
            i += 1
        return shares

    def microbatch_shares(self, node_names: List[str],
                          per_node: int) -> tuple:
        """Per-node microbatch counts, in ``node_names`` order, for the
        *real* data path (train/train_step.py ``node_shares``): the
        rebalanced split when a straggler is flagged and every named
        node has a time signal, the equal ``per_node`` split otherwise.
        Always sums to ``per_node * len(node_names)`` — the total
        work per step is invariant, only its placement skews — and the
        equal fallback is exactly the uniform tuple, which is what lets
        a consumer dispatch to the unskewed (bit-identical) compute
        path when there is nothing to rebalance."""
        equal = tuple([per_node] * len(node_names))
        if per_node < 1 or len(node_names) < 2:
            return equal
        if not self.stragglers() \
                or any(n not in self.ema for n in node_names):
            return equal
        shares = self.rebalanced_shares(per_node * len(node_names),
                                        nodes=node_names)
        return tuple(shares[n] for n in node_names)
