"""Fault tolerance: heartbeat failure detection + checkpoint/restart.

On a real cluster each host heartbeats to this manager (or to etcd/GCS);
here nodes are registered entities whose heartbeats tests (or the
simulated ``TrainCluster``) drive explicitly. The recovery policy is the
deliverable:

  failure detected -> quiesce -> pick survivor mesh (ft/elastic.py)
  -> restore newest committed checkpoint (any replica in the chain)
  -> reshard state onto the survivor mesh -> resume at step k+1.

Because the data pipeline is stateless-addressable (data/pipeline.py),
resume needs nothing beyond the step index.

Two detection modes:

- wall clock (default): callers poll ``check()``, which sweeps for
  lapsed heartbeats — the original behaviour, preserved.
- event-driven (``runtime=`` a ``FabricRuntime``): every heartbeat
  re-arms a per-node watchdog on the simulated clock; a node that goes
  silent fires the ``failed`` Signal exactly ``timeout`` simulated
  seconds after its last heartbeat, with no polling loop. The
  TrainCluster's failure watch yields on that Signal.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from repro_torch.ckpt.checkpoint import CheckpointManager


class NodeFailure(RuntimeError):
    """A node went silent and its failure watchdog expired. Raised by
    single-node loops (Trainer.run_steps) once the event-driven
    detection fires; the recovery path is checkpoint restore."""


@dataclass
class NodeState:
    name: str
    last_heartbeat: float
    alive: bool = True
    devices: int = 0


class FaultToleranceManager:
    def __init__(self, ckpt: Optional[CheckpointManager], *,
                 timeout: float = 10.0,
                 clock: Callable[[], float] = time.monotonic,
                 runtime=None):
        self.ckpt = ckpt
        self.timeout = timeout
        self.runtime = runtime
        self.clock = (lambda: runtime.clock.now) if runtime is not None \
            else clock
        self.nodes: Dict[str, NodeState] = {}
        self.events: List[dict] = []
        #: fires with the node name when a watchdog expires (runtime mode)
        self.failed = runtime.signal() if runtime is not None else None
        #: expired-watchdog queue — a Signal fire with no waiter drops
        #: its value, so watchers drain this after each wake-up
        self.pending_failures: List[str] = []
        self._watchdogs: Dict[str, object] = {}

    # ---- membership ----
    def register(self, name: str, devices: int = 1):
        self.nodes[name] = NodeState(name, self.clock(), True, devices)
        self._arm(name)

    def heartbeat(self, name: str):
        self.nodes[name].last_heartbeat = self.clock()
        self._arm(name)

    def check(self) -> List[str]:
        """Mark nodes whose heartbeat lapsed; returns newly-failed names.
        (Wall-clock polling mode; the runtime mode needs no polling.)"""
        now = self.clock()
        failed = []
        for n in self.nodes.values():
            if n.alive and now - n.last_heartbeat > self.timeout:
                self._fail(n)
                failed.append(n.name)
        return failed

    def alive_devices(self) -> int:
        return sum(n.devices for n in self.nodes.values() if n.alive)

    # ---- event-driven watchdogs (runtime mode) ----
    def _arm(self, name: str) -> None:
        if self.runtime is None:
            return
        clock = self.runtime.clock
        clock.cancel(self._watchdogs.get(name))
        self._watchdogs[name] = clock.schedule(
            self.timeout * (1 + 1e-9), self._expire, name)

    def _expire(self, name: str) -> None:
        self._watchdogs.pop(name, None)
        n = self.nodes.get(name)
        if n is not None and n.alive:
            self._fail(n)
            self.pending_failures.append(name)
            if self.failed is not None:
                self.failed.fire(name)

    def _fail(self, n: NodeState) -> None:
        n.alive = False
        self.events.append({"t": self.clock(), "event": "node_failed",
                            "node": n.name})

    def disarm(self) -> None:
        """Cancel every pending watchdog (lets a SimClock heap drain)."""
        if self.runtime is not None:
            for ev in self._watchdogs.values():
                self.runtime.clock.cancel(ev)
        self._watchdogs.clear()

    # ---- recovery ----
    def recover(self, like_tree, *, step: Optional[int] = None):
        """Restore the newest committed checkpoint (chain fallback built
        into CheckpointManager.restore). Returns (tree, resume_step)."""
        tree, k = self.ckpt.restore(like_tree, step)
        self.events.append({"t": self.clock(), "event": "restored", "step": k})
        return tree, k + 1
