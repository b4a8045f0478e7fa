"""TTFT-driven decode autoscaling on the FabricRuntime.

The control loop the burst trace demands: a periodic runtime process
per tenant watches its TTFT SLO *attainment* (fraction of recent
completions inside the SLO) and decode-path occupancy, and spawns or
retires decode replicas on the tenant's ``StagedServeEngine``
(``add_decode_replica``/``retire_decode_replica`` — runtime Processes,
retired via ``Process.kill()`` + transfer cancel, with the unmoved
remainder re-queued so token streams are bit-identical across scale
events).

Why scaling decode helps TTFT at all: in the fleet topology every
tenant's prefill shares one host path with the base decode traffic.
Spawning a replica *moves* a tenant's decode reads onto a replica-
private path (the base fallback stops serving while extras exist), so
the shared path drains for prefill — the same bytes, a different wire,
which is the paper's multipath guideline applied as a control action.

Hysteresis: scale-out and scale-in have separate cooldowns (out short —
react to a burst; in long — don't flap on noise), and scale-in
additionally requires sustained attainment at target, an empty prefill
backlog, and low occupancy on the newest replica's path. On steady
in-capacity load the autoscaler provably does nothing (tested).

``ReplicaPool`` is the fleet-wide inventory of pre-provisioned replica
paths: autoscalers acquire/release from one shared pool, so two tenants
bursting together contend for real capacity instead of conjuring it.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List, Optional, Sequence

from repro_torch.core.fabric import OUT


def ttft_attainment(samples: Sequence[float], slo: float) -> float:
    """Fraction of TTFT samples inside the SLO (1.0 for no samples —
    an idle tenant is not in violation)."""
    if not samples:
        return 1.0
    return sum(1 for x in samples if x <= slo) / len(samples)


@dataclass(frozen=True)
class AutoscaleConfig:
    """Policy knobs for one tenant's autoscaler.

    ``target_attainment``  scale out while the windowed attainment is
                           below this; scale in only at/above it.
    ``window_s``           how far back TTFT completions count.
    ``check_every``        controller sampling period.
    ``out_cooldown``       min seconds between scale-outs (one replica
                           per violation tick, rate-limited).
    ``in_cooldown``        min seconds after the *last scale event in
                           either direction* before a scale-in — the
                           hysteresis that prevents flapping.
    ``occupancy_low``      a replica is retirable only while its path's
                           outbound occupancy is at or below this.
    ``max_replicas``       cap on extra replicas (the pool may be
                           smaller still).
    ``min_samples``        violation verdicts need at least this many
                           samples in the window.
    """
    target_attainment: float = 0.95
    window_s: float = 2.0
    check_every: float = 0.25
    out_cooldown: float = 0.5
    in_cooldown: float = 4.0
    occupancy_low: float = 0.3
    max_replicas: int = 4
    min_samples: int = 4

    def __post_init__(self):
        if not 0.0 < self.target_attainment <= 1.0:
            raise ValueError(f"target_attainment must be in (0, 1], "
                             f"got {self.target_attainment}")
        for name in ("window_s", "check_every", "out_cooldown",
                     "in_cooldown"):
            if getattr(self, name) <= 0:
                raise ValueError(f"{name} must be > 0")
        if self.max_replicas < 1:
            raise ValueError("max_replicas must be >= 1")


class ReplicaPool:
    """The fleet's shared inventory of pre-provisioned decode-replica
    paths. FIFO and deterministic: paths are handed out in declaration
    order and returned to the back of the queue."""

    def __init__(self, paths: Sequence[str]):
        self.capacity = len(list(paths))
        self._free: List[str] = list(paths)

    @property
    def free(self) -> int:
        return len(self._free)

    def acquire(self) -> Optional[str]:
        return self._free.pop(0) if self._free else None

    def release(self, path: str) -> None:
        if path in self._free:
            raise ValueError(f"path {path!r} released twice")
        self._free.append(path)


class Autoscaler:
    """One tenant's decode-replica control loop (see module docstring).

    ``engine`` must be a ``StagedServeEngine`` built with
    ``decode_pool=True``; ``pool`` supplies replica paths (shared across
    the fleet's autoscalers)."""

    def __init__(self, runtime, engine, *, slo_ttft: float,
                 pool: ReplicaPool, config: AutoscaleConfig = AutoscaleConfig(),
                 name: str = "autoscaler"):
        if slo_ttft <= 0:
            raise ValueError(f"slo_ttft must be > 0, got {slo_ttft}")
        self.runtime = runtime
        self.engine = engine
        self.slo = slo_ttft
        self.pool = pool
        self.cfg = config
        self.name = name
        self.events: List[dict] = []
        self._held: List[str] = []           # acquired replica paths, LIFO
        self._last_out = -math.inf
        self._last_in = -math.inf
        self._proc = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "Autoscaler":
        if self._proc is None or self._proc.done:
            self._proc = self.runtime.every(self.cfg.check_every, self._tick,
                                            name=self.name, start_delay=0.0)
        return self

    def stop(self) -> None:
        """Kill the watcher. Held replicas stay up — the fleet drains
        through them; ``release_all`` returns the paths afterwards."""
        if self._proc is not None:
            self._proc.kill()
            self._proc = None

    def release_all(self) -> None:
        while self.engine.n_decode_replicas > 0:
            rep = self.engine.retire_decode_replica()
            if rep is None:
                break
            if rep.path in self._held:
                self._held.remove(rep.path)
                self.pool.release(rep.path)

    @property
    def replicas(self) -> int:
        return self.engine.n_decode_replicas

    # -- the control loop ------------------------------------------------
    def _attainment(self, now: float):
        recent = [ttft for t, ttft in self.engine.ttft_log
                  if t > now - self.cfg.window_s]
        return recent, ttft_attainment(recent, self.slo)

    def _tick(self) -> None:
        cfg, eng = self.cfg, self.engine
        now = self.runtime.clock.now
        recent, att = self._attainment(now)
        n = eng.n_decode_replicas
        # -- scale out: attainment under target on real evidence --------
        if len(recent) >= cfg.min_samples and att < cfg.target_attainment \
                and n < cfg.max_replicas \
                and now - self._last_out >= cfg.out_cooldown:
            path = self.pool.acquire()
            if path is None:
                self.events.append({"t": now, "event": "pool_exhausted",
                                    "attainment": att})
                return
            eng.add_decode_replica(path)
            self._held.append(path)
            self._last_out = now
            self.events.append({"t": now, "event": "scale_out", "path": path,
                                "replicas": n + 1, "attainment": att})
            return
        # -- scale in: sustained health, idle tail, cold replica --------
        if n > 0 and att >= cfg.target_attainment \
                and eng.prefill_backlog == 0 \
                and now - self._last_out >= cfg.in_cooldown \
                and now - self._last_in >= cfg.in_cooldown:
            newest = self._held[-1] if self._held else None
            if newest is None:
                return
            if self.runtime.occupancy(newest, OUT) > cfg.occupancy_low:
                return
            rep = eng.retire_decode_replica()
            if rep is None:
                return
            if rep.path in self._held:
                self._held.remove(rep.path)
                self.pool.release(rep.path)
            self._last_in = now
            self.events.append({"t": now, "event": "scale_in",
                                "path": rep.path, "replicas": n - 1,
                                "attainment": att})
