"""SLO-driven admission control for serve+train colocation.

QoS weights (tenancy/qos.py) bound the *rate* a train flow can take
from a contended path, but they cannot stop the train tenant from
keeping a path busy for seconds at a time — and the paper's §6 lesson
is that a loaded direction moves tail latency, not just throughput.
The ``AdmissionController`` closes that loop: a periodic runtime
process samples the serve tenant's SLO attainment (completed TTFTs
plus the train tenant's *live ledger occupancy* of the serve paths)
and, on a violation, *defers* the train tenant's fabric traffic —
``TrainCluster.pause_transfers`` cancels the in-flight allreduce and
checkpoint transfers (their reservations return to the ledger
instantly) and the node processes park until ``resume_transfers``
re-issues the canceled remainders. Deferral, not preemption of state:
no gradient bytes are lost, the train step simply finishes later.

Resume happens when the serve tenant's tail recovers: every completion
since the pause is back inside the SLO, or the serve tenant has no
latency-critical (prefill) work left in flight.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.fabric import OUT
from repro_torch.tenancy.qos import TRAIN


def percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (same convention as
    ``ReplicationTiming.percentile``; note ``np.percentile`` — used by
    the serve launcher — interpolates instead)."""
    if not samples:
        raise ValueError("percentile of no samples")
    xs = sorted(samples)
    return xs[min(len(xs) - 1, max(0, int(math.ceil(q / 100.0 * len(xs))) - 1))]


@dataclass(frozen=True)
class AdmissionConfig:
    """Policy knobs for the controller.

    ``slo_ttft``        the serve tenant's TTFT bound, seconds (e.g.
                        1.2x its solo p99).
    ``check_every``     sampling period of the controller process.
    ``window_s``        how far back completed TTFTs count toward the
                        violation check.
    ``resume_margin``   completions since the pause must be within
                        ``resume_margin * slo_ttft`` to resume early.
    ``occupancy_limit`` optional pre-emptive trigger: pause when the
                        train tenant holds more than this fraction of a
                        watched path's outbound capacity *while* the
                        serve tenant has prefill work pending — acting
                        on ledger occupancy before a tail sample is
                        even complete. ``watch_paths`` names the
                        serve-critical paths (typically the prefill
                        path); empty = TTFT-driven only.
    ``drain_chunks``    pause via ``pause_transfers(cancel=False)``:
                        in-flight transfers drain instead of being
                        canceled, and the pause takes effect at the
                        next chunk boundary — meaningful when the
                        cluster time model chunks its transfers
                        (ClusterTimeModel.chunk_bytes), where a chunk
                        is small enough that draining beats the
                        cancel/re-issue churn.
    """
    slo_ttft: float
    check_every: float = 0.01
    window_s: float = 1.0
    resume_margin: float = 1.0
    occupancy_limit: Optional[float] = None
    watch_paths: Tuple[str, ...] = ()
    drain_chunks: bool = False


class AdmissionController:
    """Watches the serve tenant, throttles the train tenant (see module
    docstring). ``engine`` needs ``ttft_log``/``prefill_backlog``;
    ``cluster`` needs ``pause_transfers``/``resume_transfers``."""

    def __init__(self, runtime, engine, cluster, config: AdmissionConfig):
        self.runtime = runtime
        self.engine = engine
        self.cluster = cluster
        self.cfg = config
        self.events: List[dict] = []
        self.throttles = 0
        self.paused = False
        self._paused_at = 0.0
        self._resumed_at = -math.inf   # violation-window floor (no thrash)
        self._proc = None

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "AdmissionController":
        if self._proc is None or self._proc.done:
            self._proc = self.runtime.every(self.cfg.check_every, self._tick,
                                            name="admission", start_delay=0.0)
        return self

    def stop(self) -> None:
        """Kill the watcher; never leave the train tenant paused."""
        if self._proc is not None:
            self._proc.kill()
            self._proc = None
        if self.paused:
            self._do_resume("controller_stopped")

    # -- the control loop ------------------------------------------------
    def _train_occupancy(self) -> float:
        """Worst-case train-tenant share of the watched paths' outbound
        capacity, straight from the live ledger reservations."""
        worst = 0.0
        for path in self.cfg.watch_paths:
            held = self.runtime.occupancy(path, OUT, by_tenant=True)
            worst = max(worst, held.get(TRAIN, 0.0))
        return worst

    def _tick(self) -> None:
        now = self.runtime.clock.now
        if not self.paused:
            if self.engine.prefill_backlog == 0:
                return        # nothing latency-critical to protect
            # samples older than the last resume were already acted on —
            # counting them again would thrash pause/resume for a full
            # window after every recovery
            floor = max(now - self.cfg.window_s, self._resumed_at)
            recent = [ttft for t, ttft in self.engine.ttft_log
                      if t > floor]
            violated = bool(recent) and percentile(recent, 99) > self.cfg.slo_ttft
            crowded = (self.cfg.occupancy_limit is not None
                       and self.engine.prefill_backlog > 0
                       and self._train_occupancy() > self.cfg.occupancy_limit)
            if violated or crowded:
                self.paused = True
                self._paused_at = now
                self.throttles += 1
                if self.cfg.drain_chunks:
                    self.cluster.pause_transfers(cancel=False)
                else:
                    self.cluster.pause_transfers()
                self.events.append({
                    "t": now, "event": "throttle",
                    "reason": "slo_violation" if violated else "occupancy",
                    "p99": percentile(recent, 99) if recent else None})
            return
        since = [ttft for t, ttft in self.engine.ttft_log
                 if t >= self._paused_at]
        recovered = bool(since) and \
            percentile(since, 99) <= self.cfg.resume_margin * self.cfg.slo_ttft
        if recovered or self.engine.prefill_backlog == 0:
            self._do_resume("recovered" if recovered else "serve_idle")

    def _do_resume(self, reason: str) -> None:
        self.paused = False
        self._resumed_at = self.runtime.clock.now
        self.cluster.resume_transfers()
        self.events.append({"t": self.runtime.clock.now, "event": "resume",
                            "reason": reason})


# ----------------------------------------------------------------------
# K-tenant arbitration (the serving fleet)
# ----------------------------------------------------------------------

@dataclass
class AdmittedTenant:
    """One tenant under fleet arbitration.

    ``priority`` orders protection: a violated higher-priority latency
    tenant causes lower-priority tenants to be deferred, lowest first.
    ``slo_ttft``+``engine`` make the tenant a *watched* (violation
    source) tenant — the engine needs ``ttft_log``/``prefill_backlog``;
    ``pause``/``resume`` make it a *deferrable* (victim) tenant — e.g.
    ``StagedServeEngine.pause_intake``/``resume_intake`` for a serve
    tenant or ``TrainCluster.pause_transfers``/``resume_transfers`` for
    a colocated train tenant. A tenant may be both.
    """
    name: str
    priority: int = 0
    slo_ttft: Optional[float] = None
    engine: object = None
    pause: Optional[Callable[[], None]] = None
    resume: Optional[Callable[[], None]] = None


class FleetAdmissionController:
    """K-tenant generalization of ``AdmissionController``: when two (or
    more) latency-class tenants contend, SLO violations at a
    higher-priority tenant defer lower-priority tenants one at a time,
    lowest priority first — a LIFO stack of victims, resumed in reverse
    order once every watched tenant above them has recovered (tail back
    inside ``resume_margin * slo`` since the pause, or no
    latency-critical work pending). Deferral, never loss: a paused serve
    tenant stops *dispatching* prefills, its queued requests are served
    later with identical tokens."""

    def __init__(self, runtime, tenants: Sequence[AdmittedTenant], *,
                 check_every: float = 0.01, window_s: float = 1.0,
                 resume_margin: float = 1.0):
        if not tenants:
            raise ValueError("fleet admission needs at least one tenant")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.runtime = runtime
        # stable order: priority desc, declaration order breaks ties
        self.tenants = sorted(tenants, key=lambda t: -t.priority)
        self.check_every = check_every
        self.window_s = window_s
        self.resume_margin = resume_margin
        self.events: List[dict] = []
        self.throttles = 0
        self._victims: List[AdmittedTenant] = []   # LIFO pause stack
        self._paused_at: Dict[str, float] = {}
        self._resumed_at = -math.inf
        self._proc = None

    @property
    def paused_tenants(self) -> List[str]:
        return [t.name for t in self._victims]

    # -- lifecycle -------------------------------------------------------
    def start(self) -> "FleetAdmissionController":
        if self._proc is None or self._proc.done:
            self._proc = self.runtime.every(self.check_every, self._tick,
                                            name="fleet-admission",
                                            start_delay=0.0)
        return self

    def stop(self) -> None:
        """Kill the watcher; resume every deferred tenant (LIFO)."""
        if self._proc is not None:
            self._proc.kill()
            self._proc = None
        while self._victims:
            self._do_resume("controller_stopped")

    # -- the control loop ------------------------------------------------
    def _watched_above(self, victim: AdmittedTenant) -> List[AdmittedTenant]:
        return [t for t in self.tenants
                if t.priority > victim.priority
                and t.slo_ttft is not None and t.engine is not None]

    def _violated(self, t: AdmittedTenant, now: float) -> bool:
        if t.slo_ttft is None or t.engine is None:
            return False
        if t.engine.prefill_backlog == 0:
            return False      # nothing latency-critical to protect
        floor = max(now - self.window_s, self._resumed_at)
        recent = [ttft for ts, ttft in t.engine.ttft_log if ts > floor]
        return bool(recent) and percentile(recent, 99) > t.slo_ttft

    def _recovered(self, watched: AdmittedTenant, paused_at: float) -> bool:
        if watched.engine.prefill_backlog == 0:
            return True
        since = [ttft for ts, ttft in watched.engine.ttft_log
                 if ts >= paused_at]
        return bool(since) and percentile(since, 99) <= \
            self.resume_margin * watched.slo_ttft

    def _tick(self) -> None:
        now = self.runtime.clock.now
        # resume first (LIFO): the most recent victim comes back once
        # every watched tenant above it has recovered since its pause
        if self._victims:
            top = self._victims[-1]
            watched = self._watched_above(top)
            if all(self._recovered(w, self._paused_at[top.name])
                   for w in watched):
                self._do_resume("recovered")
                return
        offender = next((t for t in self.tenants if self._violated(t, now)),
                        None)
        if offender is None:
            return
        # defer the lowest-priority still-running tenant below the
        # offender — one per tick, escalating up the priority ladder
        # while the violation persists
        candidates = [t for t in self.tenants
                      if t.priority < offender.priority
                      and t.pause is not None and t not in self._victims]
        if not candidates:
            return
        victim = candidates[-1]        # tenants sorted desc -> last is lowest
        victim.pause()
        self._victims.append(victim)
        self._paused_at[victim.name] = now
        self.throttles += 1
        self.events.append({"t": now, "event": "throttle",
                            "offender": offender.name,
                            "victim": victim.name})

    def _do_resume(self, reason: str) -> None:
        victim = self._victims.pop()
        self._resumed_at = self.runtime.clock.now
        if victim.resume is not None:
            victim.resume()
        self.events.append({"t": self.runtime.clock.now, "event": "resume",
                            "victim": victim.name, "reason": reason})
