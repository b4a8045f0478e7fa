"""Typed span tracing for the fabric runtime.

The paper's method is measurement: §4–§6 instrument every
client/SoC/host communication path and attribute time on each to the
flow that held it. This module is that instrumentation for the
simulated stack — one substrate that every tenant (serve, train,
offload, fleet) shares instead of the bespoke telemetry each layer
used to keep by hand.

``Span``       one attributed interval: kind (transfer / compute /
               barrier / process / phase), identity
               ``(tenant, flow, path, direction)``, ``t_start``/
               ``t_end`` in simulated seconds, and — for capacity-
               holding spans — a ``rate_timeline`` of ``(t, rate)``
               steps. Every fair-share rebalance that changes the
               member's rate appends a step, so a span *is* the
               paper-style time/rate attribution of its flow:
               ``busy_units()`` integrates the timeline.
``Tracer``     collects spans from hooks in ``core/runtime.py``
               (transfer begin / rate change / complete / cancel,
               ``Barrier`` release, ``Process`` start/finish) and
               offers ``phase()`` / ``begin_phase`` for consumer-level
               intervals (a DDP gradient bucket, an offload program).
``NullTracer`` the default: ``enabled = False``. The runtime guards
               every hook site on a cached boolean, so with tracing
               off the hot path pays one attribute load + branch —
               cheap enough that the ``scale/runtime_events_per_s``
               floor is unchanged (gated in scripts/ci.sh for the JAX package).

Tracing is record-only by construction: hooks never touch the clock,
the ledger, or any transfer state, so a traced run is bit-identical
to an untraced one (asserted in tests/test_obs.py, and this copy
against it in tests/test_torch_fabric.py).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Tuple

TRANSFER = "transfer"
COMPUTE = "compute"
BARRIER = "barrier"
PROCESS = "process"
PHASE = "phase"
KINDS = (TRANSFER, COMPUTE, BARRIER, PROCESS, PHASE)


class Span:
    """One attributed interval on the simulated timeline."""
    __slots__ = ("kind", "name", "tenant", "flow", "path", "direction",
                 "t_start", "t_end", "parent", "meta", "rate_timeline")

    def __init__(self, kind: str, name: str, t_start: float, *,
                 tenant: Optional[str] = None, flow: Optional[str] = None,
                 path: Optional[str] = None, direction: Optional[str] = None,
                 parent: Optional["Span"] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.name = name
        self.tenant = tenant
        self.flow = flow
        self.path = path
        self.direction = direction
        self.t_start = t_start
        self.t_end: Optional[float] = None
        self.parent = parent
        self.meta: Dict[str, Any] = meta if meta is not None else {}
        #: (t, rate) steps; the rate holds from each step until the next
        self.rate_timeline: List[Tuple[float, float]] = []

    @property
    def closed(self) -> bool:
        return self.t_end is not None

    @property
    def duration(self) -> float:
        end = self.t_end if self.t_end is not None else self.t_start
        return end - self.t_start

    def rate_at(self, t: float) -> float:
        """The reserved rate in effect at simulated time ``t`` (the last
        timeline step at or before ``t``; 0 outside the span)."""
        rate = 0.0
        for ts, r in self.rate_timeline:
            if ts > t:
                break
            rate = r
        return rate

    def busy_units(self, until: Optional[float] = None) -> float:
        """Integral of the rate timeline — path units actually moved
        while this span held capacity. For an open span, integrates up
        to ``until`` (required then)."""
        end = self.t_end
        if end is None:
            if until is None:
                raise ValueError(f"open span {self.name!r} needs until=")
            end = until
        total = 0.0
        tl = self.rate_timeline
        for i, (ts, r) in enumerate(tl):
            nxt = tl[i + 1][0] if i + 1 < len(tl) else end
            if nxt > ts and r > 0:
                total += r * (nxt - ts)
        return total

    def to_dict(self) -> Dict[str, Any]:
        d: Dict[str, Any] = {"kind": self.kind, "name": self.name,
                             "t_start": self.t_start, "t_end": self.t_end}
        for k in ("tenant", "flow", "path", "direction"):
            v = getattr(self, k)
            if v is not None:
                d[k] = v
        if self.rate_timeline:
            d["rate_timeline"] = list(self.rate_timeline)
        if self.meta:
            d["meta"] = dict(self.meta)
        return d

    def __repr__(self) -> str:
        end = f"{self.t_end:.6g}" if self.t_end is not None else "open"
        return f"Span({self.kind}:{self.name}, {self.t_start:.6g}->{end})"


class NullTracer:
    """The default tracer: every hook is a no-op and ``enabled`` is
    False, so the runtime skips the calls entirely (one cached-bool
    branch per hook site). Also the base class of ``Tracer`` — the two
    share one surface, so call sites never check which one they hold."""

    enabled = False
    spans: Tuple[Span, ...] = ()
    fabric = None

    def _attach(self, runtime) -> None:
        pass

    def now(self) -> float:
        return 0.0

    def open_spans(self) -> List[Span]:
        return []

    def busy_units(self, **kw) -> Dict[Tuple[Optional[str], str, str], float]:
        return {}

    def busy_fraction(self, **kw) -> Dict[Tuple[Optional[str], str, str],
                                          float]:
        return {}

    # -- runtime hooks ---------------------------------------------------
    def on_transfer_start(self, t) -> None:
        pass

    def on_transfer_rate(self, t, now: float, rate: float) -> None:
        pass

    def on_transfer_end(self, t) -> None:
        pass

    def on_barrier_release(self, barrier, now: float) -> None:
        pass

    def on_process_start(self, proc, now: float) -> None:
        pass

    def on_process_end(self, proc, now: float) -> None:
        pass

    # -- consumer-level phases -------------------------------------------
    def begin_phase(self, name: str, *, tenant: Optional[str] = None,
                    parent: Optional[Span] = None, **meta) -> Optional[Span]:
        return None

    def end_phase(self, span: Optional[Span], **meta) -> None:
        pass

    @contextmanager
    def phase(self, name: str, *, tenant: Optional[str] = None,
              **meta) -> Iterator[Optional[Span]]:
        yield None


#: shared default instance — FabricRuntime(tracer=None) binds to this
NULL_TRACER = NullTracer()


class Tracer(NullTracer):
    """Collects spans from an attached runtime (pass
    ``FabricRuntime(fabric, tracer=Tracer())``) and from consumer
    ``phase()`` calls. ``spans`` holds closed spans in closure order;
    ``open_spans()`` lists what is still in flight."""

    enabled = True

    def __init__(self, clock=None):
        self.clock = clock               # set on attach if not given
        self.fabric = None               # last attached runtime's fabric
        self.spans: List[Span] = []
        self._open_transfers: Dict[int, Span] = {}
        self._open_procs: Dict[int, Span] = {}
        self._open_phases: Dict[int, Span] = {}
        self._stack: List[Span] = []     # phase() context-manager nesting

    def _attach(self, runtime) -> None:
        if self.clock is None:
            self.clock = runtime.clock
        self.fabric = runtime.fabric

    def now(self) -> float:
        return self.clock.now if self.clock is not None else 0.0

    def open_spans(self) -> List[Span]:
        return (list(self._open_transfers.values())
                + list(self._open_procs.values())
                + list(self._open_phases.values()))

    def _close(self, span: Span, t_end: float) -> None:
        span.t_end = t_end
        self.spans.append(span)

    # -- runtime hooks ---------------------------------------------------
    def on_transfer_start(self, t) -> None:
        kind = COMPUTE if hasattr(t, "ops") else TRANSFER
        span = Span(kind, t.flow, t.started_at, tenant=t.tenant, flow=t.flow,
                    path=t.path, direction=t.direction,
                    meta={"amount": t.amount})
        span.rate_timeline.append((t.started_at, 0.0))
        self._open_transfers[id(t)] = span

    def on_transfer_rate(self, t, now: float, rate: float) -> None:
        span = self._open_transfers.get(id(t))
        if span is not None:
            tl = span.rate_timeline
            if tl and tl[-1][0] == now:
                tl[-1] = (now, rate)     # same-instant re-split: last wins
            else:
                tl.append((now, rate))

    def on_transfer_end(self, t) -> None:
        span = self._open_transfers.pop(id(t), None)
        if span is None:
            return
        end = t.finished_at
        tl = span.rate_timeline
        if tl and tl[-1][0] == end:
            tl[-1] = (end, 0.0)
        else:
            tl.append((end, 0.0))
        if t.canceled:
            span.meta["canceled"] = True
            span.meta["remaining"] = t.remaining
        self._close(span, end)

    def on_barrier_release(self, barrier, now: float) -> None:
        span = Span(BARRIER, barrier.name, now,
                    meta={"generation": barrier.generation,
                          "parties": barrier.parties})
        self._close(span, now)

    def on_process_start(self, proc, now: float) -> None:
        self._open_procs[id(proc)] = Span(PROCESS, proc.name, now)

    def on_process_end(self, proc, now: float) -> None:
        span = self._open_procs.pop(id(proc), None)
        if span is None:
            return
        if proc.killed:
            span.meta["killed"] = True
        self._close(span, now)

    # -- consumer-level phases -------------------------------------------
    def begin_phase(self, name: str, *, tenant: Optional[str] = None,
                    parent: Optional[Span] = None, **meta) -> Span:
        span = Span(PHASE, name, self.now(), tenant=tenant, parent=parent,
                    meta=meta)
        self._open_phases[id(span)] = span
        return span

    def end_phase(self, span: Optional[Span], **meta) -> None:
        if span is None:
            return
        self._open_phases.pop(id(span), None)
        if meta:
            span.meta.update(meta)
        self._close(span, self.now())

    @contextmanager
    def phase(self, name: str, *, tenant: Optional[str] = None,
              **meta) -> Iterator[Span]:
        parent = self._stack[-1] if self._stack else None
        span = self.begin_phase(name, tenant=tenant, parent=parent, **meta)
        self._stack.append(span)
        try:
            yield span
        finally:
            self._stack.pop()
            self.end_phase(span)

    # -- attribution -----------------------------------------------------
    def busy_units(self, *, kinds: Tuple[str, ...] = (TRANSFER, COMPUTE),
                   until: Optional[float] = None,
                   ) -> Dict[Tuple[Optional[str], str, str], float]:
        """Path units moved per ``(tenant, path, direction)`` — the
        integral of every span's rate timeline. Open spans are included
        up to ``until`` (default: the clock's now)."""
        if until is None:
            until = self.now()
        out: Dict[Tuple[Optional[str], str, str], float] = {}
        for span in list(self.spans) + list(self._open_transfers.values()):
            if span.kind not in kinds or span.path is None:
                continue
            key = (span.tenant, span.path, span.direction)
            out[key] = out.get(key, 0.0) + span.busy_units(until=until)
        return out

    def busy_fraction(self, *, fabric=None, elapsed: Optional[float] = None,
                      kinds: Tuple[str, ...] = (TRANSFER, COMPUTE),
                      ) -> Dict[Tuple[Optional[str], str, str], float]:
        """``busy_units`` normalized by raw path capacity × elapsed —
        directly comparable to ``InterferenceReport`` occupancy
        attribution (which samples the same quantity from the ledger)."""
        fabric = fabric if fabric is not None else self.fabric
        if fabric is None:
            raise ValueError("busy_fraction needs a fabric (attach a "
                             "runtime or pass fabric=)")
        if elapsed is None:
            elapsed = self.now()
        out: Dict[Tuple[Optional[str], str, str], float] = {}
        for (tenant, path, direction), units in self.busy_units(
                kinds=kinds).items():
            cap = fabric.direction_capacity(path, direction)
            if cap > 0 and elapsed > 0:
                out[(tenant, path, direction)] = units / (cap * elapsed)
        return out
