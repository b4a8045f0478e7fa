"""Event-driven fabric runtime: simulated-time transfers over the Fabric.

The fabric alone makes the path model *static*: ``MultipathRouter.blend``
returns a closed-form rate and every consumer asks "what is the
steady-state bandwidth?" once. The paper's wins, however, are *temporal* — a
transfer on one path overlapping compute, or a transfer on another
path, under load. This module is the discrete-event timeline that
captures exactly that:

``SimClock``      a monotonically-advancing simulated clock with an
                  event heap (``schedule``/``at``/``cancel``/``run``).
``Transfer``      an in-flight amount (path units) on one ``Path``
                  direction. It reserves its *current rate* in the
                  ``BudgetLedger`` and occupies the path for
                  ``amount / effective_rate`` simulated seconds.
                  Concurrent transfers on a path (or on a path in the
                  same ``shared_group``) fair-share the capacity, and
                  the §4.1 concurrency discount *emerges* — two
                  overlapping flows each see
                  ``capacity * (1 - discount) / 2``, not a constant
                  factor applied by a call site.
``Compute``       the ops/s analog of ``Transfer`` on a *compute*
                  resource (SoC ARM cores, a DCA engine — see
                  fabric.compute_path): total ops fair-share the
                  device roofline in the same ledger, so compute
                  occupancy, QoS weighting and conservation follow the
                  exact rules wires do.
``Process``       a generator-driven coroutine. Yield a ``Transfer``
                  (resume on completion), a number (resume after that
                  many simulated seconds), a ``Signal`` (resume when
                  fired) or another ``Process`` (resume when it
                  returns). Completion callbacks and Processes are how
                  dependent work is driven. ``kill()`` stops a process
                  and cancels the transfer it is waiting on.
``Barrier``       an N-party collective rendezvous: each party yields
                  ``barrier.arrive()``; everyone resumes when the last
                  party arrives (the allreduce synchronization point of
                  a data-parallel step). ``remove_party`` shrinks the
                  membership mid-generation (elastic resize).
``FabricRuntime`` ties a ``Fabric`` + ``BudgetLedger`` + ``SimClock``
                  together and owns rate rebalancing. ``every()`` spawns
                  a periodic process (heartbeats); ``cancel()`` aborts
                  an in-flight transfer, releasing its reservation.

Rebalancing model: active transfers are indexed per interference group
into per-(path, direction) *buckets* (insertion-ordered sets with O(1)
membership). When a transfer joins or leaves, only its own bucket is
recomputed — the group's per-direction capacity (discounted iff more
than one distinct flow is active on the group, counting non-transfer
ledger holders via an O(1)-maintained counter) is split among the
bucket's members by *weighted* max-min fairness. A member whose rate
comes out exactly unchanged is left alone: its progress anchor,
reservation and scheduled completion event all stay — progress is
settled lazily, only when the rate actually changes, which makes the
recomputation idempotent and lets untouched buckets keep their state
bit-identically. If the group's discount flag flips (the holder count
crosses 1), every bucket of the group is recomputed, since the flip
changes every bucket's capacity. ``FabricRuntime(rebalance="global")``
keeps the pre-indexed behavior — recompute all buckets of the group on
any mutation — as a debug oracle; both modes produce bit-identical
(time, rate, remaining) traces by construction (asserted by a property
test in tests/test_simcore.py).

Weights come from the runtime's QoS policy (any object with
``weight(tenant) -> float``; see tenancy/qos.QoSPolicy) applied to each
transfer's ``tenant`` tag — with no policy, or all weights equal, the
split degenerates to the equal shares of the untenanted runtime. Path
``latency`` is served as a pure delay before the transfer starts
occupying capacity. External ledger reservations (e.g. a primary
functionality's pre-reserved traffic) are respected: transfers only
share what the ledger has left — note that after an *external* ledger
change (or a QoS weight change), rates are stale until ``rebalance()``
is called for the affected path, in either mode.

Conservation: every reservation a transfer makes is released when it
finishes, so after a quiescent run the ledger is back to its external
reservations only — asserted in tests/test_runtime.py.
"""
from __future__ import annotations

import heapq
import itertools
import math
from typing import (Any, Callable, Dict, Generator, List, Optional, Tuple)

from repro_torch.core.fabric import (BudgetLedger, Fabric, FabricError, IN,
                                     OUT, OPS_PER_S)
from repro_torch.obs.trace import NULL_TRACER

#: relative tolerance for "this rebalance did not change your rate":
#: recomputing an untouched bucket reproduces its shares only up to the
#: ledger's accumulated float rounding, and an ulp-level delta must not
#: cancel/reschedule completion events (it would make the global oracle
#: drift from the incremental mode)
_RATE_RTOL = 1e-9


class Event:
    """One scheduled callback. Cancel via ``SimClock.cancel``."""
    __slots__ = ("time", "seq", "fn", "args", "canceled")

    def __init__(self, time: float, seq: int, fn: Callable, args: tuple):
        self.time, self.seq, self.fn, self.args = time, seq, fn, args
        self.canceled = False

    def __repr__(self) -> str:
        return f"Event(t={self.time:.6g}, fn={getattr(self.fn, '__name__', self.fn)})"


class SimClock:
    """Discrete-event clock. Deterministic: ties break by schedule order.

    ``processed`` counts executed (non-canceled) events over the clock's
    lifetime — the numerator of the simulator's own throughput metric
    (events/s of *wall* time, benchmarks/bench_scale.py and
    bench_simcore.py), which is what bounds how much simulated traffic a
    scale experiment can afford.

    Cancellation is lazy (a tombstone flag on the Event; the heap entry
    stays), so a rebalance-heavy run used to grow the heap without
    bound. The clock now counts live tombstones and *compacts* — filters
    the canceled entries out and re-heapifies — once they are both
    numerous (>= ``COMPACT_MIN``) and the majority of the heap.
    Compaction preserves (time, seq) order exactly, so it is invisible
    to the simulation; ``compactions`` counts how often it ran."""

    COMPACT_MIN = 256

    def __init__(self, start: float = 0.0):
        self.now = float(start)
        self.processed = 0
        self.compactions = 0
        self._heap: List[Tuple[float, int, Event]] = []
        self._seq = itertools.count()
        self._tombstones = 0               # canceled events still heaped

    def schedule(self, delay: float, fn: Callable, *args) -> Event:
        """Schedule ``fn(*args)`` ``delay`` simulated seconds from now."""
        return self.at(self.now + delay, fn, *args)

    def at(self, time: float, fn: Callable, *args) -> Event:
        if time < self.now - 1e-12:
            raise ValueError(f"cannot schedule in the past ({time} < {self.now})")
        ev = Event(max(time, self.now), next(self._seq), fn, args)
        heapq.heappush(self._heap, (ev.time, ev.seq, ev))
        return ev

    def cancel(self, ev: Optional[Event]) -> None:
        if ev is not None and not ev.canceled:
            ev.canceled = True
            self._tombstones += 1
            if (self._tombstones >= self.COMPACT_MIN
                    and self._tombstones * 2 >= len(self._heap)):
                self._compact()

    def _compact(self) -> None:
        self._heap = [e for e in self._heap if not e[2].canceled]
        heapq.heapify(self._heap)
        self._tombstones = 0
        self.compactions += 1

    @property
    def pending(self) -> int:
        return len(self._heap) - self._tombstones

    def run(self, until: Optional[float] = None,
            stop: Optional[Callable[[], bool]] = None) -> float:
        """Process events in time order until the heap drains, ``until``
        is reached, or ``stop()`` returns True (checked after each
        event). With ``until``, the clock always lands on it (even when
        the heap drains early) unless ``stop`` fired first. Returns the
        clock time."""
        stopped = False
        while self._heap:
            time, _, ev = self._heap[0]
            if until is not None and time > until:
                break
            heapq.heappop(self._heap)
            if ev.canceled:
                self._tombstones -= 1
                continue
            # mark executed so a later cancel() of this event is a no-op
            # (it is no longer in the heap — it must not count as a
            # tombstone)
            ev.canceled = True
            self.now = time
            self.processed += 1
            ev.fn(*ev.args)
            if stop is not None and stop():
                stopped = True
                break
        if until is not None and not stopped and self.now < until:
            self.now = until
        return self.now


class Signal:
    """A broadcast condition: processes wait on it, someone fires it.
    Firing wakes every current waiter at the current simulated time."""

    def __init__(self, clock: SimClock):
        self.clock = clock
        self._waiters: List[Callable[[Any], None]] = []

    def wait(self, fn: Callable[[Any], None]) -> None:
        self._waiters.append(fn)

    def fire(self, value: Any = None) -> None:
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            self.clock.schedule(0.0, w, value)


class Transfer:
    """An in-flight amount on one path direction.

    ``rate`` is the current fair share (path units/s); it changes as
    transfers join/leave the interference group. ``max_rate`` caps the
    share (a slow endpoint); the surplus is water-filled back to the
    uncapped flows. ``done`` flips exactly once; callbacks added after
    completion run immediately (same simulated time). A transfer
    aborted via ``FabricRuntime.cancel`` is ``done`` with
    ``canceled=True`` and ``remaining > 0``."""
    _ids = itertools.count()

    def __init__(self, runtime: "FabricRuntime", path: str, amount: float,
                 *, direction: str = OUT, flow: Optional[str] = None,
                 max_rate: float = math.inf, tenant: Optional[str] = None):
        if amount <= 0:
            raise FabricError("transfer amount must be > 0")
        if direction not in (OUT, IN):
            raise FabricError(f"unknown direction {direction!r}")
        self.runtime = runtime
        self.path = path
        self.direction = direction
        self.tenant = tenant
        self.amount = float(amount)
        self.remaining = float(amount)
        self.flow = flow if flow is not None else f"xfer-{next(self._ids)}"
        self.max_rate = max_rate
        self.rate = 0.0
        self.created_at = runtime.clock.now
        self.started_at: Optional[float] = None   # after the latency phase
        self.finished_at: Optional[float] = None
        self.done = False
        self.canceled = False
        self._last_update = runtime.clock.now
        self._event: Optional[Event] = None        # pending completion
        self._res = 0.0                            # currently reserved rate
        self._callbacks: List[Callable[["Transfer"], None]] = []

    # -- observability --------------------------------------------------
    @property
    def elapsed(self) -> float:
        end = self.finished_at if self.done else self.runtime.clock.now
        return end - self.created_at

    def add_callback(self, fn: Callable[["Transfer"], None]) -> None:
        if self.done:
            self.runtime.clock.schedule(0.0, fn, self)
        else:
            self._callbacks.append(fn)

    def __repr__(self) -> str:
        state = ("canceled" if self.canceled else "done") if self.done \
            else f"{self.remaining:.3g} left @ {self.rate:.3g}/s"
        return f"Transfer({self.path}:{self.direction}, {self.amount:.3g}, {state})"


class Compute(Transfer):
    """An in-flight batch of work on one *compute* resource — the ops/s
    analog of ``Transfer`` (paper premise: the off-path SoC computes,
    it does not just move bytes).

    The resource is an ops/s ``Path`` (see fabric.compute_path /
    dca_path): ``amount`` is total ops, ``rate`` the current fair share
    of the device's roofline, and the reservation lives in the same
    ``BudgetLedger`` as every wire — so compute occupancy shows up in
    ``FabricRuntime.occupancy()``, QoS weights apply per tenant, the
    §4.1 discount emerges on a ``shared_group`` (e.g. SoC cores sharing
    a memory system with the DMA engine), and conservation is the same
    invariant (asserted in tests/test_offload.py). ``ops``/``ops_done``
    are the domain-named views of amount/progress."""
    _ids = itertools.count()

    def __init__(self, runtime: "FabricRuntime", resource: str, ops: float,
                 *, flow: Optional[str] = None, max_rate: float = math.inf,
                 tenant: Optional[str] = None):
        flow = flow if flow is not None else f"comp-{next(self._ids)}"
        super().__init__(runtime, resource, ops, direction=OUT, flow=flow,
                         max_rate=max_rate, tenant=tenant)

    @property
    def ops(self) -> float:
        return self.amount

    @property
    def ops_done(self) -> float:
        return self.amount - self.remaining

    def __repr__(self) -> str:
        state = ("canceled" if self.canceled else "done") if self.done \
            else f"{self.remaining:.3g} ops left @ {self.rate:.3g}/s"
        return f"Compute({self.path}, {self.amount:.3g} ops, {state})"


class Process:
    """Generator-driven coroutine on a runtime (see module docstring for
    the yield protocol). ``result`` is the generator's return value."""

    def __init__(self, runtime: "FabricRuntime",
                 gen: Generator[Any, Any, Any], name: str = "proc"):
        self.runtime = runtime
        self.gen = gen
        self.name = name
        self.done = False
        self.killed = False
        self.result: Any = None
        self._waiting: Any = None           # what the process is blocked on
        self._waiters: List[Callable[[Any], None]] = []
        if runtime._trace:
            runtime.tracer.on_process_start(self, runtime.clock.now)
        runtime.clock.schedule(0.0, self._advance, None)

    def kill(self) -> None:
        """Stop the process. The transfer it is waiting on (if any) is
        canceled — its reservation goes back to the ledger — and
        processes joined on this one resume with ``result=None``."""
        if self.done:
            return
        self.done = True
        self.killed = True
        waiting, self._waiting = self._waiting, None
        if isinstance(waiting, Transfer) and not waiting.done:
            self.runtime.cancel(waiting)
        self.gen.close()
        if self.runtime._trace:
            self.runtime.tracer.on_process_end(self, self.runtime.clock.now)
        waiters, self._waiters = self._waiters, []
        for w in waiters:
            self.runtime.clock.schedule(0.0, w, None)

    def _advance(self, send_value: Any) -> None:
        if self.done:
            return
        self._waiting = None
        try:
            item = self.gen.send(send_value)
        except StopIteration as e:
            self.done = True
            self.result = e.value
            if self.runtime._trace:
                self.runtime.tracer.on_process_end(
                    self, self.runtime.clock.now)
            waiters, self._waiters = self._waiters, []
            for w in waiters:
                self.runtime.clock.schedule(0.0, w, self.result)
            return
        self._wait_on(item)

    def _wait_on(self, item: Any) -> None:
        clock = self.runtime.clock
        self._waiting = item
        if isinstance(item, Transfer):
            item.add_callback(lambda t: self._advance(t))
        elif isinstance(item, Process):
            if item.done:
                clock.schedule(0.0, self._advance, item.result)
            else:
                item._waiters.append(self._advance)
        elif isinstance(item, Signal):
            item.wait(self._advance)
        elif isinstance(item, (int, float)):
            if item < 0:
                raise ValueError(f"process {self.name}: negative delay {item}")
            clock.schedule(float(item), self._advance, None)
        else:
            raise TypeError(
                f"process {self.name} yielded {type(item).__name__}; expected "
                "Transfer, Process, Signal, or a delay in seconds")

    def __repr__(self) -> str:
        state = ("killed" if self.killed else "done") if self.done else "running"
        return f"Process({self.name}, {state})"


class Barrier:
    """An N-party collective rendezvous on simulated time.

    Each party yields ``barrier.arrive()``; when the last party arrives
    the barrier *releases*: ``on_release(generation)`` runs first
    (synchronously — the place for the step's bookkeeping), then every
    waiter resumes at the same simulated instant. The barrier is
    cyclic: after a release it is immediately reusable for the next
    generation. ``remove_party`` shrinks the membership mid-generation
    (a node died); if the survivors are all already waiting, the
    barrier releases so they are not stranded behind the dead party.
    """

    def __init__(self, runtime: "FabricRuntime", parties: int, *,
                 on_release: Optional[Callable[[int], None]] = None,
                 name: str = "barrier"):
        if parties < 1:
            raise ValueError(f"barrier {name}: parties must be >= 1")
        self.runtime = runtime
        self.parties = parties
        self.name = name
        self.generation = 0
        self._count = 0
        self._signal = runtime.signal()
        self._on_release = on_release

    @property
    def waiting(self) -> int:
        return self._count

    def arrive(self):
        """Register one arrival. Returns a yieldable: the last arriver
        resumes immediately (after releasing everyone), earlier
        arrivers resume when the barrier releases."""
        self._count += 1
        if self._count >= self.parties:
            self._release()
            return 0.0
        return self._signal

    def remove_party(self, n: int = 1) -> None:
        if n > self.parties:
            raise ValueError(
                f"barrier {self.name}: removing {n} of {self.parties} parties")
        self.parties -= n
        if 0 < self.parties <= self._count:
            self._release()

    def _release(self) -> None:
        self._count = 0
        self.generation += 1
        rt = self.runtime
        if rt._trace:
            rt.tracer.on_barrier_release(self, rt.clock.now)
        if self._on_release is not None:
            self._on_release(self.generation)
        sig, self._signal = self._signal, self.runtime.signal()
        sig.fire(self.generation)

    def __repr__(self) -> str:
        return (f"Barrier({self.name}, {self._count}/{self.parties} waiting, "
                f"gen={self.generation})")


class FabricRuntime:
    """A Fabric executing in simulated time.

    Owns a ``SimClock`` and a ``BudgetLedger``; ``transfer()`` starts a
    flow, ``process()`` spawns a coroutine, ``signal()`` makes a wait
    condition. The ledger may carry external (non-transfer)
    reservations — transfers share only the remaining budget, and an
    external holder counts toward the §4.1 discount.

    ``qos`` is an optional tenancy policy: any object exposing
    ``weight(tenant) -> float`` (see tenancy/qos.QoSPolicy). Transfers
    tagged with a ``tenant`` then fair-share each (path, direction) in
    proportion to their tenant's weight — a latency-class serve tenant
    can be promised most of a path a throughput-class train tenant is
    also using. Untagged transfers weigh 1.0.

    ``rebalance`` selects the fair-share recomputation strategy:
    ``"incremental"`` (default) touches only the mutated
    (path, direction) bucket; ``"global"`` recomputes every bucket of
    the mutated group on every mutation — the old behavior, kept as a
    bit-identical debug oracle (see the module docstring).

    ``tracer`` is an optional ``obs.trace.Tracer``: when attached, the
    runtime emits typed spans at transfer begin / rate change /
    complete / cancel, at ``Barrier`` release, and around ``Process``
    lifetimes (see repro_torch/obs/). The default is the no-op
    ``NULL_TRACER`` and the hook sites are guarded on a cached bool.
    """

    def __init__(self, fabric: Fabric, *, clock: Optional[SimClock] = None,
                 ledger: Optional[BudgetLedger] = None, qos=None,
                 rebalance: str = "incremental", tracer=None):
        if rebalance not in ("incremental", "global"):
            raise ValueError(
                f"rebalance must be 'incremental' or 'global', got "
                f"{rebalance!r}")
        self.fabric = fabric
        self.clock = clock if clock is not None else SimClock()
        self.ledger = ledger if ledger is not None else fabric.ledger()
        self.qos = qos
        self.rebalance_mode = rebalance
        # observability: hook sites below fire only when a real (enabled)
        # tracer is attached — _trace caches the flag so the hot path
        # pays one attribute load + branch with tracing off (the
        # scale/runtime_events_per_s floor is gated on this in ci.sh).
        # Tracing is record-only: hooks never touch clock/ledger state,
        # so traced runs are bit-identical to untraced ones.
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._trace = bool(self.tracer.enabled)
        if self._trace:
            self.tracer._attach(self)
        # group -> (path, direction) -> insertion-ordered set of active
        # (capacity-holding) transfers: the bucket index. Dict-as-set
        # gives O(1) add/remove/contains with deterministic order.
        self._buckets: Dict[str, Dict[Tuple[str, str],
                                      Dict[Transfer, None]]] = {}
        # group -> flow -> active-member count (distinct-flow counter
        # for the discount check, no set rebuilds)
        self._member_flows: Dict[str, Dict[str, int]] = {}
        # group -> discount flag applied at the last rebalance; a flip
        # dirties every bucket of the group
        self._discounted: Dict[str, bool] = {}
        # group -> buckets mutated since the group's queued rebalance
        self._dirty: Dict[str, set] = {}
        # groups with a same-instant rebalance event already queued
        self._rebalance_pending: set = set()
        # path -> group cache (lazily extended if the fabric grows)
        self._group_of: Dict[str, str] = {}

    # -- API ------------------------------------------------------------
    def transfer(self, path: str, amount: float, *, direction: str = OUT,
                 flow: Optional[str] = None, max_rate: float = math.inf,
                 delay: float = 0.0, tenant: Optional[str] = None,
                 on_complete: Optional[Callable[[Transfer], None]] = None,
                 ) -> Transfer:
        """Start moving ``amount`` (path units) over ``path``. The
        path's ``latency`` (plus ``delay``) is served first without
        holding capacity; then the transfer joins the fair-share pool
        (weighted by ``tenant`` under a QoS policy).
        """
        if path not in self.fabric:
            raise FabricError(f"unknown path {path!r} "
                              f"(fabric has {sorted(self.fabric)})")
        p = self.fabric[path]
        if direction == IN and not p.bidirectional:
            raise FabricError(f"path {path} has no {IN} budget")
        t = Transfer(self, path, amount, direction=direction, flow=flow,
                     max_rate=max_rate, tenant=tenant)
        return self._dispatch(t, delay + p.latency, on_complete)

    def compute(self, resource: str, ops: float, *,
                flow: Optional[str] = None, max_rate: float = math.inf,
                delay: float = 0.0, tenant: Optional[str] = None,
                on_complete: Optional[Callable[[Transfer], None]] = None,
                ) -> Compute:
        """Execute ``ops`` operations on a compute resource (an ops/s
        path — fabric.compute_path / dca_path). The resource's
        ``latency`` models dispatch cost (doorbell/DMA descriptor for a
        DCA engine, IPI for the ARM cores); then the work joins the
        per-resource fair-share pool like any flow: concurrent programs
        on one SoC split its roofline by QoS weight, and the
        reservation is conserving in the shared ledger."""
        if resource not in self.fabric:
            raise FabricError(f"unknown compute resource {resource!r} "
                              f"(fabric has {sorted(self.fabric)})")
        p = self.fabric[resource]
        if p.units != OPS_PER_S:
            raise FabricError(
                f"{resource} is a {p.units} path, not a compute resource "
                f"(expected {OPS_PER_S}; see fabric.compute_path)")
        c = Compute(self, resource, ops, flow=flow, max_rate=max_rate,
                    tenant=tenant)
        return self._dispatch(c, delay + p.latency, on_complete)

    def _dispatch(self, t: Transfer, lead: float,
                  on_complete: Optional[Callable[[Transfer], None]]):
        if on_complete is not None:
            t.add_callback(on_complete)
        if lead > 0:
            self.clock.schedule(lead, self._begin, t)
        else:
            self._begin(t)
        return t

    def process(self, gen: Generator, name: str = "proc") -> Process:
        return Process(self, gen, name=name)

    def signal(self) -> Signal:
        return Signal(self.clock)

    def barrier(self, parties: int, *,
                on_release: Optional[Callable[[int], None]] = None,
                name: str = "barrier") -> Barrier:
        return Barrier(self, parties, on_release=on_release, name=name)

    def barrier_pool(self, count: int, parties: int, *,
                     name: str = "barrier",
                     on_release: Optional[Callable[[int, int], None]] = None,
                     ) -> List[Barrier]:
        """``count`` independent cyclic barriers over the same ``parties``
        membership — the rendezvous set of a staggered collective, where
        each slice of the work (a DDP gradient bucket, a pipeline stage)
        closes on its own barrier so slices can be in flight
        concurrently while each still synchronizes all parties. The
        pool's barriers are reused generation after generation like any
        cyclic Barrier; ``on_release(index, generation)`` identifies
        which slice just closed."""
        if count < 1:
            raise ValueError(f"barrier pool {name}: count must be >= 1")
        pool: List[Barrier] = []
        for i in range(count):
            hook = None if on_release is None else \
                (lambda gen, i=i: on_release(i, gen))
            pool.append(Barrier(self, parties, on_release=hook,
                                name=f"{name}{i}"))
        return pool

    def every(self, interval: float, fn: Callable[[], None], *,
              name: str = "periodic",
              start_delay: Optional[float] = None) -> Process:
        """Spawn a process calling ``fn()`` every ``interval`` simulated
        seconds (first call after ``start_delay``, default ``interval``)
        until killed — heartbeats, samplers, watchdogs. Remember to
        ``kill()`` it (or run the clock with a ``stop``/``until``), or
        the event heap never drains."""
        if interval <= 0:
            raise ValueError(f"periodic {name}: interval must be > 0")

        def _loop():
            yield interval if start_delay is None else start_delay
            while True:
                fn()
                yield interval

        return self.process(_loop(), name=name)

    def cancel(self, t: Transfer) -> None:
        """Abort an in-flight transfer: settle its progress, release its
        reservation back to the ledger, rebalance the survivors. The
        transfer ends ``done`` with ``canceled=True`` and whatever
        ``remaining`` it had; completion callbacks still fire (waiters
        must not hang) and can inspect ``canceled``."""
        if t.done:
            return
        group = self._group(t.path)
        key = (t.path, t.direction)
        now = self.clock.now
        members = self._buckets.get(group, {}).get(key)
        if members is not None and t in members:
            dt = now - t._last_update
            if dt > 0 and t.rate > 0:
                t.remaining = max(0.0, t.remaining - t.rate * dt)
            t._last_update = now
            self._release(t)
            self._drop_member(group, key, t)
        t.canceled = True
        t.done = True
        t.finished_at = now
        self.clock.cancel(t._event)
        t._event = None
        if self._trace:
            self.tracer.on_transfer_end(t)
        callbacks, t._callbacks = t._callbacks, []
        for fn in callbacks:
            fn(t)
        self._queue_rebalance(group, key)

    def active_transfers(self, path: Optional[str] = None) -> List[Transfer]:
        """In-flight capacity-holding transfers, straight off the bucket
        index (no scans): all of them, or those on one ``path`` (its OUT
        bucket then its IN bucket)."""
        if path is None:
            return [t for buckets in self._buckets.values()
                    for members in buckets.values() for t in members]
        buckets = self._buckets.get(self._group(path))
        if not buckets:
            return []
        out: List[Transfer] = []
        for key in ((path, OUT), (path, IN)):
            members = buckets.get(key)
            if members:
                out.extend(members)
        return out

    def weight_of(self, tenant: Optional[str]) -> float:
        """A tenant's QoS weight under the runtime's policy (1.0 with no
        policy; the policy's default for unregistered tenants)."""
        if self.qos is None:
            return 1.0
        return float(self.qos.weight(tenant))

    def occupancy(self, path: str, direction: str = OUT,
                  *, by_tenant: bool = False):
        """Fraction of a path direction's raw capacity currently held in
        the ledger by in-flight transfers — live occupancy, the input to
        admission control and ledger-aware staging choices. With
        ``by_tenant``, a dict attributing the fraction per tenant tag
        (untagged transfers land under ``None``)."""
        cap = self.fabric.direction_capacity(path, direction)
        if cap <= 0:
            return {} if by_tenant else 0.0
        held: Dict[Optional[str], float] = {}
        members = self._buckets.get(self._group(path), {}).get(
            (path, direction))
        if members:
            for t in members:
                if t._res > 0:
                    held[t.tenant] = held.get(t.tenant, 0.0) + t._res
        if by_tenant:
            return {k: v / cap for k, v in held.items()}
        return sum(held.values()) / cap

    def rebalance(self, path: Optional[str] = None) -> None:
        """Re-split capacity after an *external* ledger change (e.g. a
        primary functionality released its reservation). Transfer
        completions rebalance automatically; the ledger has no way to
        notify the runtime about non-transfer releases, so a transfer
        stalled behind an external reservation stays at rate 0 until
        this is called for its path (or for all groups, with no
        argument). Recomputes every bucket of the group, in either
        rebalance mode."""
        if path is not None:
            self._rebalance(self._group(path))
        else:
            for group in list(self._buckets):
                self._rebalance(group)

    # -- mechanics ------------------------------------------------------
    def _group(self, path: str) -> str:
        g = self._group_of.get(path)
        if g is None:
            g = self._group_of[path] = self.fabric[path].group
        return g

    def _begin(self, t: Transfer) -> None:
        if t.done:          # canceled during the latency phase
            return
        now = self.clock.now
        t.started_at = now
        t._last_update = now
        group = self._group(t.path)
        key = (t.path, t.direction)
        self._buckets.setdefault(group, {}).setdefault(key, {})[t] = None
        mf = self._member_flows.setdefault(group, {})
        mf[t.flow] = mf.get(t.flow, 0) + 1
        if self._trace:
            self.tracer.on_transfer_start(t)
        self._queue_rebalance(group, key)

    def _complete(self, t: Transfer) -> None:
        if t.done:
            return
        group = self._group(t.path)
        key = (t.path, t.direction)
        t.remaining = 0.0
        t.done = True
        t.finished_at = self.clock.now
        self.clock.cancel(t._event)
        t._event = None
        self._release(t)
        self._drop_member(group, key, t)
        if self._trace:
            self.tracer.on_transfer_end(t)
        callbacks, t._callbacks = t._callbacks, []
        for fn in callbacks:
            fn(t)
        self._queue_rebalance(group, key)

    def _drop_member(self, group: str, key: Tuple[str, str],
                     t: Transfer) -> None:
        """O(1) removal from the bucket index + flow counter. Empty
        buckets are deleted eagerly so bucket iteration order stays
        'creation order among currently-populated buckets'."""
        buckets = self._buckets[group]
        members = buckets[key]
        del members[t]
        if not members:
            del buckets[key]
            if not buckets:
                del self._buckets[group]
        mf = self._member_flows[group]
        c = mf[t.flow] - 1
        if c <= 0:
            del mf[t.flow]
            if not mf:
                del self._member_flows[group]
        else:
            mf[t.flow] = c

    def _queue_rebalance(self, group: str, key: Tuple[str, str]) -> None:
        """Coalesce fair-share recomputation to one event per group per
        simulated instant: a fleet issuing hundreds of same-timestamp
        transfers (or a decode step sharding across a replica pool)
        triggers one rebalance instead of one per mutation. Deferral is
        invisible in simulated time — the event runs at the same
        timestamp, after every same-instant join/leave, before the
        clock advances. The mutated (path, direction) is recorded so
        the incremental mode recomputes only the dirty buckets."""
        self._dirty.setdefault(group, set()).add(key)
        if group in self._rebalance_pending:
            return
        self._rebalance_pending.add(group)
        self.clock.schedule(0.0, self._run_queued_rebalance, group)

    def _run_queued_rebalance(self, group: str) -> None:
        self._rebalance_pending.discard(group)
        dirty = self._dirty.pop(group, None)
        if self.rebalance_mode == "global":
            self._rebalance(group)
        else:
            self._rebalance(group, only=dirty)

    def _release(self, t: Transfer) -> None:
        if t._res > 0:
            kw = {"out": t._res} if t.direction == OUT else {"in_": t._res}
            self.ledger.release(t.path, flow=t.flow, **kw)
            t._res = 0.0

    def _group_discounted(self, group: str) -> bool:
        """The §4.1 discount applies iff more than one distinct flow is
        on the group: active member flows (counted incrementally in
        ``_member_flows``) united with external ledger holders (the
        ledger's O(1) holder index — which also contains the members'
        own reservations, so the union needs no set build). Early-exits
        after at most two comparisons."""
        if self.fabric.concurrency_discount <= 0.0:
            return False
        mf = self._member_flows.get(group)
        lh = self.ledger.group_holders(group)
        if mf:
            if len(mf) > 1:
                return True
            only = next(iter(mf))
            for f in lh:               # holder flows are distinct keys,
                if f != only:          # so this breaks within 2 steps
                    return True
            return False
        return len(lh) > 1

    def _rebalance(self, group: str, only: Optional[set] = None) -> None:
        """Recompute fair shares for the group's buckets — all of them
        (``only=None``: the public ``rebalance()``, the global mode,
        and any rebalance where the discount flag flips) or just the
        dirty ones. Buckets whose inputs did not change recompute to
        exactly the same rates and are skipped member-by-member, so
        processing a clean bucket is a no-op — which is what makes the
        global mode a bit-identical oracle for the incremental mode."""
        buckets = self._buckets.get(group)
        if not buckets:
            return
        discounted = self._group_discounted(group)
        if discounted != self._discounted.get(group):
            only = None                # capacity changed for every bucket
        self._discounted[group] = discounted
        for key in list(buckets):
            if only is not None and key not in only:
                continue
            members = buckets.get(key)
            if members:
                self._rebalance_bucket(key, members, discounted)

    def _rebalance_bucket(self, key: Tuple[str, str],
                          members: Dict[Transfer, None],
                          discounted: bool) -> None:
        """Weighted max-min fair split of one (path, direction) bucket:
        each flow's share is proportional to its tenant's QoS weight,
        and a max_rate-capped flow's surplus is water-filled back to the
        unsaturated flows. All weights 1 (or no policy) reduces to the
        equal split. Members whose recomputed rate is unchanged (to a
        relative epsilon — recomputing a clean bucket can reproduce the
        same shares only up to the ledger's accumulated rounding, and
        an ulp-level "change" must not reschedule events) keep their
        reservation, progress anchor and completion event; changed
        members are settled at the old rate and rescheduled, and their
        reservation deltas are applied to the ledger in one per-flow
        aggregated pass."""
        path, direction = key
        fabric = self.fabric
        clock = self.clock
        now = clock.now
        cap = fabric.direction_capacity(path, direction)
        if discounted:
            cap *= 1.0 - fabric.concurrency_discount
        ts = list(members)
        held = 0.0
        for t in ts:
            held += t._res
        # what the bucket may split: capacity minus everyone else's
        # reservations (external holders + other buckets never share a
        # (path, direction) key, so subtracting our own holdings back
        # out isolates them)
        avail = max(0.0, cap - (self.ledger.reserved(path, direction) - held))
        weights = {id(t): self.weight_of(t.tenant) for t in ts}
        remaining_w = sum(weights.values())
        # ascending max_rate-per-weight: a flow that saturates its cap
        # below its proportional share frees surplus for all flows
        # still unassigned
        new_rate: Dict[int, float] = {}
        for t in sorted(ts, key=lambda t: t.max_rate / weights[id(t)]):
            w = weights[id(t)]
            share = avail * w / remaining_w if remaining_w > 0 else 0.0
            r = max(0.0, min(share, t.max_rate))
            new_rate[id(t)] = r
            avail -= r
            remaining_w -= w
        deltas: Dict[str, float] = {}
        for t in ts:
            r = new_rate[id(t)]
            if abs(r - t.rate) <= _RATE_RTOL * max(1.0, t.rate):
                continue               # rate-stable: keep event + anchor
            dt = now - t._last_update
            if dt > 0 and t.rate > 0:
                t.remaining = max(0.0, t.remaining - t.rate * dt)
            t._last_update = now
            if r != t._res:
                deltas[t.flow] = deltas.get(t.flow, 0.0) + (r - t._res)
                t._res = r
            t.rate = r
            if self._trace:
                self.tracer.on_transfer_rate(t, now, r)
            clock.cancel(t._event)
            if t.remaining <= 1e-12:
                t._event = clock.schedule(0.0, self._complete, t)
            elif r > 0:
                t._event = clock.schedule(t.remaining / r, self._complete, t)
            else:
                t._event = None        # stalled until capacity frees up
        if deltas:
            self.ledger.shift(path, direction, deltas)
