"""Trace-driven open-loop load generation for the serving fleet.

The serve benchmarks so far replay a fixed request list — a *closed*
loop, where the client waits for the system. Real traffic is open-loop:
arrivals keep coming at the trace's rate whether or not the system
keeps up, which is exactly the regime where the paper's multipath
guidance (and the BlueField saturation cliff of arXiv:2105.06619)
matters. This module is that workload:

``TraceSpec``         a named arrival-rate curve: a Poisson base rate
                      modulated by a diurnal sinusoid and a set of
                      ``Burst`` windows (each multiplies the rate while
                      active), plus heavy-tailed (clamped lognormal)
                      prompt- and decode-length distributions.
``ArrivalGenerator``  seeded sampling of the trace into ``Request``s:
                      a nonhomogeneous Poisson process via thinning
                      (candidates at the peak rate, accepted with
                      probability rate(t)/peak), deterministic per
                      (spec, seed) — the same seed always produces the
                      identical request sequence, byte for byte.
``feed()``            the open-loop runtime Process: submits each
                      request at its simulated arrival time, generated
                      lazily as the clock advances, instead of a
                      pre-built list.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.serve.engine import Request


@dataclass(frozen=True)
class Burst:
    """A transient load spike: the trace rate is multiplied by
    ``multiplier`` for ``start <= t < start + duration``."""
    start: float
    duration: float
    multiplier: float

    def __post_init__(self):
        if self.duration <= 0:
            raise ValueError(f"burst duration must be > 0, got {self.duration}")
        if self.multiplier <= 0:
            raise ValueError(f"burst multiplier must be > 0, "
                             f"got {self.multiplier}")

    def active(self, t: float) -> bool:
        return self.start <= t < self.start + self.duration


@dataclass(frozen=True)
class LengthSpec:
    """Heavy-tailed token-count distribution: lognormal with the given
    ``median`` and shape ``sigma``, clamped to [low, high]. Production
    prompt lengths are famously right-skewed — the tail, not the mean,
    is what fills decode slots."""
    median: float
    sigma: float = 0.6
    low: int = 1
    high: int = 512

    def __post_init__(self):
        if self.median <= 0 or self.sigma < 0:
            raise ValueError(f"need median > 0, sigma >= 0; "
                             f"got {self.median}, {self.sigma}")
        if not 1 <= self.low <= self.high:
            raise ValueError(f"need 1 <= low <= high, "
                             f"got [{self.low}, {self.high}]")

    def sample(self, rng: np.random.Generator) -> int:
        n = int(round(rng.lognormal(math.log(self.median), self.sigma)))
        return min(max(n, self.low), self.high)


@dataclass(frozen=True)
class TraceSpec:
    """One tenant's arrival-rate curve over ``duration`` seconds.

    ``rate(t) = base_rate * (1 + diurnal_amplitude *
    sin(2π (t - diurnal_phase) / diurnal_period)) * Π active bursts``,
    floored at 0. ``peak_rate`` is the exact supremum over burst
    combinations (diurnal bounded by its amplitude) — the thinning
    envelope."""
    name: str
    base_rate: float                       # requests/s
    duration: float                        # seconds of trace
    diurnal_amplitude: float = 0.0         # fraction of base_rate
    diurnal_period: float = 86400.0
    diurnal_phase: float = 0.0
    bursts: Tuple[Burst, ...] = ()
    prompt: LengthSpec = field(default_factory=lambda: LengthSpec(24, 0.6, 8, 96))
    decode: LengthSpec = field(default_factory=lambda: LengthSpec(8, 0.5, 2, 32))

    def __post_init__(self):
        if self.base_rate <= 0 or self.duration <= 0:
            raise ValueError("base_rate and duration must be > 0")
        if not 0.0 <= self.diurnal_amplitude <= 1.0:
            raise ValueError(f"diurnal_amplitude must be in [0, 1], "
                             f"got {self.diurnal_amplitude}")
        if self.diurnal_period <= 0:
            raise ValueError("diurnal_period must be > 0")

    def rate(self, t: float) -> float:
        r = self.base_rate * (1.0 + self.diurnal_amplitude * math.sin(
            2.0 * math.pi * (t - self.diurnal_phase) / self.diurnal_period))
        for b in self.bursts:
            if b.active(t):
                r *= b.multiplier
        return max(r, 0.0)

    @property
    def peak_rate(self) -> float:
        """Supremum of ``rate`` over [0, duration): exact over the burst
        piecewise intervals, diurnal bounded by ``1 + amplitude``."""
        edges = {0.0}
        for b in self.bursts:
            edges.add(b.start)
            edges.add(b.start + b.duration)
        worst = 1.0
        for e in sorted(edges):
            if 0.0 <= e < self.duration:
                prod = 1.0
                for b in self.bursts:
                    if b.active(e):
                        prod *= b.multiplier
                worst = max(worst, prod)
        return self.base_rate * (1.0 + self.diurnal_amplitude) * worst

    @property
    def mean_rate(self) -> float:
        """Time-averaged rate (trapezoid over a 1 s grid) — offered-load
        sweeps scale traces by this, not the peak."""
        n = max(int(self.duration), 2)
        ts = [self.duration * i / n for i in range(n + 1)]
        rs = [self.rate(t) for t in ts]
        return sum((rs[i] + rs[i + 1]) / 2 for i in range(n)) / n


def burst_trace(name: str = "burst10x", *, base_rate: float = 2.0,
                duration: float = 120.0, burst_multiplier: float = 10.0,
                burst_start: float = 30.0, burst_duration: float = 45.0,
                diurnal_amplitude: float = 0.25,
                prompt: LengthSpec = None, decode: LengthSpec = None,
                ) -> TraceSpec:
    """The headline trace: a diurnal baseline with one 10x burst window
    — the regime where a static fleet's TTFT attainment collapses and
    an autoscaled one holds."""
    kw = {}
    if prompt is not None:
        kw["prompt"] = prompt
    if decode is not None:
        kw["decode"] = decode
    return TraceSpec(
        name, base_rate, duration,
        diurnal_amplitude=diurnal_amplitude, diurnal_period=duration,
        bursts=(Burst(burst_start, burst_duration, burst_multiplier),),
        **kw)


class ArrivalGenerator:
    """Seeded sampling of a ``TraceSpec`` into ``Request``s.

    Thinning keeps determinism trivially exact: every candidate arrival
    and its accept/reject draw comes from one ``np.random.default_rng``
    stream in a fixed order, so the request sequence is a pure function
    of (spec, seed, vocab, rid_base). ``rid_base`` namespaces request
    ids per tenant — in sim-compute engines the token stream is a hash
    of the rid, so distinct tenants provably produce distinct bytes.
    """

    def __init__(self, spec: TraceSpec, *, seed: int = 0, vocab: int = 32000,
                 rid_base: int = 0, start: float = 0.0):
        self.spec = spec
        self.seed = seed
        self.vocab = vocab
        self.rid_base = rid_base
        self.start = start

    def __iter__(self) -> Iterator[Request]:
        rng = np.random.default_rng(self.seed)
        spec = self.spec
        peak = spec.peak_rate
        t, rid = 0.0, self.rid_base
        while True:
            t += rng.exponential(1.0 / peak)
            if t >= spec.duration:
                return
            accept = rng.random() * peak <= spec.rate(t)
            # lengths are drawn for every candidate so the stream stays
            # aligned however the rate curve thins it
            plen = spec.prompt.sample(rng)
            dlen = spec.decode.sample(rng)
            prompt = rng.integers(1, self.vocab, size=plen).astype(np.int32)
            if not accept:
                continue
            yield Request(rid=rid, prompt=prompt, max_new_tokens=dlen,
                          arrival=self.start + t)
            rid += 1

    def requests(self) -> List[Request]:
        """The trace materialized up front (closed-loop replay and
        determinism tests)."""
        return list(self)

    def feed(self, engine):
        """The open-loop feeder: a runtime Process that generates each
        request lazily and submits it at its simulated arrival time.
        Returns the Process (done when the trace is exhausted)."""
        def _feeder():
            for req in self:
                now = engine.clock.now
                if req.arrival > now:
                    yield req.arrival - now
                engine.submit(req)
        return engine.runtime.process(
            _feeder(), name=f"arrivals:{self.spec.name}")
