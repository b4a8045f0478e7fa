"""Counters, gauges, histograms, and ledger-sampled occupancy series.

The numeric half of the observability subsystem: where ``obs.trace``
attributes *intervals*, this module aggregates *values*. Two bespoke
telemetry paths are re-implemented on top of it with their public APIs
preserved: ``offload.program.OffloadStats`` (counters) and
``tenancy.colocation._OccupancySampler`` (the per-(path, direction,
tenant) occupancy sampler behind ``InterferenceReport``).

``OccupancyTimeSeries`` samples the runtime's active transfers every
``every`` simulated seconds and charges each one's *currently reserved
rate* × the tick to its ``(path, direction, tenant)`` — the ledger's
view of who holds capacity, the same attribution the paper builds by
instrumenting each communication path. ``averages()`` normalizes by
raw capacity × elapsed into busy fractions; with ``keep_series`` the
per-tick points are retained as a time series.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.core.fabric import OUT


class Counter:
    """A monotonically-growing value. Starts at int 0 so integer
    increments stay integers (callers print these raw)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0

    def inc(self, amount: float = 1) -> None:
        self.value += amount

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """A point-in-time value (last write wins)."""
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Observed samples with summary stats and percentiles (exact —
    samples are kept; simulation runs are small enough)."""
    __slots__ = ("name", "samples")

    def __init__(self, name: str):
        self.name = name
        self.samples: List[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def total(self) -> float:
        return math.fsum(self.samples)

    @property
    def mean(self) -> float:
        return self.total / len(self.samples) if self.samples else 0.0

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile, ``p`` in [0, 100]."""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[idx]

    def __repr__(self) -> str:
        return (f"Histogram({self.name}, n={self.count}, "
                f"mean={self.mean:.4g})")


class MetricsRegistry:
    """Get-or-create home for named metrics. Each consumer owns its own
    registry (no global state), so tests and tenants stay isolated."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(name)
        return h

    def counter_values(self) -> Dict[str, float]:
        return {name: c.value for name, c in self._counters.items()}

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": self.counter_values(),
            "gauges": {name: g.value for name, g in self._gauges.items()},
            "histograms": {name: {"count": h.count, "mean": h.mean,
                                  "p50": h.percentile(50),
                                  "p99": h.percentile(99)}
                           for name, h in self._histograms.items()},
        }


class OccupancyTimeSeries:
    """Ledger-sampled per-(path, direction, tenant) occupancy.

    Every ``every`` simulated seconds, each active capacity-holding
    transfer is charged ``reserved_rate * every`` units against its
    (path, direction, tenant) — i.e. the sampler integrates the
    ledger's reservations, not wall activity, which is exactly what
    admission control and the paper's path attribution care about.
    Untagged transfers land under ``"untagged"``.

    ``busy`` exposes the legacy OUT-direction shape
    (``{path: {tenant: units}}``) that ``_OccupancySampler`` always
    had; ``finish()`` kills the sampling process and returns the OUT
    busy *fractions* (units / (capacity × elapsed)). ``averages()``
    gives the same for any direction, and with ``keep_series`` each
    tick's per-key reserved rates are retained in ``series``.
    """

    def __init__(self, runtime, every: float = 0.01, *,
                 directions: Tuple[str, ...] = (OUT,),
                 keep_series: bool = False):
        self.runtime = runtime
        self.every = every
        self.directions = directions
        self._busy: Dict[str, Dict[str, Dict[str, float]]] = {
            d: {} for d in directions}
        #: per-tick samples: (t, {(path, direction, tenant): rate})
        self.series: List[Tuple[float, Dict[Tuple[str, str, str],
                                            float]]] = []
        self._keep_series = keep_series
        self._t0 = runtime.clock.now
        self._proc = runtime.every(every, self._sample, start_delay=every,
                                   name="occupancy-sampler")

    @property
    def busy(self) -> Dict[str, Dict[str, float]]:
        return self._busy.get(OUT, {})

    def _sample(self) -> None:
        point: Optional[Dict[Tuple[str, str, str], float]] = (
            {} if self._keep_series else None)
        for t in self.runtime.active_transfers():
            if t.direction not in self._busy or t._res <= 0:
                continue
            tag = t.tenant or "untagged"
            per_path = self._busy[t.direction].setdefault(t.path, {})
            per_path[tag] = per_path.get(tag, 0.0) + t._res * self.every
            if point is not None:
                k = (t.path, t.direction, tag)
                point[k] = point.get(k, 0.0) + t._res
        if point is not None:
            self.series.append((self.runtime.clock.now, point))

    def averages(self, direction: str = OUT) -> Dict[str, Dict[str, float]]:
        elapsed = self.runtime.clock.now - self._t0
        if elapsed <= 0:
            return {}
        out: Dict[str, Dict[str, float]] = {}
        for path, per_tenant in self._busy.get(direction, {}).items():
            cap = self.runtime.fabric.direction_capacity(path, direction)
            if cap <= 0:
                continue
            out[path] = {tenant: units / (cap * elapsed)
                         for tenant, units in per_tenant.items()}
        return out

    def finish(self) -> Dict[str, Dict[str, float]]:
        self._proc.kill()
        return self.averages(OUT)
