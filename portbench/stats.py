"""Statistics of a run's record, frozen here for the metric readers.

Percentiles are over every sample, by linear interpolation between the
two nearest ranks (numpy's default rule); a rate is work over the
window's whole length.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    xs = sorted(values)
    if not xs:
        return None
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def in_window(run: Dict, t: float) -> bool:
    return run["t0"] <= t <= run["t1"]


def token_times(run: Dict) -> List[float]:
    return [t for r in run["reqs"].values() for t in r["times"] if in_window(run, t)]


def ttfts(run: Dict) -> List[float]:
    """Send to first token, of every request whose first token falls in
    the window."""
    return [r["times"][0] - r["sent"] for r in run["reqs"].values()
            if r["times"] and in_window(run, r["times"][0])]


def itls(run: Dict) -> List[float]:
    """Every gap between consecutive tokens of a request that ends in the
    window."""
    return [b - a for r in run["reqs"].values() for a, b in zip(r["times"], r["times"][1:])
            if in_window(run, b)]


def window_s(run: Dict) -> float:
    return run["t1"] - run["t0"]
