"""Tracing from the benchmark's side: ``record_function`` ranges around
calls into the program, the shapes of each wrapped kernel call, and the
reduction of ``torch.profiler``'s trace to busy time, idle gaps and
device time per range.

A kernel's device time is that of the device operations launched inside
its range (matched by the launch's correlation id and host time), so a
share reads the same work whatever implements the kernel. The device's
busy time is the union of its operations' intervals inside the traced
window (the ``pb.trace`` range).
"""
from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")


class Calls:
    """The wrapped kernel calls of a traced window: (range, flops, bytes,
    peak) each; ``context`` holds what a count needs beyond the call's
    arguments (a decode step's per-row fills)."""

    def __init__(self):
        self.rows: List[Tuple[str, float, float, float]] = []
        self.context: Dict = {}
        self.on = False


@contextlib.contextmanager
def wrapped(patches: List[Tuple[object, str, str, Optional[Callable]]], calls: Calls):
    """Wrap ``getattr(obj, attr)`` in a ``record_function(range)`` for each
    (obj, attr, range, count) of ``patches``; ``count(*args, **kw)`` gives
    (flops, bytes, peak) of a call, recorded while ``calls.on``."""
    saved = []
    try:
        for obj, attr, name, count in patches:
            orig = getattr(obj, attr)
            saved.append((obj, attr, orig))

            @functools.wraps(orig)
            def fn(*a, _orig=orig, _name=name, _count=count, **kw):
                with torch.profiler.record_function(_name):
                    out = _orig(*a, **kw)
                if _count is not None and calls.on:
                    calls.rows.append((_name,) + tuple(_count(*a, **kw)))
                return out
            setattr(obj, attr, fn)
        yield calls
    finally:
        for obj, attr, orig in reversed(saved):
            setattr(obj, attr, orig)


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(prof, top: int = 10) -> Dict:
    """busy_s, window_s, device seconds per ``pb.`` range, the device
    operations that took most time and idle time by what the host was
    doing (the innermost ``pb.`` range at the gap's middle), from the
    profiler's Chrome trace (written to a temporary file and read back)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, top)


def reduce_events(events: List[Dict], top: int = 10) -> Dict:
    """``reduce`` on the Chrome trace's events (times in microseconds)."""
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    launch: Dict[int, float] = {}
    dev: List[Tuple[float, float, str, Optional[int]]] = []
    kinds: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        kinds[cat] += 1
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat == "user_annotation" and name.startswith("pb."):
            host[name].append((a, b))
        elif cat in LAUNCH_KINDS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = a
        elif cat in DEVICE_KINDS:
            dev.append((a, b, name, e.get("args", {}).get("correlation")))
    if not host.get("pb.trace"):
        raise RuntimeError("the trace holds no pb.trace range")
    w0, w1 = host["pb.trace"][0]
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _, _ in dev if b > w0 and a < w1])
    busy_us = sum(b - a for a, b in busy)

    spans = {name: sorted(iv) for name, iv in host.items() if name != "pb.trace"}
    starts = {name: [a for a, _ in iv] for name, iv in spans.items()}
    range_us: Dict[str, float] = defaultdict(float)
    by_op: Dict[str, float] = defaultdict(float)
    linked = 0
    for a, b, name, corr in dev:
        by_op[name] += b - a
        t = launch.get(corr)
        if t is None:
            continue
        linked += 1
        for rname, iv in spans.items():
            i = bisect.bisect_right(starts[rname], t) - 1
            if i >= 0 and t <= iv[i][1]:
                range_us[rname] += b - a

    def host_at(t: float) -> str:
        best, width = "host (no range)", None
        for rname, iv in spans.items():
            i = bisect.bisect_right(starts[rname], t) - 1
            if i >= 0 and t <= iv[i][1] and (width is None or iv[i][1] - iv[i][0] < width):
                best, width = rname, iv[i][1] - iv[i][0]
        return best

    idle: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            idle[host_at((a + b) / 2)] += b - a
    return {
        "busy_s": busy_us / 1e6, "window_s": (w1 - w0) / 1e6,
        "range_s": {k: v / 1e6 for k, v in range_us.items()},
        "device_ops": [[k[:160], v / 1e6] for k, v in
                       sorted(by_op.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[k, v / 1e6] for k, v in
                      sorted(idle.items(), key=lambda kv: -kv[1])[:top]],
        "counts": {"device_ops": len(dev), "linked": linked, "kinds": dict(kinds)},
    }


def bound_terms(calls: List[Tuple[str, float, float, float]]) -> Dict[str, str]:
    """Which term bounds each range's summed calls: "operations" or "bytes"."""
    from portbench.flops import HBM_BYTES_S
    ops: Dict[str, float] = defaultdict(float)
    mem: Dict[str, float] = defaultdict(float)
    for rng, f, nb, pk in calls:
        ops[rng] += f / pk
        mem[rng] += nb / HBM_BYTES_S
    return {r: "operations" if ops[r] >= mem[r] else "bytes" for r in ops}


def roofline_share(run: Dict, rng: str) -> Optional[float]:
    """Percent of the least time of range ``rng``'s calls (their summed
    bounds) in the device time measured inside the range; None where the
    traced window holds no such call or no device time in the range."""
    tr = run.get("trace")
    if not tr:
        return None
    rows = [r for r in tr["calls"] if r[0] == rng]
    dev_s = tr["range_s"].get(rng, 0.0)
    if not rows or dev_s <= 0:
        return None
    from portbench.flops import bound_s
    least = sum(bound_s(f, nb, pk)[0] for _, f, nb, pk in rows)
    return 100.0 * least / dev_s
