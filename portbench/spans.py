"""The program's own spans (``repro_torch.obs.trace.HostTracer``: the
serve engine's ``serve.*`` and the train step's ``train.*`` phases), as
the metric readers take them from a run's record.

Two sources. ``run["host_spans"]``: every span the program recorded, as
``Span.to_dict()`` gives it, on ``time.perf_counter``'s clock (the
window's ``t0``/``t1``). ``run["trace"]["spans"]``: ``reduce_spans`` of
the profiler's trace, where each phase is a ``user_annotation`` on the
clock of the kernels and launch calls. A record without them (a program
or a harness that records no span) reads None.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from portbench import stats
from portbench.trace import DEVICE_KINDS, LAUNCH_KINDS, _union

PREFIXES = ("serve.", "train.")
NO_SPAN = "(no program span)"


def _launch(cat: str, name: str) -> bool:
    return cat in LAUNCH_KINDS and name.startswith(("cudaLaunch", "cuLaunch"))


def reduce_spans(events: List[Dict], prefixes=PREFIXES) -> Dict[str, Dict]:
    """For each ``user_annotation`` name that starts with one of
    ``prefixes``: its ``count``, ``host_s`` (summed durations),
    ``device_s`` (device operations launched inside one of its intervals,
    matched by correlation), ``idle_s`` (the traced window's device idle
    time whose middle falls inside it as the innermost such span) and
    ``launches`` (``cudaLaunch*``/``cuLaunch*`` calls inside). Attribution
    goes by host time, on whatever thread: autograd's device thread
    launches a backward inside the main thread's span. Idle time outside
    every such span is ``NO_SPAN``'s."""
    host: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
    launch: Dict[int, float] = {}
    launches: List[float] = []
    dev: List[Tuple[float, float, Optional[int]]] = []
    window = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat == "user_annotation":
            if name.startswith(prefixes):
                host[name].append((a, b))
            elif name == "pb.trace":
                window = (a, b)
        elif cat in LAUNCH_KINDS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = a
            if _launch(cat, name):
                launches.append(a)
        elif cat in DEVICE_KINDS:
            dev.append((a, b, e.get("args", {}).get("correlation")))
    spans = {name: sorted(iv) for name, iv in host.items()}
    starts = {name: [a for a, _ in iv] for name, iv in spans.items()}

    def inside(rname: str, t: float) -> Optional[Tuple[float, float]]:
        i = bisect.bisect_right(starts[rname], t) - 1
        return spans[rname][i] if i >= 0 and t <= spans[rname][i][1] else None

    out = {name: {"count": len(iv), "host_s": sum(b - a for a, b in iv) / 1e6,
                  "device_s": 0.0, "idle_s": 0.0, "launches": 0}
           for name, iv in spans.items()}
    for t in launches:
        for rname in spans:
            if inside(rname, t):
                out[rname]["launches"] += 1
    for a, b, corr in dev:
        t = launch.get(corr)
        if t is None:
            continue
        for rname in spans:
            if inside(rname, t):
                out[rname]["device_s"] += (b - a) / 1e6
    if window is None:
        return out
    w0, w1 = window
    busy = _union([(max(a, w0), min(b, w1)) for a, b, _ in dev if b > w0 and a < w1])
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    out[NO_SPAN] = {"idle_s": 0.0}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        best, width = NO_SPAN, None
        for rname in spans:
            iv = inside(rname, (a + b) / 2)
            if iv and (width is None or iv[1] - iv[0] < width):
                best, width = rname, iv[1] - iv[0]
        out[best]["idle_s"] += (b - a) / 1e6
    return out


def host_spans(run: Dict, name: str) -> Optional[List[Dict]]:
    """The spans called ``name`` that end in the window; None where the
    run recorded no span."""
    spans = run.get("host_spans")
    if spans is None:
        return None
    return [s for s in spans if s["name"] == name and stats.in_window(run, s["t_end"])]


def mean_ms(run: Dict, name: str) -> Optional[float]:
    xs = host_spans(run, name)
    return 1e3 * sum(s["t_end"] - s["t_start"] for s in xs) / len(xs) if xs else None


def per_step_ms(run: Dict, name: str) -> Optional[float]:
    """The host milliseconds of the ``name`` spans inside each
    ``train.step`` that lies whole in the window, over those steps."""
    steps = host_spans(run, "train.step")
    if not steps:
        return None
    steps = [s for s in steps if stats.in_window(run, s["t_start"])]
    inner = [s for s in run["host_spans"] if s["name"] == name]
    total = sum(s["t_end"] - s["t_start"] for s in inner
                if any(st["t_start"] <= s["t_start"] and s["t_end"] <= st["t_end"]
                       for st in steps))
    return 1e3 * total / len(steps) if steps else None


def traced(run: Dict, name: str, key: str) -> Optional[float]:
    """``key`` of span ``name`` in the traced window, over its count;
    None where the trace holds no such span or nothing of ``key``."""
    got = (run.get("trace") or {}).get("spans", {}).get(name)
    if not got or not got["count"] or not got[key]:
        return None
    return got[key] / got["count"]
