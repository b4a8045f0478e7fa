"""Chrome-trace / Perfetto export and text summaries for a Tracer.

``chrome_trace`` renders a ``Tracer``'s spans into the Trace Event
JSON format (the ``{"traceEvents": [...]}`` flavor) that
``chrome://tracing`` and https://ui.perfetto.dev load directly:

- one *process* (pid) per tenant, named ``tenant:<name>`` (tenant-less
  runtime activity — barriers, processes — lands on pid 0,
  ``runtime``);
- within a tenant, one *thread* (tid) per ``path:direction`` track,
  plus a ``phases`` track for consumer-level spans and (on the runtime
  pid) ``barriers`` / ``processes`` tracks;
- every transfer/compute span is a complete (``ph: "X"``) event, and
  each rebalance that changed its rate is an instant (``ph: "i"``)
  annotation inside the span's track carrying the new rate — load the
  trace and the §4.1 discount is *visible* as simultaneous rate steps
  across co-resident flows.

Simulated seconds map to trace microseconds 1:1 (ts = t * 1e6), so a
1.5 s simulation reads as 1.5 s in the viewer.

``summary`` is the text counterpart: per (tenant, path:direction) busy
time, busy fraction, and span counts — the paper-style attribution
table. ``validate_chrome_trace`` is the schema check used by the test
suite and CI on exported files.
"""
from __future__ import annotations

import json
import numbers
from typing import Any, Dict, List, Optional, Tuple

from repro_torch.obs.trace import BARRIER, COMPUTE, PHASE, PROCESS, TRANSFER

_US = 1e6                      # simulated seconds -> trace microseconds
_RUNTIME_PID = 0


def _pid_map(tracer) -> Dict[Optional[str], int]:
    tenants = sorted({s.tenant for s in tracer.spans if s.tenant is not None}
                     | {s.tenant for s in tracer.open_spans()
                        if s.tenant is not None})
    return {tenant: i + 1 for i, tenant in enumerate(tenants)}


def chrome_trace(tracer, *, include_open: bool = True) -> Dict[str, Any]:
    """Render the tracer's spans as a Trace Event JSON document."""
    spans = list(tracer.spans)
    now = tracer.now() if tracer.enabled else 0.0
    if include_open and tracer.enabled:
        spans.extend(tracer.open_spans())
    pids = _pid_map(tracer)
    events: List[Dict[str, Any]] = []
    named_threads: set = set()

    def meta_event(pid: int, name: str, tid: Optional[int] = None,
                   label: str = "") -> None:
        ev: Dict[str, Any] = {"ph": "M", "name": name, "pid": pid,
                              "args": {"name": label}}
        if tid is not None:
            ev["tid"] = tid
        events.append(ev)

    meta_event(_RUNTIME_PID, "process_name", label="runtime")
    for tenant, pid in pids.items():
        meta_event(pid, "process_name", label=f"tenant:{tenant}")

    # stable tids: per pid, tracks are numbered in first-use order
    tids: Dict[Tuple[int, str], int] = {}

    def tid_for(pid: int, track: str) -> int:
        key = (pid, track)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = sum(1 for k in tids if k[0] == pid) + 1
            if (pid, tid) not in named_threads:
                named_threads.add((pid, tid))
                meta_event(pid, "thread_name", tid=tid, label=track)
        return tid

    for span in spans:
        pid = pids.get(span.tenant, _RUNTIME_PID)
        if span.kind in (TRANSFER, COMPUTE):
            track = f"{span.path}:{span.direction}"
        elif span.kind == BARRIER:
            track = "barriers"
        elif span.kind == PROCESS:
            track = "processes"
        else:
            track = "phases"
        tid = tid_for(pid, track)
        t_end = span.t_end if span.t_end is not None else now
        args: Dict[str, Any] = dict(span.meta)
        if span.flow is not None:
            args["flow"] = span.flow
        if span.t_end is None:
            args["open"] = True
        if span.kind == BARRIER:
            events.append({"ph": "i", "s": "t", "name": span.name,
                           "cat": span.kind, "pid": pid, "tid": tid,
                           "ts": span.t_start * _US, "args": args})
            continue
        events.append({"ph": "X", "name": span.name, "cat": span.kind,
                       "pid": pid, "tid": tid, "ts": span.t_start * _US,
                       "dur": max(t_end - span.t_start, 0.0) * _US,
                       "args": args})
        # rate-change annotations: skip the implicit opening 0 and the
        # closing 0 — only genuine rebalances of a live span
        for t, rate in span.rate_timeline[1:]:
            if t >= t_end and rate == 0.0:
                continue
            events.append({"ph": "i", "s": "t", "name": "rate",
                           "cat": "rebalance", "pid": pid, "tid": tid,
                           "ts": t * _US,
                           "args": {"flow": span.flow, "rate": rate}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump(tracer, path: str, *, include_open: bool = True) -> str:
    """Write the Chrome-trace JSON to ``path`` and return it."""
    doc = chrome_trace(tracer, include_open=include_open)
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def validate_chrome_trace(doc: Any) -> List[str]:
    """Schema-check a Trace Event document; returns problems (empty ==
    valid). Covers what chrome://tracing actually requires: the
    traceEvents list, known phase codes, numeric timestamps, and
    non-negative durations on complete events."""
    problems: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return [f"top level must be a dict with 'traceEvents', got "
                f"{type(doc).__name__}"]
    evs = doc["traceEvents"]
    if not isinstance(evs, list):
        return [f"traceEvents must be a list, got {type(evs).__name__}"]
    for i, ev in enumerate(evs):
        if not isinstance(ev, dict):
            problems.append(f"event {i} is not a dict")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "B", "E", "i", "I", "C", "M"):
            problems.append(f"event {i} has unknown ph {ph!r}")
            continue
        if "name" not in ev or not isinstance(ev["name"], str):
            problems.append(f"event {i} ({ph}) missing string name")
        if "pid" not in ev:
            problems.append(f"event {i} ({ph}) missing pid")
        if ph == "M":
            continue
        if not isinstance(ev.get("ts"), numbers.Real):
            problems.append(f"event {i} ({ph}) missing numeric ts")
        if "tid" not in ev:
            problems.append(f"event {i} ({ph}) missing tid")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, numbers.Real) or dur < 0:
                problems.append(f"event {i} (X) needs dur >= 0, got {dur!r}")
    return problems


def summary(tracer, *, fabric=None, elapsed: Optional[float] = None) -> str:
    """Text attribution table: busy seconds + busy fraction per
    (tenant, path:direction), plus span counts by kind."""
    fabric = fabric if fabric is not None else tracer.fabric
    if elapsed is None:
        elapsed = tracer.now()
    busy = tracer.busy_units()
    lines = [f"{'tenant':<12} {'track':<22} {'busy_s':>10} {'frac':>7}"]
    for (tenant, path, direction), units in sorted(
            busy.items(), key=lambda kv: (str(kv[0][0]), kv[0][1], kv[0][2])):
        cap = (fabric.direction_capacity(path, direction)
               if fabric is not None and path in fabric else 0.0)
        busy_s = units / cap if cap > 0 else 0.0
        frac = busy_s / elapsed if elapsed > 0 else 0.0
        lines.append(f"{str(tenant or '-'):<12} {path + ':' + direction:<22}"
                     f" {busy_s:>10.4f} {frac:>6.1%}")
    counts: Dict[str, int] = {}
    for s in tracer.spans:
        counts[s.kind] = counts.get(s.kind, 0) + 1
    lines.append("spans: " + ", ".join(
        f"{k}={counts.get(k, 0)}"
        for k in (TRANSFER, COMPUTE, BARRIER, PROCESS, PHASE)))
    return "\n".join(lines)
