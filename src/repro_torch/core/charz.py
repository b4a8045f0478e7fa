"""Characterizer: per-path communication traffic from a step's
collectives, the copy of ``repro/core/charz.py`` (its statements
unchanged, held to its AST by ``tests/test_torch_fabric.py``).

The JAX dry-run parses the compiled HLO text's collective ops; the
port's dry-run (``launch/dryrun.py``) records each ``c10d`` collective
of a traced step and builds the same ``TrafficSummary`` with
``attribute_axes`` and ``core/paths.py``'s ring-traffic model. Each
collective is attributed to the mesh axis it runs over (ICI vs DCN).
Uses only ``re``, ``dataclasses`` and numpy.
"""
from __future__ import annotations

import re
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DTYPE_BYTES = {
    "f64": 8, "f32": 4, "f16": 2, "bf16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
    "c64": 8, "c128": 16,
}

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_GROUPS_EXPLICIT_RE = re.compile(r"replica_groups=\{\{([^}]*(?:\},\{[^}]*)*)\}\}")
_GROUPS_IOTA_RE = re.compile(
    r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?")
_SRC_TGT_RE = re.compile(r"source_target_pairs=\{((?:\{\d+,\d+\},?)+)\}")


@dataclass
class CollectiveOp:
    op: str                      # canonical op kind
    result_bytes: int            # size of the result (sum over tuple parts)
    group_size: int              # participants
    axes: Tuple[str, ...]        # mesh axes attributed
    traffic_per_chip: float      # ring-model bytes crossing the path per chip
    line: str = ""


def _parse_shapes(prefix: str) -> int:
    """Sum byte sizes of all typed arrays in an HLO result type string."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(prefix):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def _iota_groups(g: int, s: int, dims: Sequence[int],
                 perm: Optional[Sequence[int]]) -> List[List[int]]:
    import numpy as np
    arr = np.arange(int(np.prod(dims))).reshape(dims)
    if perm:
        arr = arr.transpose(perm)
    return arr.reshape(g, s).tolist()


def _parse_groups(line: str) -> Optional[List[List[int]]]:
    m = _GROUPS_IOTA_RE.search(line)
    if m:
        g, s = int(m.group(1)), int(m.group(2))
        dims = [int(x) for x in m.group(3).split(",")]
        perm = [int(x) for x in m.group(4).split(",")] if m.group(4) else None
        return _iota_groups(g, s, dims, perm)
    m = _GROUPS_EXPLICIT_RE.search(line)
    if m:
        return [[int(x) for x in grp.split(",") if x]
                for grp in m.group(1).split("},{")]
    m = _SRC_TGT_RE.search(line)
    if m:  # collective-permute: each pair is a 2-group for attribution
        pairs = re.findall(r"\{(\d+),(\d+)\}", m.group(0))
        return [[int(a), int(b)] for a, b in pairs]
    return None


def _axis_strides(mesh_axes: Sequence[Tuple[str, int]]) -> Dict[str, Tuple[int, int]]:
    """row-major device numbering: axis -> (stride, size)."""
    strides = {}
    stride = 1
    for name, size in reversed(mesh_axes):
        strides[name] = (stride, size)
        stride *= size
    return strides


def attribute_axes(group: List[int],
                   mesh_axes: Sequence[Tuple[str, int]]) -> Tuple[str, ...]:
    """Which mesh axes does a replica group span? Detects single axes and
    contiguous axis combinations (uniform-stride groups)."""
    if len(group) <= 1:
        return ()
    g = sorted(group)
    strides = _axis_strides(mesh_axes)
    diffs = {g[i + 1] - g[i] for i in range(len(g) - 1)}
    # exact single-axis match
    for name, (stride, size) in strides.items():
        if diffs == {stride} and len(g) == size:
            return (name,)
    # contiguous multi-axis run (e.g. ("pod","data") fused groups)
    names = [n for n, _ in mesh_axes]
    for i in range(len(names)):
        for j in range(i + 1, len(names) + 1):
            run = names[i:j]
            size = 1
            for n in run:
                size *= strides[n][1]
            inner_stride = strides[run[-1]][0]
            if len(g) == size and diffs and min(diffs) == inner_stride:
                return tuple(run)
    # fallback: attribute by smallest stride observed
    best = None
    for name, (stride, size) in strides.items():
        if any(d % stride == 0 and d // stride < size for d in diffs):
            if best is None or stride < strides[best][0]:
                best = name
    return (best,) if best else tuple(names)


def parse_collectives(hlo_text: str,
                      mesh_axes: Sequence[Tuple[str, int]]) -> List[CollectiveOp]:
    ops: List[CollectiveOp] = []
    for line in hlo_text.splitlines():
        stripped = line.strip()
        m = re.search(r"=\s*((?:\([^)]*\)|\S+))\s+([\w-]+)\(", stripped)
        if not m:
            continue
        opname = m.group(2)
        base = opname.removesuffix("-start")
        if base not in _COLLECTIVES or opname.endswith("-done"):
            continue
        groups = _parse_groups(stripped)
        if groups is None:
            continue
        result_bytes = _parse_shapes(m.group(1))
        n = max(len(g) for g in groups)
        axes = attribute_axes(groups[0] if groups else [], mesh_axes)
        frac = (n - 1) / n if n > 1 else 0.0
        if base == "all-reduce":
            traffic = 2.0 * result_bytes * frac
        elif base == "all-gather":
            traffic = result_bytes * frac            # result is full
        elif base == "reduce-scatter":
            traffic = result_bytes * (n - 1)         # result is 1/n of input
        elif base in ("all-to-all", "ragged-all-to-all"):
            traffic = result_bytes * frac
        else:  # collective-permute
            traffic = result_bytes
            n = 2
        ops.append(CollectiveOp(op=base, result_bytes=result_bytes,
                                group_size=n, axes=axes,
                                traffic_per_chip=traffic, line=stripped[:200]))
    return ops


@dataclass
class TrafficSummary:
    per_path: Dict[str, float]            # path name -> bytes/chip
    per_op: Dict[str, float]              # op kind -> bytes/chip
    op_counts: Dict[str, int]
    ops: List[CollectiveOp] = field(default_factory=list)

    @property
    def total(self) -> float:
        return sum(self.per_path.values())


def summarize_traffic(hlo_text: str,
                      mesh_axes: Sequence[Tuple[str, int]],
                      fabric=None) -> TrafficSummary:
    """Attribute every collective's traffic to its (slowest) path.

    Attribution targets are the path names of `fabric` (a
    ``core.fabric.Fabric``); when omitted, the TPU fabric for
    `mesh_axes` is enumerated (so the names are "dcn:pod"/"ici:<axis>").
    """
    if fabric is None:
        from repro_torch.core.paths import enumerate_paths
        fabric = enumerate_paths(dict(mesh_axes))
    by_axis = {p.axis: p.name for p in fabric.values() if p.axis}
    ops = parse_collectives(hlo_text, mesh_axes)
    per_path: Dict[str, float] = defaultdict(float)
    per_op: Dict[str, float] = defaultdict(float)
    counts: Dict[str, int] = defaultdict(int)
    for op in ops:
        # slowest constituent: dcn (pod) dominates ici
        if "pod" in op.axes:
            path = by_axis.get("pod", "dcn:pod")
        elif op.axes:
            axis = op.axes[-1]            # innermost listed axis
            path = by_axis.get(axis, f"ici:{axis}")
        else:
            path = "ici:?"
        per_path[path] += op.traffic_per_chip
        per_op[op.op] += op.traffic_per_chip
        counts[op.op] += 1
    return TrafficSummary(per_path=dict(per_path), per_op=dict(per_op),
                          op_counts=dict(counts), ops=ops)


def replay(summary: TrafficSummary, fabric, clock=None) -> float:
    """Execute a TrafficSummary on the event-driven fabric runtime:
    every path's per-chip bytes become one concurrent transfer, and the
    simulated step time is when the last of them drains.

    Unlike the static per-path division (`bytes / bw` summed per path in
    the roofline), overlap and the §4.1 concurrency discount are
    *emergent*: paths in one ``shared_group`` (e.g. all ICI axes)
    interfere, independent groups (ICI vs DCN vs PCIe) overlap freely.
    Path names not present in `fabric` (e.g. the "ici:?" attribution
    fallback) are skipped. Returns simulated seconds; 0.0 for an empty
    summary. Pass a shared ``clock`` to embed the replay in a larger
    timeline (the elapsed time is still returned)."""
    from repro_torch.core.runtime import FabricRuntime
    rt = FabricRuntime(fabric, clock=clock)
    t0 = rt.clock.now
    transfers = [rt.transfer(name, summary.per_path[name],
                             flow=f"replay:{name}")
                 for name in sorted(summary.per_path)
                 if summary.per_path[name] > 0 and name in fabric]
    if not transfers:
        return 0.0
    # stop at our own completion: a shared clock's later events stay put
    rt.clock.run(stop=lambda: all(t.done for t in transfers))
    return rt.clock.now - t0
