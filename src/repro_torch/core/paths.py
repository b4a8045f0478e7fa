"""The paper's path model (§2.3/§3, Figure 1) for a mesh of cards, the
copy of ``repro/core/paths.py`` (its statements unchanged, held to its
AST by ``tests/test_torch_fabric.py``).

A mesh exposes several *paths*, each with its own bandwidth, latency,
directionality and sharing group:

  ici:<axis>   — a mesh axis inside a node (NVLink 4 through the NVSwitch
                 on the H100: ``core/hw.py``'s ``ICI_*`` figures)
  dcn:pod      — the network between pods (ConnectX-7 on a DGX H100:
                 slow, shared, interferes with everything crossing it)
  pcie:host    — host<->device staging (checkpoint/offload)

`enumerate_paths(mesh)` builds the **Fabric** (core/fabric.py) that the
roofline and charz layers consume. Bandwidths are per card, per
direction; `bidirectional=True` means opposite-direction flows
multiplex.

``PathSpec`` survives as a compatibility constructor with the historical
positional signature; it returns a fabric ``Path``.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core import hw
from repro_torch.core.fabric import BYTES_PER_S, Fabric, Path


def PathSpec(name: str, kind: str = "generic", axis: Optional[str] = None,
             size: int = 2, bw: float = 1.0, latency: float = 0.0,
             bidirectional: bool = True,
             shared_group: Optional[str] = None) -> Path:
    """Deprecated constructor kept for the pre-Fabric call sites
    (positional order: name, kind, axis, size, bw, latency,
    bidirectional, shared_group). Returns a ``fabric.Path``."""
    return Path(name=name, capacity=bw, units=BYTES_PER_S, latency=latency,
                bidirectional=bidirectional, shared_group=shared_group,
                kind=kind, axis=axis, size=size)


def enumerate_paths(mesh_shape: Dict[str, int]) -> Fabric:
    """mesh_shape: {"pod": 2, "data": 16, "model": 16} (or without pod).
    Returns the TPU Fabric (a Mapping[str, Path], so existing dict-style
    consumers keep working)."""
    fabric = Fabric()
    for axis, size in mesh_shape.items():
        if size <= 1:
            continue
        if axis == "pod":
            fabric.add(Path("dcn:pod", hw.DCN_BW_PER_CHIP,
                            latency=hw.DCN_LAT, kind="dcn", axis="pod",
                            size=size, shared_group="dcn"))
        else:
            fabric.add(Path(f"ici:{axis}",
                            hw.ICI_BW_PER_LINK * hw.ICI_LINKS_PER_AXIS,
                            latency=hw.ICI_LAT, kind="ici", axis=axis,
                            size=size, shared_group="ici"))
    fabric.add(Path("pcie:host", hw.PCIE_BW, latency=hw.PCIE_LAT,
                    kind="pcie", size=1, shared_group="pcie"))
    return fabric


# ----------------------------------------------------------------------
# per-collective traffic model (bytes crossing the path per chip)
# ----------------------------------------------------------------------

def collective_bytes_per_chip(op: str, payload_bytes: float, n: int) -> float:
    """Ring-algorithm traffic for one chip, payload = full (unsharded)
    logical tensor size for all-reduce, the *output* size for all-gather
    and the *input* size for reduce-scatter."""
    if n <= 1:
        return 0.0
    frac = (n - 1) / n
    if op == "all-reduce":
        return 2.0 * payload_bytes * frac
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return payload_bytes * frac
    if op == "collective-permute":
        return payload_bytes
    raise ValueError(op)


def collective_time(op: str, payload_bytes: float, path: Path) -> float:
    b = collective_bytes_per_chip(op, payload_bytes, path.size)
    steps = {"all-reduce": 2 * (path.size - 1),
             "all-gather": path.size - 1,
             "reduce-scatter": path.size - 1,
             "all-to-all": path.size - 1,
             "collective-permute": 1}[op]
    return steps * path.latency + b / path.capacity
