"""Elastic re-meshing: choose the best (pod, data, model) mesh for the
surviving device count, as ``repro/ft/elastic.py::best_mesh_for``.

Policy: keep the model axis (TP degree) fixed if possible — TP is
constrained by head/expert divisibility — and shrink data (FSDP) first;
drop to fewer pods only when a whole pod died. Building the mesh and
resharding state onto it (``make_mesh``, ``reshard``) are multi-device
work and not ported yet.
"""
from __future__ import annotations

from typing import Tuple


def best_mesh_for(devices: int, *, model: int = 16,
                  prefer_pods: int = 2) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest mesh shape <= devices with the given TP degree.
    Returns (shape, axis_names)."""
    while model > 1 and devices % model:
        model //= 2
    rest = devices // model
    for pods in range(min(prefer_pods, rest), 0, -1):
        if rest % pods == 0:
            data = rest // pods
            if pods > 1:
                return (pods, data, model), ("pod", "data", "model")
            return (data, model), ("data", "model")
    return (rest, model), ("data", "model")
