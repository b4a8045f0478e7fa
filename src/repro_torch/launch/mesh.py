"""Meshes of SPMD ranks, the counterpart of ``repro/launch/mesh.py``.

Importing this module touches no process group: meshes are built by
functions, from the world that ``torch.distributed`` has initialised
(``parallel/ranks.py``), each rank one mesh position.
"""
from __future__ import annotations

from repro_torch.parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """The 16x16 (data, model) mesh, or 2x16x16 (pod, data, model)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_test_mesh(shape=(2, 2, 2), axes=("pod", "data", "model"), device=None) -> Mesh:
    """A small mesh for tests (as many gloo ranks as it has positions)."""
    return Mesh(shape, axes, device=device)
