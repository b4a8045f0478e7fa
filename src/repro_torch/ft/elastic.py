"""Elastic re-meshing: choose the best (pod, data, model) mesh for the
surviving device count and reshard state onto it, the counterpart of
``repro/ft/elastic.py``.

Policy: keep the model axis (TP degree) fixed if possible — TP is
constrained by head/expert divisibility — and shrink data (FSDP) first;
drop to fewer pods only when a whole pod died. Resharding gathers each
leaf whole over its old mesh and cuts it again on the new one
(``DTensor.full_tensor`` and ``distribute_tensor``): the bytes cross
gloo through host memory (``core/collectives.host_staged``), the
reshard traffic a planner budgets.
"""
from __future__ import annotations

from typing import Tuple

from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import (Mesh, distribute, full_tensor, is_logical,
                                           named_sharding, tree_map)


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


def make_mesh(shape: Tuple[int, ...], names: Tuple[str, ...], device=None) -> Mesh:
    """A mesh of the first ``prod(shape)`` ranks of the world, row-major:
    JAX's ``devices[:n]``. Every rank of the world calls it; the ranks
    past the mesh hold no part of it."""
    return Mesh(shape, names, device=device)


def reshard(tree, logical_tree, new_mesh: Mesh):
    """Move a (params/opt) tree onto ``new_mesh`` via its logical axes:
    each leaf (a DTensor on an older mesh, or a whole tensor every rank
    holds) becomes a DTensor of its spec on ``new_mesh``. Every rank of
    the old meshes calls it; a rank outside ``new_mesh`` gets None for
    each leaf (it holds none of the state)."""
    def move(lg, x):
        whole = full_tensor(x) if isinstance(x, DTensor) else x
        return distribute(whole, named_sharding(lg, new_mesh, dim_sizes=whole.shape))
    return tree_map(move, logical_tree, tree, is_leaf=is_logical)
