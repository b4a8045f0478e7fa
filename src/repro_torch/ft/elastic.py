"""Elastic re-meshing: choose the best (pod, data, model) mesh for the
surviving device count and reshard state onto it, the counterpart of
``repro/ft/elastic.py``.

Policy: keep the model axis (TP degree) fixed if possible — TP is
constrained by head/expert divisibility — and shrink data (FSDP) first;
drop to fewer pods only when a whole pod died. Resharding gathers each
leaf whole over its old mesh and cuts it again on the new one: the
bytes cross gloo through host memory (``core/collectives.host_staged``),
the reshard traffic a planner budgets. A tree of DTensors or of whole
tensors becomes DTensors (``DTensor.full_tensor`` and
``distribute_tensor``); a train state held in blocks (``old_mesh``:
``parallel/sharding.place``'s plain tensors) becomes the new mesh's
blocks (``gather``, then ``place``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.parallel.sharding import (Mesh, distribute, full_tensor, gather, is_logical,
                                           named_sharding, place, tree_layout, tree_map)


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


def reshard(tree, logical_tree, new_mesh: Mesh, *, old_mesh: Optional[Mesh] = None,
            like=None):
    """Move a (params/opt) tree onto ``new_mesh`` via its logical axes:
    each leaf (a DTensor on an older mesh, or a whole tensor every rank
    holds) becomes a DTensor of its spec on ``new_mesh``. Every rank of
    the old meshes calls it; a rank outside ``new_mesh`` gets None for
    each leaf (it holds none of the state).

    With ``old_mesh``, ``tree`` is this rank's blocks on it and ``like``
    the whole tree's shapes (tensors, ``meta`` ones too): the blocks are
    gathered whole over ``old_mesh`` and each rank of ``new_mesh`` keeps
    its blocks on it, plain tensors (JAX's ``device_put``: gather, then
    cut). Every rank of ``old_mesh`` calls it, and ``new_mesh``'s ranks
    are among them; a rank outside ``new_mesh`` gets None leaves."""
    if old_mesh is not None:
        if not old_mesh.member:
            return tree_map(lambda lg, x: None, logical_tree, like, is_leaf=is_logical)
        whole = gather(tree, tree_layout(logical_tree, like, old_mesh), old_mesh)
        if not new_mesh.member:
            return tree_map(lambda lg, x: None, logical_tree, like, is_leaf=is_logical)
        moved = place(whole, tree_layout(logical_tree, like, new_mesh), new_mesh)
        return tree_map(lambda lg, x: x.to(new_mesh.device) if isinstance(x, torch.Tensor)
                        else x, logical_tree, moved, is_leaf=is_logical)

    def move(lg, x):
        whole = full_tensor(x) if isinstance(x, DTensor) else x
        return distribute(whole, named_sharding(lg, new_mesh, dim_sizes=whole.shape))
    return tree_map(move, logical_tree, tree, is_leaf=is_logical)
