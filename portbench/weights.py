"""The benchmark's weights, made on the device from the seed.

The tree has the layout the program takes (``params["layers"]`` a tuple
of per-slot dicts whose leaves stack the layers on a leading dim); the
layout and the distributions of each family are in
``reference/<family>.py`` (``LAYOUT``), so both sides read the same
inputs. Each leaf is drawn by its own ``torch.Generator`` seeded from
(seed, leaf), so one leaf can be drawn again alone. Matrices are drawn
in bf16, the type they are served in; a training run widens them to its
f32 masters, which then hold the same values.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Tuple

import torch

from portbench import reference
from portbench.traffic import device_seed

Path_ = Tuple[Any, ...]


def layout(model: Dict) -> Dict[Path_, Tuple[Tuple[int, ...], Dict]]:
    """path -> (shape, init) of every leaf, in a fixed order."""
    return reference.family(model).LAYOUT(model)


def leaf(model: Dict, path: Path_, seed: int, device, *, dtype=None) -> torch.Tensor:
    """One leaf drawn from the seed. Matrices come in bf16 and vectors
    (norm scales, the SSM's ``A_log``, ``D``, ``dt_bias``) in f32, unless
    ``dtype`` asks for another."""
    items = layout(model)
    shape, init = items[path]
    index = list(items).index(path)
    gen = torch.Generator(device=device)
    gen.manual_seed(device_seed(seed, 7, index))
    kind = init["init"]
    if kind == "normal":
        t = torch.empty(shape, dtype=torch.bfloat16, device=device)
        t.normal_(0.0, init["std"], generator=gen)
    elif kind == "ones":
        t = torch.ones(shape, dtype=torch.float32, device=device)
    elif kind == "log_uniform_a":          # A = U[lo, hi], stored as its log
        t = torch.empty(shape, dtype=torch.float32, device=device)
        t = torch.log(t.uniform_(init["lo"], init["hi"], generator=gen))
    elif kind == "inv_softplus_dt":        # dt log-uniform in [lo, hi]
        u = torch.empty(shape, dtype=torch.float32, device=device).uniform_(0.0, 1.0,
                                                                             generator=gen)
        dt = torch.exp(u * (math.log(init["hi"]) - math.log(init["lo"])) + math.log(init["lo"]))
        t = dt + torch.log(-torch.expm1(-dt))
    else:
        raise ValueError(f"unknown init {kind!r} of {path}")
    return t if dtype is None else t.to(dtype)


def paths(model: Dict) -> Iterator[Path_]:
    return iter(layout(model))


def make(model: Dict, seed: int, device, *, masters: bool = False) -> Dict:
    """The whole tree: served types, or f32 masters (``masters``)."""
    tree: Dict = {}
    for path in paths(model):
        t = leaf(model, path, seed, device, dtype=torch.float32 if masters else None)
        put(tree, path, t)
    return _tuples(tree)


def put(tree: Dict, path: Path_, value) -> None:
    node = tree
    for key in path[:-1]:
        node = node.setdefault(key, {})
    node[path[-1]] = value


def get(tree, path: Path_):
    for key in path:
        tree = tree[key]
    return tree


def _tuples(node):
    """The ``layers`` level as a tuple of slots (integer keys), as the
    program's tree has it."""
    if isinstance(node, dict):
        if node and all(isinstance(k, int) for k in node):
            return tuple(_tuples(node[i]) for i in range(len(node)))
        return {k: _tuples(v) for k, v in node.items()}
    return node
