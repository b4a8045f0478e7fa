"""The modules a run of the port must not load, compared by whole
top-level name (the part before the first dot): ``repro_torch`` begins
with ``repro`` and is not the JAX package."""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def loaded(modules: Iterable[str] = None) -> List[str]:
    names = top_level(sys.modules if modules is None else modules)
    return sorted(names & set(FORBIDDEN))
