"""Finding a cell's files by name: ``BENCHMARK.json``, the configuration,
the traffic mix and the per-layer metric readers.

Every function takes the benchmark's directory (``root``) and the parsed
``BENCHMARK.json``, so a test can point them at a directory of its own.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    known = ", ".join(w["name"] for w in bench["workloads"])
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {known}")


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def config(name: str, root: Path = ROOT) -> dict:
    return _json(root / "configs" / f"{name}.json")


def traffic(name: str, root: Path = ROOT) -> dict:
    return _json(root / "traffic" / f"{name}.json")


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics a cell reports (``setup_s`` among them)."""
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics of a cell's traced run: those that list the
    cell, and those without a list whose end-to-end metric it reports."""
    moved = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moved)]


def reader(name: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read(run)`` of ``metrics/<name>.py``: the metric's value from a
    finished run's record, or None where the run holds nothing to read."""
    path = root / "metrics" / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing: no reader for {name!r}")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{len(name)}_{abs(hash(name))}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(metrics: List[dict], run: Any, root: Path = ROOT) -> Dict[str, dict]:
    """Each metric's ``{"value", "unit"}`` where its reader found something."""
    out = {}
    for m in metrics:
        value = reader(m["name"], root)(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
