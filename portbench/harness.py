"""One run of one cell: set-up, the measured window, the traced window
(``trace``), the check against the reference, and the result line.

``run_cell`` takes its files from ``root`` and needs no card: the tests
drive it on the CPU at a tiny size. ``run.py`` looks for the card first.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, Iterable

import torch

from portbench import check, serve, spec, train
from portbench import trace as T

LOOPS = ("serve", "train")


def program_config(cfg: Dict):
    """The program's ``ModelConfig``: the registry's entry with the file's
    ``model`` keys laid over it; every key the program has must then
    read as the file says."""
    from repro_torch.configs import get_config
    base = get_config(cfg["registry"])
    fields = {f.name for f in dataclasses.fields(base)}
    over = {k: v for k, v in cfg["model"].items() if k in fields}
    pcfg = dataclasses.replace(base, **over)
    for k, v in over.items():
        if getattr(pcfg, k) != v:
            raise ValueError(f"{cfg['registry']}: {k} reads {getattr(pcfg, k)!r}, "
                             f"the file says {v!r}")
    return pcfg


def limits(cell_name: str, root: Path = spec.ROOT) -> Dict[str, float]:
    with open(root / "limits" / f"{cell_name}.json") as f:
        return json.load(f)["limits"]


def run_cell(bench: Dict, cell_name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_process: float, root: Path = spec.ROOT,
             controls: Iterable[str] = ()) -> Dict:
    """The result line's dict; ``checks`` last. ``t_process`` is the
    process's start on ``time.perf_counter``'s clock. Each of ``controls``
    is judged by the cell's limits in the program's place (``controls``
    in the result: its ``correct`` and ``checks``)."""
    w = spec.cell(bench, cell_name)
    cfg = spec.config(w["config"], root)
    traffic = spec.traffic(w["traffic"], root)
    loop = traffic["loop"]
    if loop not in LOOPS:
        raise ValueError(f"traffic {w['traffic']!r}: unknown loop {loop!r}")
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
        from repro_torch.kernels import _build
        _build.build()              # every kernel at once on a checkout's first run; else nothing
    pcfg = program_config(cfg)
    mod = serve if loop == "serve" else train
    rec = mod.run(cfg, traffic, seed, seconds, trace, device, pcfg)
    rec["setup_s"] = rec["t0"] - t_process

    metrics = spec.per_layer(bench, cell_name) if trace else spec.end_to_end(bench, cell_name)
    values = spec.read_metrics(metrics, rec, root)

    t = time.perf_counter()
    if loop == "serve":
        numbers = check.serve(cfg["model"], rec.pop("params"), rec["sample"], device, controls)
    else:
        numbers = check.train(cfg["model"], traffic, seed, rec["program"], device, controls)
    numbers["check_s"] = time.perf_counter() - t
    lims = limits(cell_name, root)
    judged = check.judge(numbers, lims)
    out = {"correct": check.passed(judged), "attempted": int(rec["attempted"]),
           "failed": int(rec["failed"]), "metrics": values,
           "device": device_info(device, rec, trace)}
    if trace and rec.get("trace"):
        out["breakdown"] = {k: rec["trace"][k] for k in ("device_ops", "idle_gaps")}
        out["bounded_by"] = T.bound_terms(rec["trace"]["calls"])
        out["trace_counts"] = rec["trace"]["counts"]
    if controls:
        out["controls"] = {}
        for c in controls:
            cj = check.judge(check.control_numbers(numbers, c), lims)
            out["controls"][c] = {"correct": check.passed(cj), "checks": cj}
    out["numbers"] = {k: v for k, v in numbers.items() if k not in judged}
    out["checks"] = judged
    return out


def device_info(device, rec: Dict, trace: bool) -> Dict:
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if trace and rec.get("trace"):
        info["busy_s"] = rec["trace"]["busy_s"]
        info["window_s"] = rec["trace"]["window_s"]
    return info

