"""Roofline terms of a dry-run cell, the copy of
``repro/core/roofline.py`` (its statements unchanged, held to its AST
by ``tests/test_torch_fabric.py``).

    compute term    = FLOPs (per chip) / peak_FLOP/s
    memory term     = bytes (per chip) / HBM_bw
    collective term = sum_path collective_bytes(per chip, path) / path_bw

``build_report`` takes XLA's ``cost_analysis()`` and HLO text, as the
JAX dry-run has them; the port's dry-run has neither and assembles the
same report from its own counts (``launch/dryrun.py::report_from``,
held to ``build_report`` by ``tests/test_torch_dryrun.py``). The
collective term assumes no overlap between paths. ``model_flops_for``
is also what the simulated training cluster reads.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core import hw
from repro_torch.core.charz import TrafficSummary, summarize_traffic
from repro_torch.core.paths import enumerate_paths


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    hbm_bytes_per_chip: float
    collective_bytes_per_path: Dict[str, float]
    compute_s: float
    memory_s: float
    collective_s: float
    collective_s_per_path: Dict[str, float]
    dominant: str
    model_flops: float               # 6*N*D global
    useful_flops_ratio: float        # MODEL_FLOPS / (HLO_FLOPs * chips)
    step_time_s: float               # max of the three terms
    roofline_frac: float             # compute_s / step_time_s ("MFU-like")
    memory_bytes_per_chip: Optional[float] = None   # live buffers (fits check)
    note: str = ""

    def row(self) -> str:
        coll = ", ".join(f"{k}={v * 1e3:.2f}ms" for k, v in
                         sorted(self.collective_s_per_path.items()))
        return (f"| {self.arch} | {self.shape} | {self.mesh} "
                f"| {self.compute_s * 1e3:.2f} | {self.memory_s * 1e3:.2f} "
                f"| {self.collective_s * 1e3:.2f} | {self.dominant} "
                f"| {self.useful_flops_ratio:.2f} | {self.roofline_frac:.2f} "
                f"| {coll} |")


def build_report(*, arch: str, shape: str, mesh_name: str,
                 mesh_axes, cost: dict, hlo_text: str,
                 model_flops: float, chips: int,
                 memory_bytes_per_chip: Optional[float] = None,
                 note: str = "") -> RooflineReport:
    if isinstance(cost, (list, tuple)):   # old jax: per-device list of dicts
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    hbm_bytes = float(cost.get("bytes accessed", 0.0))
    traffic: TrafficSummary = summarize_traffic(hlo_text, mesh_axes)
    paths = enumerate_paths(dict(mesh_axes))

    compute_s = flops / hw.PEAK_FLOPS_BF16
    memory_s = hbm_bytes / hw.HBM_BW
    coll_per_path_s: Dict[str, float] = {}
    for pname, nbytes in traffic.per_path.items():
        bw = paths[pname].bw if pname in paths else hw.ICI_BW_PER_LINK
        coll_per_path_s[pname] = nbytes / bw
    collective_s = sum(coll_per_path_s.values())

    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    step = max(terms.values()) if terms else 0.0
    useful = model_flops / max(flops * chips, 1.0)
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name,
        flops_per_chip=flops, hbm_bytes_per_chip=hbm_bytes,
        collective_bytes_per_path=dict(traffic.per_path),
        compute_s=compute_s, memory_s=memory_s,
        collective_s=collective_s, collective_s_per_path=coll_per_path_s,
        dominant=dominant, model_flops=model_flops,
        useful_flops_ratio=useful,
        step_time_s=step,
        roofline_frac=compute_s / step if step > 0 else 0.0,
        memory_bytes_per_chip=memory_bytes_per_chip,
        note=note,
    )


def model_flops_for(param_count_active: int, tokens: int, kind: str = "train") -> float:
    """6*N*D (train fwd+bwd) or 2*N*D (inference fwd)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens
