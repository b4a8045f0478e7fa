"""Roofline helpers, the part of ``repro/core/roofline.py`` that the
simulated training cluster reads: ``model_flops_for``. The HLO-based
step report waits for the dry-run slice."""
from __future__ import annotations


def model_flops_for(param_count_active: int, tokens: int, kind: str = "train") -> float:
    """6*N*D (train fwd+bwd) or 2*N*D (inference fwd)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * param_count_active * tokens
