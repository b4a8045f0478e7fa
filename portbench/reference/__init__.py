"""The plain reference: f32 PyTorch with TF32 off, written from the
published descriptions, with no kernel, cache or batching.

One module a model family (``dense.py``, ``ssm.py``), found by the
``family`` of a configuration's ``model``. Each has ``LAYOUT(model)``
(every input leaf's shape and distribution), ``logits_rows`` (a
sequence's f32 logits at chosen positions) and, where the family
trains, ``loss_sum``. ``adamw.py`` is the optimizer with int8 blockwise
moments. Nothing here imports the program (``repro_torch``) or the JAX
package: it takes the benchmark's inputs and works out again whatever
the program derives from them.
"""
from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

import torch


def family(model: Dict) -> ModuleType:
    return importlib.import_module(f"portbench.reference.{model['family']}")


def exact_f32() -> None:
    """f32 products in f32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
