"""Hand-written CUDA kernels for Hopper, each beside its plain version.

``csrc/`` holds the sources, ``_build`` compiles them with ``nvcc`` at
first use. Each ``<kernel>/ops.py`` wrapper launches its kernel for CUDA
tensors, counts its launches, and takes the plain PyTorch version in
``<kernel>/ref.py`` only for CPU tensors.
"""
from __future__ import annotations

import torch

#: ``impl`` values of the model's dispatch: "auto" takes the kernel for
#: CUDA tensors and the plain version for CPU tensors; "ref" always
#: takes the plain version; "blocked" takes the plain blocked attention
#: (``models/attention.py::attention_blocked``) and the plain SSD scan
IMPLS = ("auto", "ref", "blocked")


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Does ``impl`` on a tensor like ``x`` take the CUDA kernel?"""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "auto" and x.is_cuda


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise if autograd would want a gradient through a kernel.

    The kernels are forward-only, as their Pallas originals are: their
    outputs are written into fresh tensors with no autograd history, so
    a gradient would silently stop at them. Training takes the plain
    versions (``impl="ref"`` or ``"blocked"``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            "grad; run it under torch.no_grad(), or take the plain version "
            "(impl='ref' or 'blocked') where a gradient is wanted")
