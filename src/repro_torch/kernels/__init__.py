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
#: takes the plain version
IMPLS = ("auto", "ref")


def use_kernel(impl: str, x: torch.Tensor) -> bool:
    """Does ``impl`` on a tensor like ``x`` take the CUDA kernel?"""
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    return impl == "auto" and x.is_cuda
