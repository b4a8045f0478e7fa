"""Hand-written CUDA kernels for Hopper, each beside its plain version.

``csrc/`` holds the sources, ``_build`` compiles them with ``nvcc`` at
first use. Each ``<kernel>/ops.py`` wrapper launches its kernel for CUDA
tensors, counts its launches, and takes the plain PyTorch version in
``<kernel>/ref.py`` only for CPU tensors.
"""
