"""Hardware constants of the simulated fabric, for the NVIDIA H100 target
(per card).

They keep the names of the JAX package's TPU table, so the code that
builds the fabric (``train/cluster.py``, ``train/pods.py``,
``ckpt/replication.py``) reads them unchanged. They are model parameters
of the simulated fabric, taken from NVIDIA's published figures for the
H100 SXM5 80GB and the DGX H100 system: no value here was measured on a
card, and none is a measurement of this program. The two latencies have
no data-sheet figure; each comment says which generic value stands in.
"""
from __future__ import annotations

# compute / memory (per card)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores (H100 SXM5 data sheet)
HBM_BW = 3.35e12                # bytes/s, HBM3 (H100 SXM5 data sheet)
HBM_BYTES = 80e9                # 80 GB of HBM3 (H100 SXM5 data sheet)

# interconnect
PCIE_BW = 64e9                  # bytes/s host<->device per direction: PCIe Gen5 x16
#                                 (the data sheet's 128 GB/s is both directions)
PCIE_LAT = 1e-6                 # seconds host<->device one way: no data-sheet figure;
#                                 a generic ~1 us for one DMA across a PCIe Gen5 link
DCN_BW_PER_CHIP = 50e9          # bytes/s per card across the node boundary: the DGX
#                                 H100's one 400 Gb/s ConnectX-7 port per GPU
DCN_LAT = 5e-6                  # seconds: no data-sheet figure; a generic few-us
#                                 one-way RDMA latency through one switch
