"""Hardware constants of the simulated fabric, for the NVIDIA H100 target
(per card).

They keep the names of the JAX package's TPU table, so the code that
builds the fabric (``train/cluster.py``, ``train/pods.py``,
``ckpt/replication.py``) reads them unchanged. They are model parameters
of the simulated fabric, taken from NVIDIA's published figures for the
H100 SXM5 80GB and the DGX H100 system: no value here was measured on a
card, and none is a measurement of this program. The three latencies
have no data-sheet figure; each comment says which generic value stands
in.

The mesh axes of the dry-run (``core/paths.py``) read the ``ICI_*``
names as NVLink 4 through the NVSwitch of one DGX H100 node (8 cards).
A mesh axis wider than 8 (the production meshes' 16) in fact crosses
the ConnectX-7 network between nodes; this model does not tell the two
apart, as the JAX package's TPU table does not tell an ICI ring from a
torus.
"""
from __future__ import annotations

# compute / memory (per card)
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor cores (H100 SXM5 data sheet)
HBM_BW = 3.35e12                # bytes/s, HBM3 (H100 SXM5 data sheet)
HBM_BYTES = 80e9                # 80 GB of HBM3 (H100 SXM5 data sheet)

# interconnect
ICI_BW_PER_LINK = 25e9          # bytes/s per NVLink 4 link per direction: the data
#                                 sheet's 900 GB/s per GPU over its 18 links is both
#                                 directions, so 50 GB/s a link both ways
ICI_LINKS_PER_AXIS = 18         # links one mesh axis's collective may use: every
#                                 NVLink of the card reaches the node's NVSwitch
#                                 fabric (DGX H100), so any axis can use all 18
#                                 (450 GB/s a direction); the axes share them
#                                 (shared group "ici" in core/paths.py)
ICI_LAT = 1e-6                  # seconds per hop: no data-sheet figure; a generic
#                                 ~1 us one way through one NVSwitch hop
PCIE_BW = 64e9                  # bytes/s host<->device per direction: PCIe Gen5 x16
#                                 (the data sheet's 128 GB/s is both directions)
PCIE_LAT = 1e-6                 # seconds host<->device one way: no data-sheet figure;
#                                 a generic ~1 us for one DMA across a PCIe Gen5 link
DCN_BW_PER_CHIP = 50e9          # bytes/s per card across the node boundary: the DGX
#                                 H100's one 400 Gb/s ConnectX-7 port per GPU
DCN_LAT = 5e-6                  # seconds: no data-sheet figure; a generic few-us
#                                 one-way RDMA latency through one switch
