"""Fault tolerance: heartbeat failure detection and checkpoint recovery
(``manager``), straggler detection (``straggler``), both copies of the
JAX package's modules, and the survivor-mesh choice (``elastic``)."""
from repro_torch.ft.manager import FaultToleranceManager, NodeState
from repro_torch.ft.elastic import best_mesh_for, reshard
from repro_torch.ft.straggler import StragglerDetector
