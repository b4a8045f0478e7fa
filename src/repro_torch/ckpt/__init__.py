"""Checkpoints of torch training state (``checkpoint``: the JAX
package's on-disk layout, so a checkpoint moves between the packages)
and the LineFS replication planner (``replication``, a copy)."""
from repro_torch.ckpt.checkpoint import (CheckpointManager, load_checkpoint,
                                         save_checkpoint)
from repro_torch.ckpt.replication import ReplicationPlan, plan_replication
