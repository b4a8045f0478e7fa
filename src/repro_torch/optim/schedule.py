"""LR schedule, the counterpart of ``repro/optim/schedule.py``: a pure
function of the step, computed in f32 as the JAX version is."""
from __future__ import annotations

import math

import torch


def lr_at(step, *, base_lr: float, warmup_steps: int, total_steps: int,
          min_ratio: float = 0.1) -> torch.Tensor:
    """Linear warmup + cosine decay to min_ratio*base_lr: a 0-d f32 tensor
    on the CPU (``jnp.asarray(step, jnp.float32)`` and the same order of
    f32 operations)."""
    step = torch.as_tensor(step, dtype=torch.float32, device="cpu")
    warm = base_lr * step / max(warmup_steps, 1)
    prog = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog)))
    return torch.where(step < warmup_steps, warm, cos)
