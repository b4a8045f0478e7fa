"""Training loop, the wall-clock mode of ``repro/train/trainer.py``:
data -> step -> metrics.

Each step regenerates its batch from the deterministic pipeline
(``batch_at(step)``), moves it to the device (``put_batch``), runs the
step function, turns its metrics into floats (one host sync per step)
and records them, with the step's wall-clock seconds, in ``history``
and the optional JSONL log.

Not ported yet, and refused: checkpoints (``ckpt``), the simulated-time
mode (``runtime``, ``time_model``), failure injection (``fail_at``) and
the straggler bookkeeping that feeds them (ROADMAP A5).
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.optim.adamw import tree_leaves


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"Trainer: {what} is not ported yet (ROADMAP A5)")


class Trainer:
    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, *,
                 step_fn: Callable,            # (params, opt, batch, step) -> ...
                 params: Any, opt_state: Any,
                 put_batch: Optional[Callable] = None,
                 ckpt=None, log_path: Optional[str] = None,
                 runtime=None, time_model=None):
        for name, value in (("ckpt", ckpt), ("runtime", runtime),
                            ("time_model", time_model)):
            if value is not None:
                raise _not_ported(f"{name}=")
        self.cfg, self.run, self.shape = cfg, run, shape
        self.step_fn = step_fn
        self.params, self.opt_state = params, opt_state
        self.put_batch = put_batch or self._to_params_device
        self.pipeline = TokenPipeline(cfg, shape, seed=run.seed)
        self.log_path = log_path
        self.history: list = []
        self.start_step = 0

    def _to_params_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        device = tree_leaves(self.params)[0].device
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def _log(self, rec: Dict):
        self.history.append(rec)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    def run_steps(self, num_steps: int, *, fail_at: Optional[int] = None) -> Dict:
        """Run ``num_steps`` from ``start_step``; returns the last record."""
        if fail_at is not None:
            raise _not_ported("fail_at=")
        step = self.start_step
        end = self.start_step + num_steps
        while step < end:
            t0 = time.monotonic()
            batch = self.put_batch(self.pipeline.batch_at(step))
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            self._log({"step": step, "seconds": time.monotonic() - t0, **metrics})
            step += 1
        self.start_step = step
        return self.history[-1] if self.history else {}
