"""Training loop, the port of ``repro/train/trainer.py``: data -> step ->
metrics -> checkpoints -> recovery.

Each step regenerates its batch from the deterministic pipeline
(``batch_at(step)``), moves it to the device (``put_batch``), runs the
step function with the step index as a Python ``int``, turns its
metrics into floats (one host sync per step) and records them in
``history`` and the optional JSONL log. ``ckpt`` restores the newest
checkpoint at construction and saves every ``ckpt.every`` steps (async:
the state is copied to the host before the next step updates it in
place).

Two timing modes:

- wall clock (default): each step is timed with ``time.monotonic``.
- runtime (``runtime=`` a ``FabricRuntime`` + ``time_model=`` a
  ``ClusterTimeModel``): every step *also* advances simulated time —
  the roofline compute delay plus the gradient staging transfers on
  the node's host path (and checkpoint staging on the configured
  SoC/host path on checkpoint steps), all charged against the shared
  ledger. Step records then carry ``sim_seconds`` and ``tokens_per_s``.
  The numeric stream is identical in both modes.

``run_steps(fail_at=k)`` silences the node at step ``k``: its heartbeat
process stops, the ``FaultToleranceManager`` watchdog expires in
simulated time and ``NodeFailure`` surfaces; recovery is a fresh
``Trainer`` on the same checkpoint directory.
"""
from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig, RunConfig, ShapeConfig
from repro_torch.core.fabric import IN, OUT
from repro_torch.core.runtime import FabricRuntime
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.ft.manager import FaultToleranceManager, NodeFailure
from repro_torch.ft.straggler import StragglerDetector
from repro_torch.optim.adamw import tree_leaves
from repro_torch.train.cluster import AUTO, train_fabric


class Trainer:
    def __init__(self, cfg: ModelConfig, run: RunConfig, shape: ShapeConfig, *,
                 step_fn: Callable,            # (params, opt, batch, step) -> ...
                 params: Any, opt_state: Any,
                 put_batch: Optional[Callable] = None,
                 ckpt: Optional[CheckpointManager] = None,
                 log_path: Optional[str] = None,
                 node_name: str = "self",
                 runtime=None,                 # FabricRuntime (simulated time)
                 time_model=None,              # ClusterTimeModel
                 node_index: int = 0,
                 ft_timeout: float = 1.0):
        self.cfg, self.run, self.shape = cfg, run, shape
        self.step_fn = step_fn
        self.params, self.opt_state = params, opt_state
        self.put_batch = put_batch or self._to_params_device
        self.pipeline = TokenPipeline(cfg, shape, seed=run.seed)
        self.ckpt = ckpt
        self.straggler = StragglerDetector()
        self.log_path = log_path
        self.node_name = node_name
        self.node_index = node_index
        self.time_model = time_model
        if runtime is None and time_model is not None:
            runtime = FabricRuntime(train_fabric(1))
        self.runtime = runtime
        self.ft_timeout = ft_timeout
        self.ft: Optional[FaultToleranceManager] = None
        self._hb_proc = None
        self.history: list = []
        self.start_step = 0
        if ckpt is not None and ckpt.latest_step() is not None:
            (self.params, self.opt_state), k = ckpt.restore(
                (self.params, self.opt_state))
            self.start_step = k + 1

    def _to_params_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        device = tree_leaves(self.params)[0].device
        return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}

    def _log(self, rec: Dict):
        self.history.append(rec)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")

    # -- simulated step timing (runtime mode) ---------------------------
    def _simulate_step(self, step: int) -> float:
        """One step's simulated duration: compute + gradient staging on
        the node's host path, checkpoint staging overlapped on the
        configured path. Single-node by construction — no ring exchange
        and no barrier, unlike a TrainCluster node step; multi-node
        callers want TrainCluster, not N Trainers."""
        rt, tm, i = self.runtime, self.time_model, self.node_index
        t0 = rt.clock.now
        will_ckpt = (tm.ckpt_bytes > 0 and self.ckpt is not None
                     and self.ckpt.every > 0 and step % self.ckpt.every == 0)
        finished = []

        def one_step():
            ck = None
            if will_ckpt:
                staging = (CheckpointManager.choose_staging(
                    [f"host:{i}", f"soc:{i}"], ledger=rt.ledger, direction=OUT)
                    if tm.ckpt_path == AUTO else f"{tm.ckpt_path}:{i}")
                ck = rt.transfer(staging, tm.ckpt_bytes,
                                 direction=OUT, flow=f"ckpt:{self.node_name}")
            yield tm.compute_s
            if tm.grad_bytes > 0:
                self.straggler.observe_ledger(self.node_name, rt.ledger,
                                              f"host:{i}")
                yield rt.transfer(f"host:{i}", tm.grad_bytes, direction=OUT,
                                  flow=f"grad:{self.node_name}")
                yield rt.transfer(f"host:{i}", tm.grad_bytes, direction=IN,
                                  flow=f"grad:{self.node_name}")
            if ck is not None:
                yield ck
            finished.append(True)

        rt.process(one_step(), name=f"step:{self.node_name}")
        rt.clock.run(stop=lambda: bool(finished))
        return rt.clock.now - t0

    # -- event-driven failure injection (ft/manager watchdogs) -----------
    def _arm_ft(self) -> None:
        """Register this node with an event-driven FT manager on the
        trainer's runtime (created on demand for wall-clock trainers).
        Heartbeats are a *periodic runtime process*, not per-step calls —
        a simulated step longer than the timeout must not let the
        watchdog expire under a healthy node. A silenced node is then
        detected by its watchdog expiring on the simulated clock."""
        if self.runtime is None:
            self.runtime = FabricRuntime(train_fabric(1))
        if self.ft is None:
            self.ft = FaultToleranceManager(self.ckpt, timeout=self.ft_timeout,
                                            runtime=self.runtime)
        if self.node_name not in self.ft.nodes:
            self.ft.register(self.node_name)
        if self._hb_proc is None or self._hb_proc.done:
            self._hb_proc = self.runtime.every(
                self.ft_timeout / 4.0,
                lambda: self.ft.heartbeat(self.node_name),
                name=f"hb:{self.node_name}", start_delay=0.0)

    def _disarm_ft(self) -> None:
        if self._hb_proc is not None:
            self._hb_proc.kill()
            self._hb_proc = None
        if self.ft is not None:
            self.ft.disarm()

    def _fail_silently(self, step: int) -> None:
        """Go silent at `step`: kill the heartbeat process and run the
        simulated clock until the watchdog fires, then surface the
        detection."""
        rt = self.runtime
        self._hb_proc.kill()
        self._hb_proc = None
        rt.clock.run(stop=lambda: bool(self.ft.pending_failures))
        self.ft.disarm()
        if self.ckpt is not None:
            self.ckpt.wait()
        detected = self.ft.pending_failures.pop(0)
        raise NodeFailure(
            f"node {detected} failure detected at "
            f"sim t={rt.clock.now:.3f}s (silent since step {step})")

    def run_steps(self, num_steps: int, *, fail_at: Optional[int] = None) -> Dict:
        """Run ``num_steps`` from ``start_step``; returns the last record.
        ``fail_at`` silences this node at that step (see the module
        docstring)."""
        step = self.start_step
        end = self.start_step + num_steps
        if fail_at is not None:
            self._arm_ft()
        tokens_per_step = (self.time_model.tokens_per_step
                           if self.time_model is not None
                           and self.time_model.tokens_per_step
                           else self.shape.global_batch * self.shape.seq_len)
        while step < end:
            if fail_at is not None and step == fail_at:
                self._fail_silently(step)
            t0 = time.monotonic()
            batch = self.put_batch(self.pipeline.batch_at(step))
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, step)
            metrics = {k: float(v) for k, v in metrics.items()}
            dt = time.monotonic() - t0
            rec = {"step": step, "seconds": dt, **metrics}
            if self.runtime is not None and self.time_model is not None:
                sim_dt = self._simulate_step(step)
                rec["sim_seconds"] = sim_dt
                if sim_dt > 0:
                    rec["tokens_per_s"] = tokens_per_step / sim_dt
                self.straggler.observe(self.node_name, sim_dt)
            else:
                self.straggler.observe(self.node_name, dt)
            self._log(rec)
            if self.ckpt is not None:
                self.ckpt.maybe_save(step, (self.params, self.opt_state))
            step += 1
        self._disarm_ft()
        if self.ckpt is not None:
            self.ckpt.wait()
        self.start_step = step
        return self.history[-1] if self.history else {}
