"""The train loop: checkpoint/restart, straggler detection, preemption
handling, metrics (the port's counterpart of ``repro/train/loop.py``, the
same logic).

  * resume is exact — the data pipeline is a pure function of the step;
  * checkpoints go through ``repro_torch.checkpoint.CheckpointManager``:
    atomic, async, in the reference's on-disk format.  Its writer holds
    host copies taken before it starts, so the in-place optimizer step
    that follows cannot tear a checkpoint in flight;
  * SIGTERM (preemption notice) → blocking checkpoint → clean exit;
  * straggler monitor: per-step wall-time EWMA; steps slower than
    ``straggler_factor``× the EWMA are logged and counted.

The loop reads the loss back to the host once a step before it takes the
step's time, so ``dt`` covers the device's work, not only its enqueue.

On a device mesh (``mesh=``, wider than one device) a save is a
collective (``checkpoint.save_pytree`` gathers every leaf), so every rank
must save at the same steps: the ranks agree on the SIGTERM flag (one
all-reduce max a step) before deciding.
"""
from __future__ import annotations

import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np


@dataclasses.dataclass
class StragglerMonitor:
    factor: float = 2.0
    ewma: Optional[float] = None
    alpha: float = 0.1
    slow_steps: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.factor * self.ewma
        if slow:
            self.slow_steps += 1
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        return slow


class TrainLoop:
    def __init__(self, train_step: Callable, batch_fn: Callable,
                 ckpt_manager, log_path: Optional[str] = None,
                 ckpt_every: int = 50, straggler_factor: float = 2.0,
                 mesh=None):
        self.train_step = train_step
        self.mesh = mesh
        self.batch_fn = batch_fn
        self.ckpt = ckpt_manager
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.log_path = Path(log_path) if log_path else None
        self._preempted = False

    def _install_sigterm(self):
        def handler(signum, frame):
            self._preempted = True
        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not on the main thread (tests)

    def _log(self, rec: dict) -> None:
        if self.log_path:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            with self.log_path.open("a") as f:
                f.write(json.dumps(rec) + "\n")

    def run(self, state, start_step: int, n_steps: int):
        """Steps ``start_step`` .. ``n_steps - 1``; returns (state, the step
        reached, the losses as a numpy array)."""
        self._install_sigterm()
        step = start_step
        losses = []
        while step < n_steps:
            t0 = time.time()
            batch = self.batch_fn(step)
            state, metrics = self.train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            slow = self.monitor.observe(dt)
            losses.append(loss)
            step += 1
            self._log({"step": step, "loss": loss, "dt_s": round(dt, 4),
                       "grad_norm": float(metrics["grad_norm"]),
                       "straggler": bool(slow)})
            if self.mesh is not None:
                self._preempted = self.mesh.agree(self._preempted)
            if step % self.ckpt_every == 0 or step == n_steps:
                self.ckpt.save(state, step)
            if self._preempted:
                self.ckpt.save(state, step, blocking=True)
                self._log({"step": step, "event": "preempted_checkpointed"})
                break
        self.ckpt.wait()
        return state, step, np.asarray(losses)
