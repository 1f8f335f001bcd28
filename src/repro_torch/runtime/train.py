"""Fault-tolerant training loop (counterpart of ``repro/runtime/train.py``).

* checkpoint/restart: periodic async checkpoints (params and optimizer
  state); on (re)start the loop restores the latest checkpoint and the
  deterministic data pipeline continues from the exact step, so a restarted
  run ends where an uninterrupted one does.
* failure handling: any exception in a step (injectable through
  ``failure_hook``) restores the last checkpoint and replays from it, up to
  ``max_restarts`` times.
* straggler detection: each step's wall time against the median of the last
  32; a step slower than ``straggler_factor`` times it is recorded and
  passed to ``on_straggler``.

The batch goes onto the parameters' device with ``torch.as_tensor``.  On
the card a step's time is taken after ``torch.cuda.synchronize``, so it is
the step's time and not the time to enqueue it.  The reference's elastic
restore onto another mesh waits for the port's parallelism (ROADMAP.md,
queue 1, item 10): ``shardings`` is a device here.
"""
from __future__ import annotations

import os
import statistics
import tempfile
import time
from dataclasses import dataclass, field

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.tree import leaves

__all__ = ["TrainLoop", "TrainConfig"]


@dataclass
class TrainConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


@dataclass
class TrainLoop:
    cfg: TrainConfig
    step_fn: object          # (params, opt, batch) -> (params, opt, metrics)
    pipeline: object         # .batch(step) -> host batch dict
    failure_hook: object = None      # fn(step) -> None, may raise (tests)
    on_straggler: object = None      # fn(step, dt, median) -> None
    metrics_log: list = field(default_factory=list)
    straggler_steps: list = field(default_factory=list)
    restarts: int = 0

    def run(self, params, opt_state, *, start_step: int = 0,
            shardings=None):
        mgr = CheckpointManager(self.cfg.ckpt_dir, keep=self.cfg.keep)
        device = leaves(params)[0].device
        state = {"params": params, "opt": opt_state}
        step = start_step
        if mgr.latest_step() is not None:
            state, step, extra = mgr.restore(state, shardings=shardings)
            step += 1
        times = []
        while step < self.cfg.total_steps:
            try:
                t0 = time.time()
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = {k: torch.as_tensor(v, device=device)
                         for k, v in self.pipeline.batch(step).items()}
                p, o, metrics = self.step_fn(state["params"], state["opt"],
                                             batch)
                state = {"params": p, "opt": o}
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                dt = time.time() - t0
                times.append(dt)
                med = statistics.median(times[-32:])
                if len(times) > 4 and dt > self.cfg.straggler_factor * med:
                    self.straggler_steps.append((step, dt, med))
                    if self.on_straggler is not None:
                        self.on_straggler(step, dt, med)
                if step % self.cfg.log_every == 0 or \
                        step == self.cfg.total_steps - 1:
                    host = {k: float(v) for k, v in metrics.items()}
                    self.metrics_log.append({"step": step, **host,
                                             "dt": dt})
                if step % self.cfg.ckpt_every == 0 and step > start_step:
                    mgr.save(step, state, extra={"step": step},
                             blocking=False)
                step += 1
            except KeyboardInterrupt:
                raise
            except Exception as e:                     # node failure path
                self.restarts += 1
                if self.restarts > self.cfg.max_restarts:
                    raise
                mgr.wait()
                if mgr.latest_step() is not None:
                    state, ck_step, _ = mgr.restore(state,
                                                    shardings=shardings)
                    step = ck_step + 1
                else:
                    step = start_step
                self.metrics_log.append(
                    {"step": step,
                     "event": f"restart after {type(e).__name__}"})
        mgr.wait()
        mgr.save(self.cfg.total_steps - 1, state, blocking=True)
        return state["params"], state["opt"]
