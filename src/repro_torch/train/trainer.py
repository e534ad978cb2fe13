"""Training loop with fault-tolerance plumbing.

Counterpart of ``repro.train.trainer``:

* checkpoint/restart (async :class:`Checkpointer`; restart-exact with the
  deterministic data pipeline);
* SIGTERM preemption hook (checkpoint, then exit; the previous handler is
  put back when the run ends);
* step watchdog / straggler mitigation: per-step wall time is tracked with
  an EMA; steps slower than ``straggler_factor`` x EMA are counted and
  reported to ``on_straggler``;
* loss-spike guard: drop the update when the gradient norm explodes. The
  port's step writes the state in place, so the guard is asked before the
  update (the step's ``accept``) instead of discarding a new state after
  it; the kept state is the same.

A step's wall time includes reading its loss to the host, which waits for
the device.
"""
from __future__ import annotations

import os
import signal
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

from repro_torch.checkpoint.checkpointer import Checkpointer, install_preemption_hook


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 50
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    async_checkpoint: bool = True
    straggler_factor: float = 3.0
    ema_alpha: float = 0.2
    grad_spike_factor: float = 0.0   # 0 = disabled; e.g. 10.0


@dataclass
class TrainerReport:
    steps: int = 0
    restarts: int = 0
    straggler_steps: int = 0
    losses: List[float] = field(default_factory=list)
    step_times: List[float] = field(default_factory=list)


class Trainer:
    def __init__(self, cfg: TrainerConfig, step_fn, state, data_iter, *,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.cfg = cfg
        self.step_fn = step_fn
        self.state = state
        self.data_iter = data_iter
        self.ckpt = Checkpointer(cfg.checkpoint_dir)
        self.report = TrainerReport()
        self.start_step = 0
        self.on_straggler = on_straggler
        self._ema_time = None
        self._grad_ema = None

    def maybe_restore(self, device=None):
        step, state = self.ckpt.restore_latest(self.state, device)
        if step is not None:
            self.state = state
            self.start_step = step
            self.report.restarts += 1
        return self.start_step

    def _checkpoint(self, step: int, blocking: bool):
        self.ckpt.save(step, self.state, blocking=blocking,
                       metadata={"step": step})

    def _accept(self, gnorm) -> bool:
        """False for a grad spike: the norm above ``grad_spike_factor`` x
        its EMA of accepted steps."""
        gnorm = float(gnorm)
        cfg = self.cfg
        return not (self._grad_ema is not None
                    and gnorm > cfg.grad_spike_factor * self._grad_ema)

    def run(self) -> TrainerReport:
        cfg = self.cfg
        previous = install_preemption_hook(lambda: self._checkpoint(self._cur, True))
        try:
            self._run()
        finally:
            signal.signal(signal.SIGTERM, previous)
        return self.report

    def _run(self):
        cfg = self.cfg
        guard = cfg.grad_spike_factor > 0
        self._cur = self.start_step
        for step in range(self.start_step, cfg.total_steps):
            self._cur = step
            batch = next(self.data_iter)
            t0 = time.perf_counter()
            if guard:
                new_state, metrics = self.step_fn(self.state, batch, accept=self._accept)
            else:
                new_state, metrics = self.step_fn(self.state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0

            gnorm = float(metrics.get("grad_norm", 0.0))
            if not metrics.get("skipped", False):
                self.state = new_state
                self._grad_ema = (gnorm if self._grad_ema is None else
                                  0.9 * self._grad_ema + 0.1 * gnorm)

            if self._ema_time is None:
                self._ema_time = dt
            elif dt > cfg.straggler_factor * self._ema_time:
                self.report.straggler_steps += 1
                if self.on_straggler:
                    self.on_straggler(step, dt / self._ema_time)
            else:
                self._ema_time = ((1 - cfg.ema_alpha) * self._ema_time
                                  + cfg.ema_alpha * dt)

            self.report.steps += 1
            self.report.losses.append(loss)
            self.report.step_times.append(dt)

            if (step + 1) % cfg.checkpoint_every == 0 or \
                    step + 1 == cfg.total_steps:
                self._checkpoint(step + 1, blocking=not cfg.async_checkpoint)
        self.ckpt.wait()
