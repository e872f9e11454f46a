"""Trainer: the fault-tolerant outer loop (the port of
``repro.train.trainer``).

  * checkpoint/restart — periodic async checkpoints; on a step failure the
    trainer restores the latest checkpoint and replays from there (the data
    pipeline is stateless-deterministic, so replay is exact);
  * bounded retries — a step that keeps failing after ``max_restarts``
    escalates rather than looping forever;
  * straggler watchdog — per-step wall time is tracked against a rolling
    median; slow steps emit events to a pluggable hook;
  * preemption hook — ``request_stop()`` (the SIGTERM handler of
    ``launch/train.py``) finishes the in-flight step, forces a final
    checkpoint, and exits cleanly.

The step's wall time ends at ``torch.cuda.synchronize()`` when the metrics
live on a CUDA device (JAX's ``block_until_ready``).  ``ckpt_dir=None``
turns checkpointing off (a run whose state is too large to write at every
interval); a failed step then raises at once, as there is nothing to
restore.
"""
from __future__ import annotations

import dataclasses
import os
import statistics
import tempfile
import time
from typing import Callable, Optional

import torch

from repro_torch.train import checkpoint as ckpt_lib


def default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = dataclasses.field(default_factory=default_ckpt_dir)
    keep: int = 3
    max_restarts: int = 3
    straggler_factor: float = 3.0   # step > factor * rolling median => event
    straggler_window: int = 20


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    median: float


def _block_until_ready(metrics: dict) -> None:
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


class Trainer:
    def __init__(self, step_fn: Callable, state, batch_fn: Callable,
                 cfg: TrainerConfig,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 straggler_hook: Optional[Callable[[StragglerEvent], None]] = None):
        """batch_fn(step) -> batch.  fault_hook(step) may raise to inject
        failures (tests).  straggler_hook receives StragglerEvents."""
        self.step_fn = step_fn
        self.state = state
        self.batch_fn = batch_fn
        self.cfg = cfg
        self.fault_hook = fault_hook
        self.straggler_hook = straggler_hook or (lambda e: None)
        self.ckpt = (ckpt_lib.AsyncCheckpointer(cfg.ckpt_dir, cfg.keep)
                     if cfg.ckpt_dir else None)
        self.metrics_log: list[dict] = []
        self.failures: list[dict] = []
        self.straggler_events: list[StragglerEvent] = []
        self.restarts = 0
        self._stop = False
        self._durations: list[float] = []

    # -- control -----------------------------------------------------------
    def request_stop(self):
        self._stop = True

    # -- helpers -----------------------------------------------------------
    def _current_step(self) -> int:
        return int(self.state["step"])

    def _save(self, step):
        if self.ckpt is not None:
            self.ckpt.save(step, self.state)

    def _restore(self):
        self.ckpt.wait()  # an in-flight async save may hold the checkpoint
        self.state, step = ckpt_lib.restore_checkpoint(self.cfg.ckpt_dir,
                                                       self.state)
        return step

    def _watch_stragglers(self, step: int, dt: float):
        self._durations.append(dt)
        window = self._durations[-self.cfg.straggler_window:]
        if len(window) >= 5:
            med = statistics.median(window)
            if dt > self.cfg.straggler_factor * med:
                ev = StragglerEvent(step, dt, med)
                self.straggler_events.append(ev)
                self.straggler_hook(ev)

    # -- main loop ----------------------------------------------------------
    def run(self):
        cfg = self.cfg
        if self.ckpt is not None and ckpt_lib.latest_step(cfg.ckpt_dir) is not None:
            self._restore()
        if self._current_step() == 0:
            self._save(0)

        while self._current_step() < cfg.total_steps and not self._stop:
            step = self._current_step()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                batch = self.batch_fn(step)
                t0 = time.monotonic()
                self.state, metrics = self.step_fn(self.state, batch)
                _block_until_ready(metrics)
                dt = time.monotonic() - t0
                self._watch_stragglers(step, dt)
                self.metrics_log.append(
                    {"step": step, "dt": dt,
                     **{k: float(v) for k, v in metrics.items()}})
            except (FloatingPointError, RuntimeError, ValueError) as e:
                self.restarts += 1
                self.failures.append({"step": step, "error": repr(e)})
                if self.ckpt is None or self.restarts > cfg.max_restarts:
                    raise RuntimeError(
                        f"step {step} failed {self.restarts} times") from e
                self._restore()
                continue
            new_step = self._current_step()
            if new_step % cfg.ckpt_every == 0 or new_step >= cfg.total_steps:
                self._save(new_step)
        if self.ckpt is not None:
            self.ckpt.wait()
            if self._stop:  # preemption: persist progress before exit
                ckpt_lib.save_checkpoint(cfg.ckpt_dir, self._current_step(),
                                         self.state, cfg.keep)
        return self.state


class InjectedFault(RuntimeError):
    """Raised by test fault hooks to simulate node failure."""
