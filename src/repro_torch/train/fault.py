"""Fault tolerance: checkpoint/restart, simulated node failure and
Δ-window straggler absorption (port of ``repro.train.fault``).

``FaultInjector`` raises ``SimulatedFailure`` at configured steps so the
recovery path is exercised end to end: the controller restores the last
consistent checkpoint (whose frontier is the Δ-scheduler's GVT) and
resumes; the data pipeline is counter-based, so the replayed batches are
the same.  The restore writes into the training state's own tensors (the
module's parameters among them).  The reference's restart onto another
mesh shape is, on one device, a restore onto another device
(``checkpoint.restore``).

Straggler mitigation is not a separate mechanism: it *is* the Δ-window
rule (``distributed/delta_sync.py``).
"""
from __future__ import annotations

import dataclasses
import pathlib

from . import checkpoint
from ..distributed.delta_sync import DeltaScheduler


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class FaultInjector:
    """Deterministic failure schedule for tests/examples."""

    fail_at_steps: tuple = ()
    _fired: set = dataclasses.field(default_factory=set)

    def check(self, step: int):
        if step in self.fail_at_steps and step not in self._fired:
            self._fired.add(step)
            raise SimulatedFailure(f"injected node failure at step {step}")


@dataclasses.dataclass
class RecoveryConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    keep: int = 3


class TrainController:
    """Run loop with checkpoint/restart and Δ-window scheduling.

    ``step_fn(state, batch) -> (state, metrics)`` is the train step;
    ``data_fn(step)`` gives batch ``step``; recovery restores the latest
    checkpoint into the state and replays the data stream.
    """

    def __init__(self, step_fn, init_state, data_fn, rc: RecoveryConfig,
                 scheduler: DeltaScheduler | None = None,
                 injector: FaultInjector | None = None):
        self.step_fn = step_fn
        self.state = init_state
        self.data_fn = data_fn
        self.rc = rc
        self.scheduler = scheduler
        self.injector = injector
        self.ckpt = checkpoint.AsyncCheckpointer()
        self.step = 0
        self.restarts = 0

    def _ckpt_path(self, step):
        return pathlib.Path(self.rc.ckpt_dir) / f"step_{step}"

    def save_now(self):
        self.ckpt.save(self.state, self._ckpt_path(self.step), step=self.step)
        self.ckpt.wait()

    def restore_latest(self):
        last = checkpoint.latest_step(self.rc.ckpt_dir)
        if last is None:
            self.step = 0
            return False
        self.state = checkpoint.restore(self._ckpt_path(last), self.state)
        self.step = last
        return True

    def run(self, n_steps: int, max_restarts: int = 10):
        metrics_log = []
        while self.step < n_steps:
            try:
                if self.injector is not None:
                    self.injector.check(self.step)
                batch = self.data_fn(self.step)
                self.state, metrics = self.step_fn(self.state, batch)
                self.step += 1
                if self.scheduler is not None:
                    self.scheduler.offer()
                metrics_log.append({k: float(v) for k, v in metrics.items()})
                if self.step % self.rc.ckpt_every == 0:
                    self.ckpt.save(self.state, self._ckpt_path(self.step),
                                   step=self.step)
            except SimulatedFailure:
                self.restarts += 1
                if self.restarts > max_restarts:
                    raise
                self.ckpt.wait()
                self.restore_latest()
        self.ckpt.wait()
        return metrics_log
