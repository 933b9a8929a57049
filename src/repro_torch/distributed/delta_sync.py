"""Δ-window bounded-asynchrony for data-parallel training (port of
``repro.distributed.delta_sync``; numpy only, as the original).

Mapping (exact, not analogy):

* PE  ->  DP worker (or serve lane);  local virtual time tau_k = committed
  work (virtual seconds of useful step time);
* Eq. (3) moving window  ->  bounded staleness: worker k may commit a new
  contribution only while ``tau_k <= delta + GVT``, GVT = min_j tau_j;
* Δ = 0   -> fully synchronous SGD (lockstep all-reduce);
  Δ = inf -> unbounded asynchrony (hogwild-style);
* GVT is simultaneously the *consistent checkpoint frontier*: all work with
  virtual time <= GVT is globally committed, which is what makes the
  measurement phase (metrics, checkpoints) scalable — the paper's central
  scalability argument, applied to training.

Because DP workers have no nearest-neighbor causality constraint, the
scheduler is the paper's Δ-constrained *random-deposition* limit (Sec. IV.A):
its steady-state utilization is predicted by the paper's own fit
``core.theory.u_rd(delta)`` — verified in tests/test_torch_delta_sync.py.  That
curve is exactly the capacity-planning chart for a cluster with straggler
spread ~ Exp(1): pick Δ to trade progress-rate bound against memory bound.

The Eq. (3) predicate is not duplicated here: the gate is the port's
``service.scheduler.window_admission``, the one the sweep service uses
for requester fairness.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..service.scheduler import window_admission


@dataclasses.dataclass
class DeltaSyncConfig:
    n_workers: int
    delta: float = 4.0            # window, in units of mean step time
    seed: int = 0


class DeltaScheduler:
    """Host-side Δ-window scheduler over DP workers (numpy; O(L) per round).

    Each round, every eligible worker attempts one unit of work whose
    duration is supplied by the caller (measured wall-clock of its last step,
    or sampled Exp(1) in simulation).  Blocked workers idle — exactly the
    conservative update rule with the window constraint and no ring rule.
    """

    def __init__(self, cfg: DeltaSyncConfig):
        self.cfg = cfg
        self.tau = np.zeros(cfg.n_workers, dtype=np.float64)
        self._rng = np.random.default_rng(cfg.seed)
        self.rounds = 0
        self.committed = 0
        self.attempted = 0

    # ---- core update rule ----
    def offer(self, durations=None) -> np.ndarray:
        """One parallel round.  Returns bool mask of workers that committed.

        durations: per-worker step durations for this round (default Exp(1)).
        """
        cfg = self.cfg
        if durations is None:
            durations = self._rng.exponential(1.0, cfg.n_workers)
        durations = np.asarray(durations, dtype=np.float64)
        gvt = self.tau.min()
        # Eq. (3), RD limit — the one shared window predicate
        allowed = window_admission(self.tau, cfg.delta, gvt)
        self.tau = np.where(allowed, self.tau + durations, self.tau)
        self.rounds += 1
        self.committed += int(allowed.sum())
        self.attempted += cfg.n_workers
        return allowed

    # ---- observables ----
    @property
    def gvt(self) -> float:
        """Global virtual time == consistent checkpoint frontier."""
        return float(self.tau.min())

    @property
    def utilization(self) -> float:
        return self.committed / max(self.attempted, 1)

    @property
    def spread(self) -> float:
        """Horizon width — bounded by Δ + O(max step) by construction."""
        return float(self.tau.max() - self.tau.min())

    def staleness(self) -> np.ndarray:
        """Per-worker staleness tau_k - GVT; invariant: <= Δ + last step."""
        return self.tau - self.tau.min()

    def checkpoint_due(self, last_frontier: float, interval: float) -> bool:
        """True when the GVT has advanced past the next checkpoint frontier."""
        return self.gvt >= last_frontier + interval


def predicted_utilization(delta: float) -> float:
    """Paper Eq. (A.1): capacity-planning estimate for Exp(1) step times."""
    from ..core.theory import u_rd
    return float(u_rd(delta))


def gated_microbatch_weights(scheduler: DeltaScheduler, durations=None):
    """One round -> per-worker gradient weights for the lockstep emulation.

    In the single-program training loop we emulate the bounded-async cluster:
    each DP shard is a virtual worker; shards whose window rule blocks them
    this round contribute zero weight (their microbatch is deferred), and the
    loss is renormalized over committed workers.  Returns (weights, mask).
    """
    mask = scheduler.offer(durations)
    n = mask.sum()
    w = mask.astype(np.float64)
    if n > 0:
        w = w * (len(mask) / n)     # keep the gradient an unbiased average
    return w, mask
