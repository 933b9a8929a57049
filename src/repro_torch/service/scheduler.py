"""Batching scheduler: coalesce compatible sweep requests into shared passes.

A copy of ``repro.service.scheduler`` (numpy only).  Pure packing logic: the
executable half of the service lives in ``api.py``.  The scheduler's job is deciding *which rows
run together*:

* **Compatibility keying** — two grid-point jobs may share a device pass iff
  they agree on everything that determines a row's trajectory and the pass
  shape: ``(L, N_V, backend, window, k_fuse, rd_mode, border_both, seed,
  burn, n_steps)`` (:class:`CompatKey`).  ``replicas``/``deltas``/
  ``steady_frac`` deliberately stay *out* of the key: they only shape which
  rows a request wants and how its slice is reduced.
* **Δ-grid union** — a row is a ``(trial_index, Δ)`` coordinate; the pass
  operand is the first-seen-ordered union of every job's rows, and each job
  keeps the column indices of *its* rows (:class:`PackedPass`).  Rows that
  two requests share (same trial block, same Δ) are computed once.
* **Admission control** — groups are released when forced, when they have
  waited ``max_wait_rounds`` scheduling rounds, or when they already fill a
  pass; released jobs are packed into passes of at most ``max_batch_rows``
  union rows (job granularity — an oversized job gets its own pass).
* **Fairness** — requesters are throttled by the paper's own moving-window
  rule, Eq. (3), reused verbatim: a requester's *served row count* plays the
  local virtual time τ, the minimum over requesters plays the GVT, and
  ``fairness_rows`` plays Δ — :func:`window_admission` decides who may enter
  the next pass.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["CompatKey", "GridJob", "PackedPass", "BatchScheduler",
           "window_admission"]


def window_admission(tau, delta, gvt):
    """The paper's Eq. (3) moving-window rule: ``tau <= delta + gvt``.

    Elementwise over arrays (returns a bool array) and exact on scalars
    (returns a bool): the PDES window rule it names, reused for requester
    fairness in this scheduler.
    """
    out = np.asarray(tau) <= delta + gvt
    return bool(out) if out.ndim == 0 else out


@dataclasses.dataclass(frozen=True)
class CompatKey:
    """Everything two jobs must agree on to share one device pass.

    The first eight fields pin a row's *trajectory* (the counter stream and
    update schedule); ``burn``/``n_steps`` pin the pass shape (one scalar
    step counter per pass).  ``stream_key`` drops ``n_steps`` — it is the
    burned-state cache key prefix (a burned state is reusable under any
    later measurement length).
    """

    L: int
    n_v: int
    backend: str
    window: str
    k_fuse: int
    rd_mode: bool
    border_both: bool
    seed: int
    burn: int
    n_steps: int

    @property
    def stream_key(self) -> tuple:
        return (self.L, self.n_v, self.backend, self.window, self.k_fuse,
                self.rd_mode, self.border_both, self.seed, self.burn)


@dataclasses.dataclass(frozen=True)
class GridJob:
    """One (request, L, N_V) grid point: the scheduling unit.

    ``rows`` is the job's (trial_index, Δ) coordinates in request order —
    window-major, replica-inner, exactly the layout ``run_window_sweep``
    assigns (``trial = grid_base + w * replicas + r``) — so slicing the
    job's columns out of a coalesced pass reproduces the standalone rows.
    """

    fp: str                  # canonical-spec fingerprint this job serves
    requester: str
    seq: int                 # submission order (fairness tiebreak)
    key: CompatKey
    rows: tuple              # ((trial, delta), ...) request-ordered
    deltas: tuple            # the job's Δ grid (n_windows values)
    replicas: int
    steady_frac: float


@dataclasses.dataclass(frozen=True)
class PackedPass:
    """One coalesced device pass: union rows + per-job column slices."""

    key: CompatKey
    jobs: tuple              # GridJobs served by this pass
    rows: tuple              # union (trial, delta) rows, first-seen order
    cols: tuple              # per-job tuple of column indices into ``rows``

    @property
    def n_rows(self) -> int:
        return len(self.rows)


def _pack(key: CompatKey, jobs, max_rows: int) -> list:
    """Greedy job-granular packing into passes of <= max_rows union rows."""
    passes, cur, seen = [], [], {}

    def flush():
        if cur:
            rows = tuple(seen)
            index = {r: i for i, r in enumerate(rows)}
            cols = tuple(tuple(index[r] for r in j.rows) for j in cur)
            passes.append(PackedPass(key=key, jobs=tuple(cur), rows=rows,
                                     cols=cols))
            cur.clear()
            seen.clear()

    for job in jobs:
        fresh = [r for r in job.rows if r not in seen]
        if cur and len(seen) + len(fresh) > max_rows:
            flush()
            fresh = job.rows
        for r in fresh:
            seen[r] = None
        cur.append(job)
    flush()
    return passes


class BatchScheduler:
    """Admission control + fairness + packing over pending :class:`GridJob`s.

    Args:
      max_batch_rows: union-row cap per coalesced pass.
      max_wait_rounds: how many ``take()`` rounds an under-filled compat
        group may defer, accumulating co-batchable requests, before it is
        released anyway (0 = release immediately).
      fairness_rows: the Δ of the requester-fairness window (Eq. (3) over
        served row counts); ``inf`` disables throttling.
      quota_rows: per-requester row budget *per scheduling round* — the
        tenant-layer Δ on top of the fairness window.  A requester whose
        admitted rows this round would exceed the quota has their remaining
        jobs deferred to later rounds (never rejected), so a flooding
        tenant is metered to ``quota_rows`` rows/round while laggards keep
        the fairness window's priority.  A single job larger than the quota
        is still released when it is the requester's first job of the round
        (quotas bound throughput, they must not deadlock a request).
        ``inf`` disables metering.
    """

    def __init__(self, *, max_batch_rows: int = 4096,
                 max_wait_rounds: int = 0,
                 fairness_rows: float = math.inf,
                 quota_rows: float = math.inf):
        if max_batch_rows < 1:
            raise ValueError("max_batch_rows must be >= 1")
        if max_wait_rounds < 0:
            raise ValueError("max_wait_rounds must be >= 0")
        if quota_rows < 1:
            raise ValueError("quota_rows must be >= 1")
        self.max_batch_rows = max_batch_rows
        self.max_wait_rounds = max_wait_rounds
        self.fairness_rows = fairness_rows
        self.quota_rows = quota_rows
        # lifetime throttle ledgers (jobs deferred, not rejected) — read by
        # the telemetry layer as repro_service_{fairness,quota}_throttles
        self.fairness_deferrals = 0
        self.quota_deferrals = 0
        self._pending: list[GridJob] = []
        self._waited: dict[CompatKey, int] = {}

    # -- queue state -------------------------------------------------------

    def enqueue(self, job: GridJob) -> None:
        self._pending.append(job)

    @property
    def n_pending(self) -> int:
        return len(self._pending)

    def pending_union_rows(self, key: CompatKey) -> int:
        rows = {r for j in self._pending if j.key == key for r in j.rows}
        return len(rows)

    @property
    def pending_requesters(self) -> set:
        """Requesters with at least one pending job (the active tenants)."""
        return {j.requester for j in self._pending}

    def drop_fps(self, fps) -> int:
        """Discard pending jobs serving any of the given fingerprints.

        Used when a fingerprint fails permanently: its sibling grid-point
        jobs can no longer contribute to a response.  Returns the number of
        jobs dropped.
        """
        fps = set(fps)
        before = len(self._pending)
        self._pending = [j for j in self._pending if j.fp not in fps]
        return before - len(self._pending)

    # -- one scheduling round ---------------------------------------------

    def _admitted(self, job: GridJob, served: dict) -> bool:
        if not served or math.isinf(self.fairness_rows):
            return True
        gvt = min(served.values())
        return window_admission(served.get(job.requester, 0),
                                self.fairness_rows, gvt)

    def take(self, served: dict | None = None,
             force: bool = False) -> list[PackedPass]:
        """Release ready compat groups and pack them into passes.

        ``served`` maps requester -> rows served so far (the fairness τ).
        Non-forced rounds hold back (a) under-filled groups that have not
        yet waited ``max_wait_rounds`` and (b) jobs whose requester the
        fairness window blocks; ``force=True`` releases everything
        (``drain`` semantics — every request is eventually served, the
        window only shapes the order).
        """
        served = served or {}
        by_key: dict[CompatKey, list[GridJob]] = {}
        for j in self._pending:
            by_key.setdefault(j.key, []).append(j)

        passes, released = [], []
        round_rows: dict[str, int] = {}    # per-round quota ledger
        for key, jobs in by_key.items():
            if not force:
                admitted = [j for j in jobs if self._admitted(j, served)]
                self.fairness_deferrals += len(jobs) - len(admitted)
                waited = self._waited.get(key, 0)
                full = self.pending_union_rows(key) >= self.max_batch_rows
                if not admitted or (waited < self.max_wait_rounds
                                    and not full):
                    self._waited[key] = waited + 1
                    continue
                jobs = admitted
            # fairness orders the pack: least-served requesters first
            jobs = sorted(jobs, key=lambda j: (served.get(j.requester, 0),
                                               j.seq))
            if not force and not math.isinf(self.quota_rows):
                kept = [j for j in jobs if self._within_quota(j, round_rows)]
                self.quota_deferrals += len(jobs) - len(kept)
                jobs = kept
                if not jobs:
                    continue           # whole group deferred by quota
            passes.extend(_pack(key, jobs, self.max_batch_rows))
            released.extend(jobs)
            self._waited.pop(key, None)
        taken = set(id(j) for j in released)
        self._pending = [j for j in self._pending if id(j) not in taken]
        return passes

    def _within_quota(self, job: GridJob, round_rows: dict) -> bool:
        used = round_rows.get(job.requester, 0)
        if used and used + len(job.rows) > self.quota_rows:
            return False
        round_rows[job.requester] = used + len(job.rows)
        return True
