"""Request/response core of the sweep service (port of ``repro.service.api``).

``SweepService`` accepts :class:`~repro_torch.experiments.sweep.WindowSweep`
specs from many requesters and multiplexes compatible requests into shared
engine passes:

* specs are canonicalized and fingerprinted; identical specs dedup onto one
  computation, and request ids are deterministic in ``(requester, spec)``;
* each (L, N_V) grid point becomes a :class:`~.scheduler.GridJob` whose
  rows are the exact ``(trial, Δ)`` coordinates ``run_window_sweep`` would
  use, so a coalesced pass returns, for every request, rows bit-identical
  to a direct run of that request's spec (tests/test_torch_service.py);
* the packed pass feeds the engine the per-row ``deltas=`` column and the
  per-row ``trial_base=`` vector;
* burned-in states are cached row by row (:class:`~.state_cache.
  StateCache`) and reused across requests.

Single device: the pass runs on the service's ``device`` (``None`` is the
GPU).  Telemetry instruments and the sharded backend come with later
slices (ROADMAP, queue A, items A9 and A10).
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import time

import numpy as np
import torch

from ..core import measurement
from ..core.engine import PDESEngine
from ..core.horizon import PDESConfig, SimState, StepStats
from ..device import resolve_device
from ..experiments.sweep import (SweepResult, WindowSweep,
                                 records_from_reduction, spec_to_dict)
from .scheduler import BatchScheduler, CompatKey, GridJob, PackedPass
from .state_cache import StateCache

__all__ = ["SweepRequest", "SweepResponse", "ServiceStats", "SweepService",
           "canonicalize_spec", "spec_fingerprint"]


def canonicalize_spec(spec: WindowSweep) -> WindowSweep:
    """Field-normalized copy: tuples of python ints/floats, exact bools."""
    return dataclasses.replace(
        spec,
        Ls=tuple(int(x) for x in spec.Ls),
        n_vs=tuple(int(x) for x in spec.n_vs),
        deltas=tuple(float(x) for x in spec.deltas),
        replicas=int(spec.replicas),
        n_steps=int(spec.n_steps),
        burn_in=None if spec.burn_in is None else int(spec.burn_in),
        backend=str(spec.backend),
        window=str(spec.window),
        k_fuse=int(spec.k_fuse),
        rd_mode=bool(spec.rd_mode),
        border_both=bool(spec.border_both),
        steady_frac=float(spec.steady_frac),
        seed=int(spec.seed),
    )


def spec_fingerprint(spec: WindowSweep) -> str:
    """Deterministic hex id of a canonicalized spec (the dedup key)."""
    blob = json.dumps(spec_to_dict(canonicalize_spec(spec)), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class SweepRequest:
    """One accepted submission; ``request_id = sha256(requester, spec)``."""

    request_id: str
    requester: str
    spec: WindowSweep        # canonicalized
    fingerprint: str         # canonical-spec hash (shared across requesters)


@dataclasses.dataclass(frozen=True)
class SweepResponse:
    """One served request: exactly one of ``result``/``error`` is set."""

    request_id: str
    requester: str
    spec: WindowSweep | None
    result: SweepResult | None
    cached: bool
    error: dict | None = None


@dataclasses.dataclass
class ServiceStats:
    """Work accounting; ``engine_row_steps`` is the honest compute unit."""

    n_requests: int = 0
    n_deduped: int = 0            # served without creating any new jobs
    n_passes: int = 0             # coalesced measurement passes executed
    n_engine_calls: int = 0       # burn sub-passes + measurement passes
    n_errors: int = 0             # requests answered with an error response
    n_retries: int = 0            # engine-pass retries (capped backoff)
    rows_requested: int = 0       # sum of request row counts (pre-dedup)
    rows_computed: int = 0        # union rows measured on the device
    rows_burned: int = 0          # rows burned on the device (cache misses)
    rows_from_state_cache: int = 0
    engine_row_steps: int = 0
    state_cache_hits: int = 0
    state_cache_misses: int = 0
    state_cache_evictions: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class _PendingRequest:
    request: SweepRequest
    cached: bool                  # True -> served from the result cache


class SweepService:
    """Batched request/response front end over the sweep engine.

    Args:
      device: where every pass runs; ``None`` is the GPU (raises without
        CUDA), ``"cpu"`` the plain PyTorch path.
      max_batch_rows / max_wait_rounds / fairness_rows / quota_rows:
        admission control, see :class:`~.scheduler.BatchScheduler`.
      state_cache_rows: LRU bound of the burned-state cache, in rows.
      engine_retries / retry_base_s / retry_cap_s: a failing pass is
        retried with capped exponential backoff; one that still fails is
        answered per request with a structured ``engine`` error.

    ``submit`` registers a request; ``step`` runs one scheduling round;
    ``drain`` forces everything through and returns responses in
    submission order.  Setting ``on_response`` streams every response
    through the callback as soon as it is ready.
    """

    def __init__(self, *, device=None, max_batch_rows: int = 4096,
                 max_wait_rounds: int = 0, fairness_rows: float = math.inf,
                 quota_rows: float = math.inf, state_cache_rows: int = 65536,
                 engine_retries: int = 0, retry_base_s: float = 0.05,
                 retry_cap_s: float = 2.0):
        self.device = resolve_device(device)
        self.scheduler = BatchScheduler(max_batch_rows=max_batch_rows,
                                        max_wait_rounds=max_wait_rounds,
                                        fairness_rows=fairness_rows,
                                        quota_rows=quota_rows)
        self.state_cache = StateCache(max_rows=state_cache_rows)
        self.stats = ServiceStats()
        self.engine_retries = engine_retries
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self.on_response = None                           # streaming sink
        self._seq = 0
        self._pending: dict[str, _PendingRequest] = {}   # rid -> request
        self._order: list[str] = []                       # rids, FIFO
        self._results: dict[str, SweepResult] = {}        # fp -> result
        self._fp_specs: dict[str, WindowSweep] = {}       # fp -> spec
        self._fp_jobs_left: dict[str, int] = {}           # fp -> undone jobs
        self._fp_records: dict[str, dict] = {}            # fp -> {(L,nv): recs}
        self._fp_errors: dict[str, dict] = {}             # fp -> error body
        self._served_rows: dict[str, int] = {}            # requester -> rows

    # -- request intake ----------------------------------------------------

    def submit(self, spec: WindowSweep, requester: str = "anon"
               ) -> SweepRequest:
        """Register a sweep request; returns its deterministic id."""
        spec = canonicalize_spec(spec)
        if spec.backend == "sharded":
            raise NotImplementedError(
                "backend='sharded' requests need the sharded backend, which "
                "is not ported yet (ROADMAP, queue A, item A10)")
        fp = spec_fingerprint(spec)
        rid = hashlib.sha256(f"{requester}\n{fp}".encode()).hexdigest()[:16]
        req = SweepRequest(request_id=rid, requester=requester, spec=spec,
                           fingerprint=fp)
        if rid in self._pending:          # idempotent resubmission
            return self._pending[rid].request
        self.stats.n_requests += 1
        self.stats.rows_requested += (
            len(spec.Ls) * len(spec.n_vs) * spec.n_trajectories)
        cached = fp in self._results or fp in self._fp_jobs_left
        if cached:
            self.stats.n_deduped += 1
        else:
            # a fingerprint that previously *failed* is retried from scratch
            self._fp_errors.pop(fp, None)
            self._enqueue_jobs(req)
        self._pending[rid] = _PendingRequest(request=req, cached=cached)
        self._order.append(rid)
        return req

    def _enqueue_jobs(self, req: SweepRequest) -> None:
        spec = req.spec
        self._fp_specs[req.fingerprint] = spec
        self._fp_records[req.fingerprint] = {}
        points, base = [], 0
        for L in spec.Ls:
            for n_v in spec.n_vs:
                cfg = PDESConfig(L=int(L), n_v=int(n_v), delta=math.inf,
                                 rd_mode=spec.rd_mode,
                                 border_both=spec.border_both)
                points.append((int(L), int(n_v), base,
                               spec.burn_in_for(cfg)))
                base += spec.n_trajectories
        self._fp_jobs_left[req.fingerprint] = len(points)
        R = spec.replicas
        for L, n_v, base, burn in points:
            key = CompatKey(L=L, n_v=n_v, backend=spec.backend,
                            window=spec.window, k_fuse=spec.k_fuse,
                            rd_mode=spec.rd_mode,
                            border_both=spec.border_both, seed=spec.seed,
                            burn=burn, n_steps=spec.n_steps)
            rows = tuple((base + w * R + r, d)
                         for w, d in enumerate(spec.deltas)
                         for r in range(R))
            self.scheduler.enqueue(GridJob(
                fp=req.fingerprint, requester=req.requester, seq=self._seq,
                key=key, rows=rows, deltas=tuple(spec.deltas), replicas=R,
                steady_frac=spec.steady_frac))
            self._seq += 1

    # -- scheduling / execution -------------------------------------------

    def step(self, force: bool = False) -> int:
        """One scheduling round; returns the number of passes executed.

        Fairness sees only requesters with pending work.
        """
        active = self.scheduler.pending_requesters
        served = {r: n for r, n in self._served_rows.items() if r in active}
        passes = self.scheduler.take(served, force=force)
        for p in passes:
            self._run_pass(p)
        self._sync_cache_stats()
        return len(passes)

    def _run_pass(self, p: PackedPass) -> None:
        """Execute one pass with capped-backoff retries; on final failure,
        answer the pass's requests with ``engine`` errors instead of
        aborting the drain."""
        delay = self.retry_base_s
        for attempt in range(self.engine_retries + 1):
            try:
                self._execute(p)
                break
            except Exception as exc:  # noqa: BLE001 — degraded, not dead
                if attempt == self.engine_retries:
                    self._fail_pass(p, exc)
                    break
                self.stats.n_retries += 1
                time.sleep(min(delay, self.retry_cap_s))
                delay *= 2
        self.flush_ready()

    def _fail_pass(self, p: PackedPass, exc: Exception) -> None:
        body = {"code": "engine",
                "message": f"{type(exc).__name__}: {exc}"}
        fps = {job.fp for job in p.jobs}
        for fp in fps:
            self._fp_errors[fp] = body
            self._fp_jobs_left.pop(fp, None)
            self._fp_records.pop(fp, None)
        self.scheduler.drop_fps(fps)

    @property
    def n_unserved(self) -> int:
        """Accepted requests not yet answered (streamed or drained)."""
        return len(self._pending)

    def _response_for(self, rid: str) -> SweepResponse | None:
        """The finished response for ``rid``, or None if not ready."""
        pend = self._pending[rid]
        fp = pend.request.fingerprint
        if fp in self._results:
            return SweepResponse(
                request_id=rid, requester=pend.request.requester,
                spec=pend.request.spec, result=self._results[fp],
                cached=pend.cached)
        if fp in self._fp_errors:
            return SweepResponse(
                request_id=rid, requester=pend.request.requester,
                spec=pend.request.spec, result=None, cached=False,
                error=self._fp_errors[fp])
        return None

    def flush_ready(self) -> int:
        """Deliver every finished response through ``on_response``."""
        if self.on_response is None:
            return 0
        emitted = 0
        for rid in list(self._order):
            if rid not in self._pending:
                continue
            resp = self._response_for(rid)
            if resp is None:
                continue
            del self._pending[rid]
            if resp.error is not None:
                self.stats.n_errors += 1
            self.on_response(resp)
            emitted += 1
        if emitted:
            self._order = [r for r in self._order if r in self._pending]
        return emitted

    def drain(self) -> list[SweepResponse]:
        """Force everything through; responses in submission order."""
        while self.scheduler.n_pending:
            self.step(force=True)
        self.flush_ready()
        out = []
        for rid in self._order:
            if rid not in self._pending:
                continue
            resp = self._response_for(rid)
            if resp is None:
                raise RuntimeError(f"drained with unserved request {rid}")
            if resp.error is not None:
                self.stats.n_errors += 1
            out.append(resp)
        self._pending.clear()
        self._order.clear()
        self._sync_cache_stats()
        return out

    def _sync_cache_stats(self) -> None:
        self.stats.state_cache_hits = self.state_cache.hits
        self.stats.state_cache_misses = self.state_cache.misses
        self.stats.state_cache_evictions = self.state_cache.evictions

    # -- one coalesced pass -----------------------------------------------

    def _engine(self, key: CompatKey) -> PDESEngine:
        cfg = PDESConfig(L=key.L, n_v=key.n_v, delta=math.inf,
                         rd_mode=key.rd_mode, border_both=key.border_both)
        return PDESEngine(cfg, backend=key.backend, window=key.window,
                          k_fuse=key.k_fuse, device=self.device)

    def _execute(self, p: PackedPass) -> None:
        key = p.key
        eng = self._engine(key)
        B = p.n_rows
        trials = np.fromiter((t for t, _ in p.rows), np.int64, B)
        deltas = np.fromiter((d for _, d in p.rows), np.float32, B)
        drows = torch.as_tensor(deltas, device=self.device)
        tvec = torch.as_tensor(trials, device=self.device)
        state = self._burned_state(eng, key, p.rows, drows, tvec)
        _, stats = eng.run(state, key.seed, key.n_steps, deltas=drows,
                           trial_base=tvec)
        self.stats.n_passes += 1
        self.stats.n_engine_calls += 1
        self.stats.rows_computed += B
        self.stats.engine_row_steps += B * key.n_steps
        arrs = StepStats(*(measurement.to_numpy(a) for a in stats))
        for job, cols in zip(p.jobs, p.cols):
            idx = np.asarray(cols, np.intp)
            # fancy indexing yields F-ordered columns; numpy's axis-0 mean
            # sums in a layout-dependent order, so restore C order to keep
            # the reduction bit-identical to a direct (T, B) run
            sliced = StepStats(*(np.ascontiguousarray(a[:, idx])
                                 for a in arrs))
            red = measurement.sweep_reduce(
                sliced, len(job.deltas), job.replicas,
                steady_frac=job.steady_frac)
            self._served_rows[job.requester] = (
                self._served_rows.get(job.requester, 0) + len(job.rows))
            self._finish_job(job, red)

    def _burned_state(self, eng: PDESEngine, key: CompatKey, rows, drows,
                      tvec) -> SimState:
        """Assemble the post-burn-in state, reusing cached rows.

        Rows are independent rings, so cache-missing rows are burned in
        their own sub-pass and spliced next to cached rows — bit-identical
        to burning the whole batch.
        """
        B = len(rows)
        if not key.burn:
            return eng.init(B)
        skey = key.stream_key
        cached = [self.state_cache.get(skey + r) for r in rows]
        missing = [i for i, c in enumerate(cached) if c is None]
        self.stats.rows_from_state_cache += B - len(missing)
        if missing:
            m_idx = torch.as_tensor(missing, device=self.device)
            sub = eng.burn_in(eng.init(len(missing)), key.seed, key.burn,
                              deltas=drows[m_idx], trial_base=tvec[m_idx])
            self.stats.n_engine_calls += 1
            self.stats.rows_burned += len(missing)
            self.stats.engine_row_steps += len(missing) * key.burn
            tau_m, off_m, comp_m = (measurement.to_numpy(a) for a in
                                    (sub.tau, sub.offset, sub.offset_comp))
            self.state_cache.put_batch([skey + rows[i] for i in missing],
                                       tau_m, off_m, comp_m)
            for j, i in enumerate(missing):
                cached[i] = (tau_m[j], off_m[j], comp_m[j])
        tau = np.stack([c[0] for c in cached]).astype(np.float32, copy=False)
        off = np.asarray([c[1] for c in cached], np.float32)
        comp = np.asarray([c[2] for c in cached], np.float32)
        return SimState(*(torch.as_tensor(a, device=self.device)
                          for a in (tau, off, comp)), key.burn)

    # -- per-request assembly ---------------------------------------------

    def _finish_job(self, job: GridJob, red: dict) -> None:
        if job.fp in self._fp_errors:
            return        # a sibling pass already failed this fingerprint
        self._fp_records[job.fp][(job.key.L, job.key.n_v)] = \
            records_from_reduction(job.key.L, job.key.n_v, job.deltas, red)
        self._fp_jobs_left[job.fp] -= 1
        if self._fp_jobs_left[job.fp] == 0:
            spec = self._fp_specs[job.fp]
            records = []
            for L in spec.Ls:
                for n_v in spec.n_vs:
                    records.extend(
                        self._fp_records[job.fp][(int(L), int(n_v))])
            self._results[job.fp] = SweepResult(spec=spec,
                                                records=tuple(records))
            del self._fp_jobs_left[job.fp]
            del self._fp_records[job.fp]
