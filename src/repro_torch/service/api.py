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

A pass runs on the service's ``device`` (``None`` is the GPU, or the
mesh's device).  ``backend="sharded"`` requests need a service built with
``mesh=`` (every rank of the mesh runs the same service on the same
queue): they are planned by ``plan_mesh_sweep``, and a pass whose rows do
not fill the ensemble extent is padded with ``Δ = inf`` rows on trial
indices ``-1 - i`` (wrapping mod ``2**32``), sliced off before any
reduction.

With a ``telemetry=`` bundle (:class:`repro_torch.obs.Telemetry`) the
service mirrors its stats into live metrics under ``repro.service``'s
names, observes the paper's observables (⟨u⟩, ⟨w²⟩, GVT rate, window
occupancy) per pass, and, with a tracer, emits one ``pass`` span per
:class:`~.scheduler.PackedPass`.  Spans below it name the service's and
the state cache's work (``service.schedule``, ``service.reduce``,
``service.flush``, ``service.observe``; ``state_cache.lookup``,
``.put``, ``.assemble``, and ``.to_host`` and ``.to_device`` around the
rows that cross between the cache's tiers); they go to the telemetry's
tracer and to a recording torch profiler, and none synchronizes the
device.  Strictly off-path: the instruments read
only host values a pass has already made (its numpy stats block,
``ServiceStats``, the scheduler's ledgers), and post no collective, so
responses are bit-identical with or without it, on one device and on
every rank of a mesh.
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
from ..core.ensemble import sync_if_traced
from ..core.horizon import PDESConfig, SimState, StepStats
from ..device import resolve_device
from ..experiments.sweep import (SweepResult, WindowSweep, _derive_dist,
                                 _round_up, ens_extent, plan_mesh_sweep,
                                 records_from_reduction, spec_to_dict)
from ..kernels import pdes_multistep
from ..kernels.tiling import ring_plan
from ..obs.trace import span_on
from .scheduler import BatchScheduler, CompatKey, GridJob, PackedPass
from .state_cache import StateCache, index_on

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

    def snapshot(self) -> "ServiceStats":
        """A copy of the current totals.

        Take one at a round boundary, then ``diff`` against it after: the
        daemon's round log reports per-round rates this way instead of
        ever-growing lifetime totals.
        """
        return dataclasses.replace(self)

    def diff(self, prev: "ServiceStats") -> "ServiceStats":
        """Field-wise ``self - prev``: the work done since ``prev``."""
        return ServiceStats(**{
            f.name: getattr(self, f.name) - getattr(prev, f.name)
            for f in dataclasses.fields(self)})


@dataclasses.dataclass
class _PendingRequest:
    request: SweepRequest
    cached: bool                  # True -> served from the result cache


# paper observables live in known ranges: u / rate are fractions of a step,
# occupancy is Δτ/Δ in [0, ~1]; w2 spans decades with L, so octave buckets
_FRACTION_BUCKETS = (0.05, 0.1, 0.15, 0.2, 0.25, 0.3, 0.4, 0.5,
                     0.6, 0.7, 0.8, 0.9, 1.0)
_W2_BUCKETS = (0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0,
               128.0, 256.0)


class _ServiceInstruments:
    """The service's metric handles, bound to one registry.

    Names, kinds, units, buckets and help texts are ``repro.service``'s,
    so either package's snapshot reads the same to a scraper.
    """

    def __init__(self, registry):
        h, c, g = registry.histogram, registry.counter, registry.gauge
        # -- the paper's own observables, live per coalesced pass
        self.pass_u = h("repro_pass_u",
                        "per-pass mean utilization <u> (fraction of PEs "
                        "advancing; Figs. 2/5/6)", unit="fraction",
                        buckets=_FRACTION_BUCKETS)
        self.pass_w2 = h("repro_pass_w2",
                         "per-pass mean horizon width <w^2> (Eq. 4, "
                         "Fig. 9)", unit="tau^2", buckets=_W2_BUCKETS)
        self.pass_rate = h("repro_pass_gvt_rate",
                           "per-pass mean GVT progress rate (Sec. V)",
                           unit="tau_per_step", buckets=_FRACTION_BUCKETS)
        self.pass_occupancy = h(
            "repro_pass_window_occupancy",
            "per-pass mean horizon spread over window width, "
            "<max tau - min tau>/Delta (Eq. 3 slack)", unit="fraction",
            buckets=_FRACTION_BUCKETS)
        self.pass_rows = h("repro_pass_rows",
                           "union rows per coalesced pass", unit="rows",
                           buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256,
                                    512, 1024, 2048, 4096))
        # -- service health: ServiceStats mirrored as counters
        self.totals = {
            "n_requests": c("repro_service_requests",
                            "requests accepted (post-idempotence)"),
            "n_deduped": c("repro_service_dedup_hits",
                           "requests served without new jobs"),
            "n_passes": c("repro_service_passes",
                          "coalesced measurement passes executed"),
            "n_engine_calls": c("repro_service_engine_calls",
                                "engine invocations (burn + measure)"),
            "n_errors": c("repro_service_errors",
                          "requests answered with an error response"),
            "n_retries": c("repro_service_engine_retries",
                           "engine-pass retries (capped backoff)"),
            "rows_requested": c("repro_service_rows_requested",
                                "request row counts, pre-dedup",
                                unit="rows"),
            "rows_computed": c("repro_service_rows_computed",
                               "union rows measured on-device",
                               unit="rows"),
            "rows_burned": c("repro_service_rows_burned",
                             "rows burned on-device (cache misses)",
                             unit="rows"),
            "rows_from_state_cache": c(
                "repro_service_rows_from_state_cache",
                "measurement rows whose burn-in was reused", unit="rows"),
            "engine_row_steps": c("repro_service_engine_row_steps",
                                  "rows x steps over every engine call "
                                  "(the honest compute unit)",
                                  unit="row_steps"),
            "state_cache_hits": c("repro_service_state_cache_hits",
                                  "burned-state cache row hits"),
            "state_cache_misses": c("repro_service_state_cache_misses",
                                    "burned-state cache row misses"),
            "state_cache_evictions": c(
                "repro_service_state_cache_evictions",
                "burned-state cache rows evicted (max_rows pressure)"),
        }
        self.fairness_throttles = c(
            "repro_service_fairness_throttles",
            "jobs deferred by the Eq. (3) fairness window")
        self.quota_throttles = c(
            "repro_service_quota_throttles",
            "jobs deferred by the per-round requester quota")
        self.served_rows = c("repro_service_served_rows",
                             "rows served, per requester", unit="rows")
        self.queue_depth = g("repro_service_queue_depth",
                             "grid jobs pending in the scheduler",
                             unit="jobs")
        self.coalescing_ratio = g(
            "repro_service_coalescing_ratio",
            "rows_requested / rows_computed — dedup + row-sharing win",
            unit="ratio")
        self.state_cache_rows = g("repro_service_state_cache_rows",
                                  "burned rows currently cached",
                                  unit="rows")
        self.phase_seconds = h("repro_service_phase_seconds",
                               "service step phases: schedule (take) and "
                               "engine (pass execution)", unit="s")


#: a ``pass`` span's args from the state cache's counters: its share of
#: the bytes that crossed between the tiers, and of the rows served from
#: the device tier, promoted and demoted
_CACHE_ARGS = {"state_bytes_to_host": "bytes_to_host",
               "state_bytes_to_device": "bytes_to_device",
               "rows_from_device_cache": "device_hits",
               "rows_promoted": "promotions", "rows_demoted": "demotions"}
#: ``pass`` span arguments of the fused path: the pass's growth in each
#: counter of ``kernels.pdes_multistep``
_B1_ARGS = {"b1_offchip_bytes": "offchip_bytes",
            "b1_block_chunks": "block_chunks", "b1_sm_chunks": "sm_chunks"}


def _cache_budget(device: torch.device) -> int | None:
    """Device bytes for the burned-state cache's rows: an eighth of a
    card's memory; None (unbounded) on the CPU, where the device is the
    host."""
    if device.type != "cuda":
        return None
    return torch.cuda.get_device_properties(device).total_memory // 8


class SweepService:
    """Batched request/response front end over the sweep engine.

    Args:
      device: where every pass runs; ``None`` is the GPU (raises without
        CUDA) or the mesh's device, ``"cpu"`` the plain PyTorch path.
      mesh / dist: the process mesh (and optional ``DistConfig``) of
        ``backend="sharded"`` requests.
      max_batch_rows / max_wait_rounds / fairness_rows / quota_rows:
        admission control, see :class:`~.scheduler.BatchScheduler`.
      state_cache_rows: LRU bound of the burned-state cache, in rows.
      engine_retries / retry_base_s / retry_cap_s: a failing pass is
        retried with capped exponential backoff; one that still fails is
        answered per request with a structured ``engine`` error.
      telemetry: an optional :class:`repro_torch.obs.Telemetry` bundle
        (live metrics, and a ``pass`` span per pass when it carries a
        tracer); responses are bit-identical with or without it.

    ``submit`` registers a request; ``step`` runs one scheduling round;
    ``drain`` forces everything through and returns responses in
    submission order.  Setting ``on_response`` streams every response
    through the callback as soon as it is ready.

    The burned-state cache keeps its rows on ``device`` (a card gives it
    an eighth of its memory; on the CPU it is unbounded) in front of a
    host tier.  ``state_bytes_to_host`` and ``state_bytes_to_device``
    total the bytes that cross between the two (demotions and ``save``
    down, promotions up); each ``pass`` span carries its pass's share and
    its rows from the device tier, promoted and demoted, and, on the
    fused path, B1's tier (``b1_tier``), the bytes of tau its launches
    read and wrote in device memory on the stream tier
    (``b1_offchip_bytes``, counted from the plan), and on a split ring the
    block-steps its launches ran and the SM-steps of the card they held
    (``b1_block_chunks``, ``b1_sm_chunks``: their growth in
    ``pdes_multistep.block_chunks`` and ``sm_chunks``).
    """

    def __init__(self, *, device=None, mesh=None, dist=None,
                 max_batch_rows: int = 4096,
                 max_wait_rounds: int = 0, fairness_rows: float = math.inf,
                 quota_rows: float = math.inf, state_cache_rows: int = 65536,
                 engine_retries: int = 0, retry_base_s: float = 0.05,
                 retry_cap_s: float = 2.0, telemetry=None):
        self.device = resolve_device(device, mesh)
        self.mesh = mesh
        self.dist = dist
        self.scheduler = BatchScheduler(max_batch_rows=max_batch_rows,
                                        max_wait_rounds=max_wait_rounds,
                                        fairness_rows=fairness_rows,
                                        quota_rows=quota_rows)
        self.state_cache = StateCache(max_rows=state_cache_rows,
                                      device=self.device,
                                      budget_bytes=_cache_budget(self.device))
        self.stats = ServiceStats()
        self.engine_retries = engine_retries
        self.retry_base_s = retry_base_s
        self.retry_cap_s = retry_cap_s
        self.attach_telemetry(telemetry)
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

    def attach_telemetry(self, telemetry) -> None:
        """Attach (or detach, with None) a ``repro_torch.obs.Telemetry``."""
        self.telemetry = telemetry
        self._ins = (None if telemetry is None
                     else _ServiceInstruments(telemetry.registry))
        self.state_cache.tracer = (None if telemetry is None
                                   else telemetry.tracer)

    @property
    def state_bytes_to_host(self) -> int:
        return self.state_cache.bytes_to_host

    @property
    def state_bytes_to_device(self) -> int:
        return self.state_cache.bytes_to_device

    def _span(self, name: str, args: dict | None = None):
        """A span on the telemetry's tracer and a recording profiler."""
        tracer = None if self.telemetry is None else self.telemetry.tracer
        return span_on(tracer, name, cat="service", args=args)

    # -- request intake ----------------------------------------------------

    def submit(self, spec: WindowSweep, requester: str = "anon"
               ) -> SweepRequest:
        """Register a sweep request; returns its deterministic id."""
        spec = canonicalize_spec(spec)
        if spec.backend == "sharded" and self.mesh is None:
            raise ValueError(
                "backend='sharded' requests need a service mesh: "
                "construct SweepService(mesh=...)")
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
        if spec.backend == "sharded":
            points = [(p.L, p.n_v, p.trial_base, p.burn_in)
                      for p in plan_mesh_sweep(spec, self.mesh, self.dist)]
        else:
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
        ins = self._ins
        t0 = time.perf_counter() if ins is not None else 0.0
        with self._span("service.schedule"):
            active = self.scheduler.pending_requesters
            served = {r: n for r, n in self._served_rows.items()
                      if r in active}
            passes = self.scheduler.take(served, force=force)
        if ins is not None:
            ins.phase_seconds.observe(time.perf_counter() - t0,
                                      phase="schedule")
            t0 = time.perf_counter()
        for p in passes:
            self._run_pass(p)
        if ins is not None and passes:
            ins.phase_seconds.observe(time.perf_counter() - t0,
                                      phase="engine")
        self._sync_cache_stats()
        self._sync_metrics()
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
        with self._span("service.flush"):
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
        self._sync_metrics()
        return out

    def _sync_cache_stats(self) -> None:
        self.stats.state_cache_hits = self.state_cache.hits
        self.stats.state_cache_misses = self.state_cache.misses
        self.stats.state_cache_evictions = self.state_cache.evictions

    def _sync_metrics(self) -> None:
        """Mirror the stats ledgers into the attached metrics registry.

        ``set_total`` (not ``inc``): ``ServiceStats`` and the scheduler
        already accumulate; the registry is a read-out, never a second
        ledger that could drift.
        """
        ins = self._ins
        if ins is None:
            return
        with self._span("service.observe"):
            stats = self.stats.as_dict()
            for field, counter in ins.totals.items():
                counter.set_total(stats[field])
            ins.fairness_throttles.set_total(
                self.scheduler.fairness_deferrals)
            ins.quota_throttles.set_total(self.scheduler.quota_deferrals)
            for requester, rows in self._served_rows.items():
                ins.served_rows.set_total(rows, requester=requester)
            ins.queue_depth.set(self.scheduler.n_pending)
            ins.coalescing_ratio.set(
                self.stats.rows_requested / max(self.stats.rows_computed, 1))
            ins.state_cache_rows.set(len(self.state_cache))

    # -- one coalesced pass -----------------------------------------------

    def _engine(self, key: CompatKey) -> PDESEngine:
        cfg = PDESConfig(L=key.L, n_v=key.n_v, delta=math.inf,
                         rd_mode=key.rd_mode, border_both=key.border_both)
        sharded = key.backend == "sharded"
        return PDESEngine(cfg, backend=key.backend, window=key.window,
                          k_fuse=key.k_fuse, device=self.device,
                          mesh=self.mesh if sharded else None,
                          dist=self.dist if sharded else None)

    def _ens_extent(self, key: CompatKey) -> int:
        if key.backend != "sharded":
            return 1
        dist = self.dist
        if dist is None:
            dist = _derive_dist(WindowSweep(window=key.window,
                                            k_fuse=key.k_fuse))
        return ens_extent(self.mesh, dist)

    def _pad_rows(self, key: CompatKey, trials, deltas):
        """Pad to the ensemble extent: ``Δ = inf`` rows on trials
        ``-1 - i``, out of band of every real row's stream."""
        n_pad = _round_up(len(trials), self._ens_extent(key)) - len(trials)
        trials = np.concatenate([trials, -1 - np.arange(n_pad)])
        deltas = np.concatenate([deltas, np.full(n_pad, np.inf, np.float32)])
        return (torch.as_tensor(trials, dtype=torch.int64, device=self.device),
                torch.as_tensor(deltas, device=self.device), n_pad)

    def _execute(self, p: PackedPass) -> None:
        key = p.key
        eng = self._engine(key)
        B = p.n_rows
        trials = np.fromiter((t for t, _ in p.rows), np.int64, B)
        deltas = np.fromiter((d for _, d in p.rows), np.float32, B)
        tvec, drows, n_pad = self._pad_rows(key, trials, deltas)
        args = None if self.telemetry is None else dict(
            dataclasses.asdict(key), n_rows=B, n_pad=n_pad,
            n_jobs=len(p.jobs),
            requesters=sorted({j.requester for j in p.jobs}))
        fused = key.backend == "pallas_multistep"
        if args is not None and fused:
            args["b1_tier"] = ring_plan(key.L).tier
        with self._span("pass", args=args) as sp:
            pre_b1 = {arg: getattr(pdes_multistep, c)
                      for arg, c in _B1_ARGS.items()}
            cache = self.state_cache
            pre_cached = self.stats.rows_from_state_cache
            pre_burned = self.stats.rows_burned
            pre = {arg: getattr(cache, c) for arg, c in _CACHE_ARGS.items()}
            state = self._burned_state(eng, key, p.rows, n_pad, trials,
                                       deltas)
            _, stats = eng.run(state, key.seed, key.n_steps, deltas=drows,
                               trial_base=tvec)
            sync_if_traced(sp, self.device)
            self.stats.n_passes += 1
            self.stats.n_engine_calls += 1
            self.stats.rows_computed += B
            self.stats.engine_row_steps += (B + n_pad) * key.n_steps
            if sp is not None:
                if fused:
                    sp.args.update({arg: getattr(pdes_multistep, c)
                                    - pre_b1[arg]
                                    for arg, c in _B1_ARGS.items()})
                sp.args.update(
                    rows_from_cache=(self.stats.rows_from_state_cache
                                     - pre_cached),
                    rows_burned=self.stats.rows_burned - pre_burned,
                    **{arg: getattr(cache, c) - pre[arg]
                       for arg, c in _CACHE_ARGS.items()})
            with self._span("service.reduce"):
                arrs = StepStats(*(measurement.to_numpy(a)[:, :B]
                                   for a in stats))
                if self._ins is not None:
                    with self._span("service.observe"):
                        self._observe_pass(p, arrs, deltas)
                for job, cols in zip(p.jobs, p.cols):
                    idx = np.asarray(cols, np.intp)
                    # fancy indexing yields F-ordered columns; numpy's
                    # axis-0 mean sums in a layout-dependent order, so
                    # restore C order to keep the reduction bit-identical
                    # to a direct (T, B) run
                    sliced = StepStats(*(np.ascontiguousarray(a[:, idx])
                                         for a in arrs))
                    red = measurement.sweep_reduce(
                        sliced, len(job.deltas), job.replicas,
                        steady_frac=job.steady_frac)
                    self._served_rows[job.requester] = (
                        self._served_rows.get(job.requester, 0)
                        + len(job.rows))
                    self._finish_job(job, red)

    def _observe_pass(self, p: PackedPass, arrs: StepStats,
                      deltas: np.ndarray) -> None:
        """Observe the paper observables from an already-made pass.

        Pure numpy over the (T, B) host stats block ``_execute`` built
        anyway — no GPU work, no effect on what any requester receives.
        """
        ins = self._ins
        ins.pass_u.observe(float(arrs.utilization.mean()))
        ins.pass_w2.observe(float(arrs.w2.mean()))
        ins.pass_rows.observe(float(p.n_rows))
        T = arrs.gvt.shape[0]
        if T > 1:
            rate = (arrs.gvt[-1] - arrs.gvt[0]) / (T - 1)
            ins.pass_rate.observe(float(rate.mean()))
        finite = np.isfinite(deltas)
        if finite.any():
            # horizon extent per row (spread = max_dev + min_dev, as in
            # measurement.sweep_reduce), over the width Δ that bounds it
            occ = (arrs.max_dev + arrs.min_dev).mean(axis=0)[finite] \
                / deltas[finite]
            ins.pass_occupancy.observe(float(occ.mean()))

    def _burned_state(self, eng: PDESEngine, key: CompatKey, rows,
                      n_pad: int, trials, deltas) -> SimState:
        """Assemble the post-burn-in state, reusing cached rows.

        Rows are independent rings, so cache-missing rows are burned in
        their own sub-pass (padded to the ensemble extent) and spliced next
        to cached rows — bit-identical to burning the whole batch.  The
        ``n_pad`` pad rows of the pass start from zero.  The splice stays
        on the device: the hits are gathered from the cache and the burned
        rows copied from the sub-pass into a fresh state, and only then
        are the burned rows put in the cache, since a put may evict rows
        of this very pass.  A pass that hit nothing takes the sub-pass's
        state as its own.
        """
        B = len(rows)
        if not key.burn:
            return eng.init(B + n_pad)
        cache = self.state_cache
        keys = [key.stream_key + r for r in rows]
        with self._span("state_cache.lookup"):
            found = cache.lookup(keys)
        missing = [i for i, f in enumerate(found) if not f]
        self.stats.rows_from_state_cache += B - len(missing)
        if missing:
            m_tvec, m_drows, m_pad = self._pad_rows(key, trials[missing],
                                                    deltas[missing])
            sub = eng.burn_in(eng.init(len(missing) + m_pad), key.seed,
                              key.burn, deltas=m_drows, trial_base=m_tvec)
            self.stats.n_engine_calls += 1
            self.stats.rows_burned += len(missing)
            self.stats.engine_row_steps += (len(missing) + m_pad) * key.burn
            burned = tuple(a.to(self.device) for a in sub[:3])
        with self._span("state_cache.assemble"):
            if len(missing) == B:        # the sub-pass's rows are the pass's
                arrays = burned
                for a in arrays:
                    a[B:] = 0
            else:
                arrays = (torch.zeros((B + n_pad, eng.cfg.L),
                                      dtype=torch.float32, device=self.device),
                          torch.zeros((B + n_pad,), dtype=torch.float32,
                                      device=self.device),
                          torch.zeros((B + n_pad,), dtype=torch.float32,
                                      device=self.device))
                hits = [i for i, f in enumerate(found) if f]
                cache.gather([keys[i] for i in hits], hits, *arrays)
                if missing:
                    idx = index_on(missing, self.device)
                    for dst, src in zip(arrays, burned):
                        dst.index_copy_(0, idx, src[:len(missing)])
        if missing:
            with self._span("state_cache.put"):
                cache.put_batch([keys[i] for i in missing],
                                *(a[:len(missing)] for a in burned))
        return SimState(*arrays, key.burn)

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
