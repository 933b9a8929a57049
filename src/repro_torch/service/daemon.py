"""Long-running daemon mode: fault-tolerant watch-directory serve loop.

The port of ``repro.service.daemon``.  ``serve_daemon`` turns the one-shot
queue drain into a service that faces continuous traffic: clients drop
wire-schema JSONL files into an intake directory, the daemon batches each
round's arrivals through the ``SweepService`` scheduler (coalescing,
dedup, Eq. (3) fairness and the per-round tenant quota), and appends one
response line per request to the output file as each result completes.

The hardening contract:

* **malformed intake degrades per-line**: a bad JSON line, an unsupported
  schema version, or an oversized request gets a structured ``error``
  response at intake time; every other line in the file is still served;
* **engine failures degrade per-request**: a failing pass is retried with
  capped backoff inside the service and then reported as an ``engine``
  error response for exactly the requests it carried;
* **quotas bound tenants**: ``quota_rows`` meters any one requester's rows
  per round and ``fairness_rows`` applies Eq. (3) over cumulative served
  rows, so a flooding requester cannot stall a laggard beyond the
  fairness window;
* **state survives restarts**: the burned-state cache is persisted (npz +
  manifest, atomic rename) after every round that added rows, so a killed
  daemon's successor resumes from the burn-in work already paid for —
  responses stay bit-identical to an uninterrupted run;
* **SIGTERM flushes**: on SIGTERM/SIGINT the loop stops intake, force-
  drains every accepted request, flushes the responses, saves the cache,
  and exits 0.

Intake protocol: files matching ``*.jsonl`` in the intake directory are
processed in sorted-name order and renamed to ``<name>.done`` at the end
of the round that read them (drop files via write-to-temp + rename to
avoid partial reads).  A file whose round was cut short by a crash keeps
its name and is simply re-processed on restart — deterministic request
ids and the result/state caches make re-processing idempotent.  Responses
are appended to ``out_path`` as they complete (not in intake order;
correlate by ``request_id``), flushed line by line.

**On a process mesh** (a service built with ``mesh=``, one per rank, as
``python -m repro_torch.service serve --mesh`` starts them) every rank
runs this loop on the same intake and must make the same calls, or the
ranks post mismatched collectives and hang.  So each round, rank 0 alone
lists the intake (after ``max_files_per_round``) and reads its own signal
state, and broadcasts the file list and the stop flag on a gloo side
group; the rest follow.  Rank 0 alone writes the responses, the state
cache, the metrics and the trace, and renames the round's files only
after a barrier at the round's end, when every rank has read them.  The
idle exit and ``crash_after_passes`` then decide alike on every rank,
since the pass counts and the scheduler state are equal everywhere.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import sys
import time
from contextlib import nullcontext

from ..obs import Telemetry, write_snapshot
from ..obs.trace import TraceRecorder, current_tracer, set_tracer
from .wire import (DEFAULT_MAX_LINE_BYTES, WireError, encode_error,
                   encode_response, read_queue)

__all__ = ["DaemonConfig", "serve_daemon"]


@dataclasses.dataclass
class DaemonConfig:
    """Knobs of the serve loop (service-level knobs live on SweepService).

    Attributes:
      intake_dir: directory watched for ``*.jsonl`` request files.
      out_path: responses JSONL, append-mode, flushed per line.
      state_cache_path: persist the burned-state cache here (None = off).
      poll_interval_s: sleep between idle rounds.
      max_line_bytes: intake cap; longer lines get ``oversize`` errors.
      max_files_per_round: intake meter — at most this many request files
        are consumed per round (None = all available), bounding how long
        early arrivals wait behind a deep backlog before their first pass.
      idle_exit_rounds: exit cleanly after this many consecutive rounds
        with no intake, no passes, and nothing pending (None = run until
        signalled — the production mode).
      max_rounds: hard round cap (None = unbounded); a backstop for tests.
      crash_after_passes: fault injection for the crash/restart tests —
        hard-exit (``os._exit(70)``) at the end of the first round in
        which the service has executed at least this many passes, *after*
        responses and state cache hit disk.  None = disabled.
      metrics_dir: live exposition — after every busy round (and at exit)
        the telemetry registry is snapshotted into ``metrics.json`` +
        ``metrics.prom`` here, atomically.  None = no exposition.
      trace_path: record a span per round and per coalesced pass, and the
        library's spans below them (the tracer is the ambient one while
        the loop runs), and save the Chrome-trace JSON here at exit
        (including right before a ``crash_after_passes`` hard exit).
        None = no tracing.
    """

    intake_dir: str
    out_path: str
    state_cache_path: str | None = None
    poll_interval_s: float = 0.25
    max_line_bytes: int = DEFAULT_MAX_LINE_BYTES
    max_files_per_round: int | None = None
    idle_exit_rounds: int | None = None
    max_rounds: int | None = None
    crash_after_passes: int | None = None
    metrics_dir: str | None = None
    trace_path: str | None = None


def _intake_files(cfg: DaemonConfig) -> list[str]:
    """This round's request files: sorted, metered, never the output."""
    out_abs = os.path.abspath(cfg.out_path)
    names = []
    for name in sorted(os.listdir(cfg.intake_dir)):
        if not name.endswith(".jsonl"):
            continue
        path = os.path.join(cfg.intake_dir, name)
        if os.path.abspath(path) == out_abs:
            continue
        names.append(path)
    if cfg.max_files_per_round is not None:
        names = names[:cfg.max_files_per_round]
    return names


class _Ranks:
    """Round decisions of the ranks of a mesh: rank 0 decides, all follow.

    ``side`` is a gloo group over every rank, made for the daemon's host
    objects whatever backend the mesh's tensors use.
    """

    def __init__(self):
        import torch.distributed as dist
        self._dist = dist
        self.rank = dist.get_rank()
        self.side = dist.new_group(backend="gloo")

    def decide(self, files: list[str], sig):
        obj = [files, sig]
        self._dist.broadcast_object_list(obj, src=0, group=self.side)
        return obj[0], obj[1]

    def barrier(self) -> None:
        self._dist.barrier(group=self.side)


def serve_daemon(cfg: DaemonConfig, *, service=None, log=None
                 ) -> "ServiceStats":
    """Run the watch-directory serve loop until signalled (or idle-exited).

    Returns the final :class:`~.api.ServiceStats`.  ``service`` defaults to
    a fresh :class:`~.api.SweepService` on the GPU; pass one to set device
    / mesh / quota / retry knobs.  ``log`` is a callable for one-line
    progress messages (default: stderr, rank 0 only on a mesh).
    """
    from .api import ServiceStats, SweepService  # noqa: F401 (return type)
    if service is None:
        service = SweepService()
    ranks = _Ranks() if service.mesh is not None else None
    writer = ranks is None or ranks.rank == 0
    if log is None:
        def log(msg):
            if writer:
                print(f"[repro_torch.service.daemon] {msg}", file=sys.stderr,
                      flush=True)

    # telemetry: reuse the service's bundle if it has one; otherwise build
    # whatever the exposition config needs (registry always, tracer only
    # when a trace is requested)
    tel = service.telemetry
    if tel is None and (cfg.metrics_dir or cfg.trace_path):
        tel = Telemetry(tracer=TraceRecorder() if cfg.trace_path else None)
        service.attach_telemetry(tel)
    elif tel is not None and cfg.trace_path and tel.tracer is None:
        tel.tracer = TraceRecorder()
    if tel is not None:
        rounds_total = tel.registry.counter(
            "repro_daemon_rounds", "serve-loop rounds completed")
        phase_seconds = tel.registry.histogram(
            "repro_daemon_phase_seconds",
            "daemon round phases: intake, flush, save "
            "(schedule/engine live in repro_service_phase_seconds)",
            unit="s")

    def save_metrics() -> None:
        if writer and tel is not None and cfg.metrics_dir:
            write_snapshot(tel.registry, cfg.metrics_dir)

    def save_trace() -> None:
        if writer and tel is not None and tel.tracer is not None \
                and cfg.trace_path:
            tel.tracer.save(cfg.trace_path)

    os.makedirs(cfg.intake_dir, exist_ok=True)
    if cfg.state_cache_path and os.path.exists(cfg.state_cache_path):
        n = service.state_cache.load(cfg.state_cache_path)
        log(f"state cache: restored {n} burned row(s) from "
            f"{cfg.state_cache_path}" if n else
            f"state cache: {cfg.state_cache_path} unusable or empty, "
            f"starting cold")

    stop = {"sig": None}

    def _on_signal(signum, frame):
        stop["sig"] = signum

    old_handlers = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            old_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:          # not the main thread: rely on the caller
            pass

    out_fh = open(cfg.out_path if writer else os.devnull, "a")

    def emit(obj: dict) -> None:
        out_fh.write(json.dumps(obj) + "\n")
        out_fh.flush()

    service.on_response = lambda resp: emit(encode_response(resp))

    def save_cache() -> None:
        if writer and cfg.state_cache_path and service.state_cache.dirty:
            service.state_cache.save(cfg.state_cache_path)

    prev_tracer = current_tracer()
    if tel is not None and tel.tracer is not None:
        set_tracer(tel.tracer)      # the engine's spans join the trace
    rounds = idle = 0
    try:
        while True:
            files = _intake_files(cfg) if writer else []
            sig = stop["sig"]
            if ranks is not None:
                files, sig = ranks.decide(files, sig)
            if sig is not None:
                break
            rounds += 1
            prev = service.stats.snapshot()
            rspan = (tel.spans("round", cat="daemon",
                               args={"round": rounds})
                     if tel is not None else nullcontext())
            with rspan as sp:
                t0 = time.perf_counter()
                n_files = 0
                for path in files:
                    if ranks is None and stop["sig"] is not None:
                        break       # stop intake immediately on signal
                    n_files += 1
                    for item in read_queue(
                            path, max_line_bytes=cfg.max_line_bytes):
                        err = item.error
                        if err is None:
                            try:
                                service.submit(item.spec,
                                               requester=item.requester)
                                continue
                            except Exception as e:  # e.g. no service mesh
                                err = WireError(
                                    "reject", f"{type(e).__name__}: {e}",
                                    lineno=item.lineno,
                                    requester=item.requester)
                        service.stats.n_errors += 1
                        emit(encode_error(err))
                if tel is not None:
                    phase_seconds.observe(time.perf_counter() - t0,
                                          phase="intake")
                t0 = time.perf_counter()
                service.flush_ready()  # dedup/result hits: answer now
                if tel is not None:
                    phase_seconds.observe(time.perf_counter() - t0,
                                          phase="flush")
                n_passes = service.step(force=False)
                t0 = time.perf_counter()
                save_cache()
                if tel is not None:
                    phase_seconds.observe(time.perf_counter() - t0,
                                          phase="save")
                if sp is not None:
                    sp.args.update(n_files=n_files, n_passes=n_passes)
            if ranks is not None:
                ranks.barrier()     # every rank has read this round's files
            if writer:
                for path in files[:n_files]:
                    os.replace(path, path + ".done")
            busy = n_files or n_passes or service.n_unserved \
                or service.scheduler.n_pending
            if tel is not None:
                rounds_total.inc()
            if busy:
                # per-round *rates* (stats.diff vs the round-start
                # snapshot), not the ever-growing lifetime totals
                d = service.stats.diff(prev)
                log(f"round {rounds}: +{d.n_requests} request(s) "
                    f"(+{d.n_deduped} dedup), {n_passes} pass(es), "
                    f"+{d.rows_computed} rows computed, "
                    f"+{d.rows_from_state_cache} from state cache, "
                    f"+{d.n_errors} error(s)")
                save_metrics()
            if cfg.crash_after_passes is not None and \
                    service.stats.n_passes >= cfg.crash_after_passes:
                out_fh.flush()
                os.fsync(out_fh.fileno())
                save_metrics()
                save_trace()
                log(f"fault injection: crashing after "
                    f"{service.stats.n_passes} pass(es)")
                if ranks is not None:
                    ranks.barrier()   # rank 0's files are on disk
                os._exit(70)
            idle = 0 if busy else idle + 1
            if cfg.idle_exit_rounds is not None \
                    and idle >= cfg.idle_exit_rounds:
                log(f"idle for {idle} round(s), exiting")
                break
            if cfg.max_rounds is not None and rounds >= cfg.max_rounds:
                log(f"round cap {cfg.max_rounds} reached, exiting")
                break
            if not busy:
                time.sleep(cfg.poll_interval_s)
        if sig is not None:
            log(f"signal {sig}: flushing in-flight work")
        # clean shutdown: everything accepted gets its response flushed
        while service.n_unserved:
            service.step(force=True)
        save_cache()
        save_metrics()
        save_trace()
        s = service.stats
        log(f"served {s.n_requests} request(s), {s.n_errors} error(s), "
            f"{s.n_passes} pass(es), {s.rows_from_state_cache} rows from "
            f"state cache over {rounds} round(s)")
        return s
    finally:
        set_tracer(prev_tracer)
        out_fh.close()
        for sig_, handler in old_handlers.items():
            signal.signal(sig_, handler)
