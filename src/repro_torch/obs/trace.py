"""Span tracing: Chrome-trace/Perfetto JSON emission with an ambient tracer.

A copy of ``repro.obs.trace`` (stdlib only), kept in the port so that it
imports nothing of ``repro``.

A :class:`TraceRecorder` collects completed spans as Chrome trace events
(``ph: "X"`` — complete events with microsecond ``ts``/``dur``) that load
directly into ``chrome://tracing`` / Perfetto.  The clock and pid are
injectable so golden-file tests can produce byte-stable traces; production
callers take the defaults (``time.perf_counter``, real pid).

Instrumented library code does not thread a recorder through every call —
it asks for the process-ambient tracer::

    from repro_torch.obs import trace

    with trace.span("burn", args={"n_burn": n_burn}):
        state = eng.burn_in(state, n_burn)

When no tracer is installed (:func:`set_tracer` never called, or called
with ``None``) and no torch profiler records, the :func:`span` helper is a
no-op costing one global lookup and one check of the profiler's state, so
the hot path stays clean for ordinary library users.  A harness that
wants a trace installs a recorder around its run and
:meth:`TraceRecorder.save`\\ s it at exit.

Every span has a second listener: while a ``torch.profiler`` records on
the calling thread, the span also enters
``torch.profiler.record_function(<name>)``, so it shows in the exported
trace as a ``user_annotation`` timed on the profiler's clock, beside the
host operations and the device work it launched.  The module imports no
torch: it looks the package up in ``sys.modules`` when a span opens (a
process that has not imported torch runs no profiler).  A span yields its
:class:`Span` only when a :class:`TraceRecorder` records it; a span that
only the profiler sees yields None, like the no-op.

Spans are strictly nested per thread (enter/exit discipline of ``with``).
Timing spans around asynchronously launched GPU work should only
synchronize when a tracer is live — see
``experiments.sweep.run_window_sweep`` — keeping untraced runs
asynchronous.
"""
from __future__ import annotations

import json
import os
import sys
import threading
import time

__all__ = ["TraceRecorder", "Span", "set_tracer", "current_tracer", "span",
           "span_on"]


class Span:
    """One in-flight span; mutate ``args`` to annotate before exit."""

    __slots__ = ("name", "cat", "args", "_t0", "_tid")

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args
        self._t0 = 0.0
        self._tid = 0


class TraceRecorder:
    """Collects spans and serializes them as Chrome trace JSON.

    ``clock`` must be a monotonic seconds source (default
    ``time.perf_counter``); timestamps in the output are microseconds
    relative to the recorder's construction.  ``pid`` defaults to the real
    process id and is injectable for reproducible goldens.  Thread-safe:
    each thread gets its own ``tid`` and its own nesting stack.
    """

    def __init__(self, clock=time.perf_counter, pid: int | None = None):
        self._clock = clock
        self._pid = os.getpid() if pid is None else int(pid)
        self._t0 = clock()
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._tids: dict[int, int] = {}
        self._local = threading.local()

    def _tid(self) -> int:
        ident = threading.get_ident()
        with self._lock:
            tid = self._tids.get(ident)
            if tid is None:
                tid = len(self._tids) + 1
                self._tids[ident] = tid
            return tid

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def span(self, name: str, cat: str = "repro", args: dict | None = None):
        """Context manager recording one complete event around its body.

        Yields the :class:`Span` so the body can add ``args`` entries that
        are only known mid-flight (row counts, cache provenance).  On an
        exception the span still closes, with ``args["error"]`` set to the
        exception type name, and the exception propagates.
        """
        return _SpanCtx(self, Span(name, cat, dict(args or {})))

    def _open(self, s: Span) -> None:
        s._t0 = self._clock()
        s._tid = self._tid()
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        stack.append(s)

    def _close(self, s: Span, exc: BaseException | None) -> None:
        t1 = self._clock()
        stack = getattr(self._local, "stack", [])
        if stack and stack[-1] is s:
            stack.pop()
        if exc is not None:
            s.args.setdefault("error", type(exc).__name__)
        ev = {"name": s.name, "cat": s.cat, "ph": "X",
              "ts": self._us(s._t0), "dur": round((t1 - s._t0) * 1e6, 3),
              "pid": self._pid, "tid": s._tid}
        if s.args:
            ev["args"] = s.args
        with self._lock:
            self._events.append(ev)

    @property
    def events(self) -> list[dict]:
        """Completed events, in completion order."""
        with self._lock:
            return list(self._events)

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    def to_dict(self) -> dict:
        """Chrome trace object: ``{"traceEvents": [...], ...}``."""
        return {"traceEvents": self.events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        """Atomically write the trace JSON (tmp+rename, fsync'd)."""
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            json.dump(self.to_dict(), fh, indent=1)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)


_profiler_enabled = None        # torch's per-thread check, once imported


def _profiling() -> bool:
    """Whether a torch profiler records on the calling thread."""
    global _profiler_enabled
    enabled = _profiler_enabled
    if enabled is None:
        torch = sys.modules.get("torch")
        if torch is None:
            return False
        enabled = _profiler_enabled = torch._C._autograd._profiler_enabled
    return enabled()


def _annotation(name: str):
    """An entered ``torch.profiler.record_function(name)``."""
    rf = sys.modules["torch"].profiler.record_function(name)
    rf.__enter__()
    return rf


class _SpanCtx:
    """A span on ``rec`` (None: on the profiler alone, yielding None), and
    an annotation while a profiler records."""

    __slots__ = ("_rec", "_span", "_rf")

    def __init__(self, rec: TraceRecorder | None, s: Span):
        self._rec = rec
        self._span = s
        self._rf = None

    def __enter__(self) -> Span | None:
        if self._rec is not None:
            self._rec._open(self._span)
        if _profiling():
            self._rf = _annotation(self._span.name)
        return None if self._rec is None else self._span

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._rf is not None:
            self._rf.__exit__(exc_type, exc, tb)
            self._rf = None
        if self._rec is not None:
            self._rec._close(self._span, exc)
        return False


class _NullSpanCtx:
    """No-tracer fallback: yields None, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_NULL = _NullSpanCtx()
_ambient: TraceRecorder | None = None


def set_tracer(tracer: TraceRecorder | None) -> TraceRecorder | None:
    """Install the process-ambient tracer; returns the previous one.

    Harness-level API: the benchmark runner and the service CLI install a
    recorder around their run and restore the previous value after, so a
    library call tree needs no tracer plumbing.
    """
    global _ambient
    prev = _ambient
    _ambient = tracer
    return prev


def current_tracer() -> TraceRecorder | None:
    """The installed ambient tracer, or None."""
    return _ambient


def span(name: str, cat: str = "repro", args: dict | None = None):
    """Span against the ambient tracer and the torch profiler.

    Yields the :class:`Span` when an ambient tracer records it, else None:
    an annotation while a profiler records, a no-op otherwise.
    Instrumentation sites use the yielded value's truthiness to decide
    whether trace-only work (e.g. ``torch.cuda.synchronize`` for honest
    phase attribution) should run at all.
    """
    t = _ambient
    if t is not None:
        return t.span(name, cat=cat, args=args)
    return _SpanCtx(None, Span(name, cat, {})) if _profiling() else _NULL


def span_on(tracer: TraceRecorder | None, name: str, cat: str = "repro",
            args: dict | None = None):
    """:func:`span` against ``tracer`` in place of the ambient one (None:
    the profiler alone)."""
    if tracer is not None:
        return tracer.span(name, cat=cat, args=args)
    return _SpanCtx(None, Span(name, cat, {})) if _profiling() else _NULL
