"""Observability of the port: metrics, tracing, exposition.

The port of ``repro.obs``, stdlib only:

* :mod:`~repro_torch.obs.metrics` — counter/gauge/histogram registry with
  labeled series, JSONL sink, Prometheus text exposition, atomic
  snapshot writer;
* :mod:`~repro_torch.obs.trace` — span API emitting Chrome-trace/Perfetto
  JSON, with a process-ambient tracer so library code needs no plumbing;
* :mod:`~repro_torch.obs.summarize` — ``python -m repro_torch.obs
  summarize [--check]`` renders/validates the emitted files.

:class:`Telemetry` bundles a registry with an optional tracer — the
single handle the service, daemon, and CLIs pass around.  Instrumentation
is strictly off-path: it observes host values the instrumented code
already materialized, never launches GPU work, and responses with
telemetry on equal responses with it off, bit for bit
(tests/test_torch_obs.py).
"""
from __future__ import annotations

from .metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                      append_jsonl, to_prometheus, write_snapshot)
from .trace import (Span, TraceRecorder, current_tracer, set_tracer, span,
                    span_on)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "append_jsonl", "to_prometheus", "write_snapshot",
           "Span", "TraceRecorder", "current_tracer", "set_tracer", "span",
           "span_on", "Telemetry"]


class Telemetry:
    """A metrics registry plus an optional trace recorder, as one handle.

    ``Telemetry()`` gives live metrics only; pass ``tracer=`` to also
    record spans.  ``spans()`` proxies to the tracer when present and
    otherwise annotates a recording torch profiler or does nothing, so
    instrumented code never branches on tracer presence.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 tracer: TraceRecorder | None = None):
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self.tracer = tracer

    def spans(self, name: str, cat: str = "repro",
              args: dict | None = None):
        """Span on this bundle's tracer (and a recording profiler); yields
        None if no tracer is attached."""
        return span_on(self.tracer, name, cat=cat, args=args)
