"""Observability of the port: span tracing (``trace``).

Metrics and ``summarize`` come with a later slice (ROADMAP, queue A, A9).
"""
from .trace import Span, TraceRecorder, current_tracer, set_tracer, span

__all__ = ["Span", "TraceRecorder", "current_tracer", "set_tracer", "span"]
