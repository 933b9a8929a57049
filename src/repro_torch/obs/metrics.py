"""Metrics core: counter/gauge/histogram registry with labeled series.

A copy of ``repro.obs.metrics`` (stdlib only, no torch, no numpy), kept in
the port so that it imports nothing of ``repro``.  The two render the same
registry operations to the same Prometheus text and snapshot JSON, byte
for byte, so a dashboard or scraper pointed at the service does not care
which package serves it (tests/test_torch_obs.py).

The instrumentation contract is **off-path observation**: hooks only read
host values that the instrumented code already materialized (stats rows,
scheduler state, wall clocks); they never launch GPU work or copy from the
card, so responses with telemetry on equal responses with it off, bit for
bit.

Three metric kinds, Prometheus-shaped:

* :class:`Counter` — monotonically non-decreasing totals.  ``inc`` adds;
  ``set_total`` mirrors an externally-accumulated cumulative counter
  (e.g. a ``ServiceStats`` field) into the registry.
* :class:`Gauge` — a value that can go both ways (queue depth, ratios).
* :class:`Histogram` — bucketed observations with ``sum``/``count``
  (per-pass observables, phase seconds).

Series are keyed by ``(metric name, sorted label items)``; a series exists
from its first update (never from mere instrument creation), so "series
present" in a snapshot means the instrumented path actually ran.

Exposition:

* :func:`MetricsRegistry.snapshot` — JSON-ready dict of every series;
* :func:`append_jsonl` — the JSONL metrics sink (one snapshot per line);
* :func:`to_prometheus` — Prometheus text exposition format;
* :func:`write_snapshot` — atomic ``metrics.json`` + ``metrics.prom`` pair
  in a directory, written with the same tmp+rename+fsync discipline as
  ``service.state_cache.StateCache.save`` (a reader never sees a torn
  file; the daemon calls this after every busy round).
"""
from __future__ import annotations

import json
import math
import os
import time

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry",
           "DEFAULT_BUCKETS", "to_prometheus", "append_jsonl",
           "write_snapshot", "SNAPSHOT_BASENAME", "PROM_BASENAME"]

#: default histogram bucket upper bounds (seconds-flavored, Prometheus-ish);
#: instruments measuring ratios or physics quantities pass their own.
DEFAULT_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                   0.5, 1.0, 2.5, 5.0, 10.0)

#: file names :func:`write_snapshot` maintains inside a ``--metrics-dir``.
SNAPSHOT_BASENAME = "metrics.json"
PROM_BASENAME = "metrics.prom"


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _fmt(v: float) -> str:
    """Prometheus float spelling: integral values bare, inf as +Inf."""
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if math.isnan(v):
        return "NaN"
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


class _Metric:
    """Common shape of one named metric family (shared by all kinds)."""

    kind = "untyped"

    def __init__(self, name: str, help: str = "", unit: str = ""):
        self.name = name
        self.help = help
        self.unit = unit
        self._series: dict[tuple, object] = {}

    @property
    def series(self) -> dict:
        """Live series, keyed by sorted ``(label, value)`` item tuples."""
        return self._series


class Counter(_Metric):
    """Monotonically non-decreasing total (per label set)."""

    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease "
                             f"(inc {amount})")
        k = _label_key(labels)
        self._series[k] = self._series.get(k, 0.0) + amount

    def set_total(self, value: float, **labels) -> None:
        """Mirror an externally-accumulated cumulative total.

        The service keeps its own ``ServiceStats`` ledger; telemetry syncs
        those fields here rather than double-counting.  Still monotone:
        lowering a total is a programming error and raises.
        """
        k = _label_key(labels)
        if value < self._series.get(k, 0.0):
            raise ValueError(
                f"counter {self.name}{dict(k)} cannot decrease "
                f"({self._series[k]} -> {value})")
        self._series[k] = float(value)

    def value(self, **labels) -> float:
        """Current total for the label set (0 if never updated)."""
        return float(self._series.get(_label_key(labels), 0.0))


class Gauge(_Metric):
    """Point-in-time value (queue depth, ratios, occupancy)."""

    kind = "gauge"

    def set(self, value: float, **labels) -> None:
        self._series[_label_key(labels)] = float(value)

    def value(self, **labels) -> float:
        """Current value for the label set (0 if never set)."""
        return float(self._series.get(_label_key(labels), 0.0))


class Histogram(_Metric):
    """Bucketed observations with cumulative ``sum`` and ``count``."""

    kind = "histogram"

    def __init__(self, name: str, help: str = "", unit: str = "",
                 buckets=DEFAULT_BUCKETS):
        super().__init__(name, help, unit)
        b = tuple(sorted(float(x) for x in buckets))
        if not b:
            raise ValueError(f"histogram {name} needs at least one bucket")
        if any(x >= y for x, y in zip(b, b[1:])):
            raise ValueError(f"histogram {name} buckets must be strictly "
                             f"increasing: {buckets}")
        self.buckets = b

    def observe(self, value: float, **labels) -> None:
        k = _label_key(labels)
        s = self._series.get(k)
        if s is None:
            s = {"counts": [0] * (len(self.buckets) + 1),
                 "sum": 0.0, "count": 0}
            self._series[k] = s
        v = float(value)
        i = len(self.buckets)
        for j, ub in enumerate(self.buckets):
            if v <= ub:
                i = j
                break
        s["counts"][i] += 1
        s["sum"] += v
        s["count"] += 1

    def count(self, **labels) -> int:
        """Observations recorded for the label set (0 if none)."""
        s = self._series.get(_label_key(labels))
        return 0 if s is None else int(s["count"])


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """Get-or-create registry of named metrics, snapshot- and text-exposable.

    ``clock`` stamps snapshots (injectable for reproducible golden-file
    tests — the exposition tests fix it and re-render byte-identically).
    Re-requesting an existing name returns the same instrument; requesting
    it as a different kind raises, so two layers can't silently fork one
    series.
    """

    def __init__(self, clock=time.time):
        self._clock = clock
        self._metrics: dict[str, _Metric] = {}

    def _get(self, cls, name: str, help: str, unit: str, **kw) -> _Metric:
        m = self._metrics.get(name)
        if m is not None:
            if type(m) is not cls:
                raise TypeError(f"metric {name!r} already registered as "
                                f"{m.kind}, requested {cls.kind}")
            return m
        m = cls(name, help=help, unit=unit, **kw)
        self._metrics[name] = m
        return m

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        """Get or create a :class:`Counter`."""
        return self._get(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "") -> Gauge:
        """Get or create a :class:`Gauge`."""
        return self._get(Gauge, name, help, unit)

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets=DEFAULT_BUCKETS) -> Histogram:
        """Get or create a :class:`Histogram`."""
        return self._get(Histogram, name, help, unit, buckets=buckets)

    def __iter__(self):
        return iter(sorted(self._metrics.values(), key=lambda m: m.name))

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """JSON-ready dict of every live series (the sink/exposition unit).

        Shape::

            {"ts": <clock()>, "series": [
               {"name": ..., "type": "counter"|"gauge", "help": ...,
                "unit": ..., "labels": {...}, "value": ...},
               {"name": ..., "type": "histogram", ..., "labels": {...},
                "buckets": [...], "counts": [...], "sum": ..., "count": ...},
            ]}
        """
        series = []
        for m in self:
            for k in sorted(m.series):
                entry = {"name": m.name, "type": m.kind, "help": m.help,
                         "unit": m.unit, "labels": dict(k)}
                v = m.series[k]
                if m.kind == "histogram":
                    entry.update(buckets=list(m.buckets),
                                 counts=list(v["counts"]),
                                 sum=v["sum"], count=v["count"])
                else:
                    entry["value"] = v
                series.append(entry)
        return {"ts": float(self._clock()), "series": series}


def to_prometheus(registry: MetricsRegistry) -> str:
    """Render a registry in the Prometheus text exposition format.

    Deterministic: metrics sorted by name, series by label key, floats in
    the canonical spelling of :func:`_fmt` — re-rendering an unchanged
    registry is byte-identical (and equal to ``repro.obs``'s rendering,
    tests/test_torch_obs.py).
    """
    def esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace('"', '\\"').replace(
            "\n", "\\n")

    def lbl(k: tuple, extra: tuple = ()) -> str:
        items = list(k) + list(extra)
        if not items:
            return ""
        return "{" + ",".join(f'{name}="{esc(val)}"'
                              for name, val in items) + "}"

    lines = []
    for m in registry:
        if not m.series:
            continue
        if m.help:
            lines.append(f"# HELP {m.name} {esc(m.help)}")
        lines.append(f"# TYPE {m.name} {m.kind}")
        for k in sorted(m.series):
            v = m.series[k]
            if m.kind == "histogram":
                acc = 0
                for ub, c in zip((*m.buckets, math.inf), v["counts"]):
                    acc += c
                    lines.append(f"{m.name}_bucket"
                                 f"{lbl(k, (('le', _fmt(ub)),))} {acc}")
                lines.append(f"{m.name}_sum{lbl(k)} {_fmt(v['sum'])}")
                lines.append(f"{m.name}_count{lbl(k)} {v['count']}")
            else:
                lines.append(f"{m.name}{lbl(k)} {_fmt(v)}")
    return "\n".join(lines) + ("\n" if lines else "")


def append_jsonl(registry: MetricsRegistry, path) -> dict:
    """Append one snapshot line to a JSONL metrics sink; returns it.

    The flat-file cousin of a scrape: every call adds a timestamped
    snapshot, so per-round rates fall out of adjacent-line differences
    (``python -m repro_torch.obs summarize`` reads the last line).
    """
    snap = registry.snapshot()
    with open(path, "a") as fh:
        fh.write(json.dumps(snap) + "\n")
        fh.flush()
    return snap


def write_snapshot(registry: MetricsRegistry, directory) -> dict:
    """Atomically write ``metrics.json`` + ``metrics.prom`` into a directory.

    The daemon's ``--metrics-dir`` exposition: after each busy round the
    registry is rendered to both formats and each file is replaced via
    write-to-``.tmp`` + fsync + rename — the same discipline as
    ``StateCache.save`` — so a concurrent reader (scrape cron, tail -f
    dashboard) never observes a torn snapshot.  Returns the snapshot dict.
    """
    os.makedirs(directory, exist_ok=True)
    snap = registry.snapshot()
    for base, text in ((SNAPSHOT_BASENAME, json.dumps(snap, indent=1)),
                       (PROM_BASENAME, to_prometheus(registry))):
        path = os.path.join(directory, base)
        tmp = f"{path}.tmp"
        with open(tmp, "w") as fh:
            fh.write(text)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    return snap
