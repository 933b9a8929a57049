"""Render and validate metrics snapshots and Chrome traces.

A copy of ``repro.obs.summarize``, kept in the port so that it imports
nothing of ``repro``.  It keeps the ``repro_*`` metric names and the same
:data:`REQUIRED_SERVICE_SERIES`, so either package's ``summarize --check``
accepts the other's files (tests/test_torch_obs.py).

``python -m repro_torch.obs summarize [--check] PATH...`` turns the files the
telemetry layer writes — ``metrics.json`` / ``metrics.prom`` snapshot
dirs, JSONL metric sinks, Chrome-trace JSONs — into the human text table
the service CLI's one-line summary approximates, and (with ``--check``)
validates them for CI:

* a metrics snapshot must be non-empty, and if it came from the sweep
  service (any ``repro_service_*`` series) it must contain live paper
  observables — the :data:`REQUIRED_SERVICE_SERIES` — with at least one
  histogram observation each;
* a trace must be non-empty and its spans must nest correctly per
  ``(pid, tid)`` lane (proper bracketing; overlap without containment is
  a corrupt trace).

File kind is sniffed from content, not extension: a dict with
``traceEvents`` is a trace, one with ``series`` is a metrics snapshot, a
JSONL file is a sink (its last line is summarized).
"""
from __future__ import annotations

import json
import os

__all__ = ["REQUIRED_SERVICE_SERIES", "load_any", "summarize_metrics",
           "summarize_trace", "check_metrics", "check_trace", "main"]

#: series a service-produced metrics snapshot must carry: live paper
#: observables + the coalescing health gauge.
REQUIRED_SERVICE_SERIES = (
    "repro_pass_u",
    "repro_pass_w2",
    "repro_pass_window_occupancy",
    "repro_service_coalescing_ratio",
)


def load_any(path) -> tuple[str, dict]:
    """Load a telemetry file, returning ``(kind, obj)``.

    ``kind`` is ``"trace"`` or ``"metrics"``.  JSONL sinks yield their
    last snapshot line.  A directory is resolved to its ``metrics.json``.
    Raises ValueError on unrecognized content.
    """
    if os.path.isdir(path):
        path = os.path.join(path, "metrics.json")
    with open(path) as fh:
        text = fh.read()
    lines = [ln for ln in text.splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty file")
    if len(lines) > 1 and not text.lstrip().startswith("{\n") \
            and all(ln.lstrip().startswith("{") for ln in lines):
        try:
            obj = json.loads(lines[-1])
        except json.JSONDecodeError:
            obj = json.loads(text)
    else:
        obj = json.loads(text)
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: expected a JSON object")
    if "traceEvents" in obj:
        return "trace", obj
    if "series" in obj:
        return "metrics", obj
    raise ValueError(f"{path}: neither a trace (traceEvents) nor a "
                     f"metrics snapshot (series)")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) \
        + "}"


def summarize_metrics(snap: dict) -> str:
    """Text table of a metrics snapshot: one line per series."""
    rows = []
    for s in snap.get("series", []):
        name = s["name"] + _fmt_labels(s.get("labels", {}))
        unit = s.get("unit", "")
        if s.get("type") == "histogram":
            n = s.get("count", 0)
            mean = (s.get("sum", 0.0) / n) if n else float("nan")
            rows.append((name, s["type"],
                         f"count={n} mean={mean:.6g}", unit))
        else:
            rows.append((name, s.get("type", "?"),
                         f"{s.get('value', 0):.6g}", unit))
    if not rows:
        return "(no series)\n"
    w0 = max(len(r[0]) for r in rows)
    w1 = max(len(r[1]) for r in rows)
    out = [f"{n:<{w0}}  {t:<{w1}}  {v}" + (f" [{u}]" if u else "")
           for n, t, v, u in rows]
    return "\n".join(out) + "\n"


def summarize_trace(obj: dict) -> str:
    """Text table of a trace: per span name, count/total/mean duration."""
    agg: dict[str, list[float]] = {}
    for ev in obj.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        agg.setdefault(ev.get("name", "?"), []).append(
            float(ev.get("dur", 0.0)))
    if not agg:
        return "(no spans)\n"
    rows = []
    for name in sorted(agg):
        durs = agg[name]
        total = sum(durs)
        rows.append((name, len(durs), total / 1e3,
                     total / len(durs) / 1e3))
    w0 = max(len(r[0]) for r in rows)
    out = [f"{'span':<{w0}}  {'count':>5}  {'total_ms':>10}  {'mean_ms':>10}"]
    out += [f"{n:<{w0}}  {c:>5}  {t:>10.3f}  {m:>10.3f}"
            for n, c, t, m in rows]
    return "\n".join(out) + "\n"


def check_metrics(snap: dict) -> list[str]:
    """Validation problems of a metrics snapshot (empty list = OK)."""
    problems = []
    series = snap.get("series", [])
    if not series:
        problems.append("metrics snapshot has no series")
        return problems
    names = {s.get("name") for s in series}
    if any(isinstance(n, str) and n.startswith("repro_service_")
           for n in names):
        for req in REQUIRED_SERVICE_SERIES:
            match = [s for s in series if s.get("name") == req]
            if not match:
                problems.append(f"required service series missing: {req}")
            elif all(s.get("type") == "histogram" and
                     s.get("count", 0) < 1 for s in match):
                problems.append(f"required series never observed: {req}")
    for s in series:
        if s.get("type") == "histogram":
            counts, buckets = s.get("counts", []), s.get("buckets", [])
            if len(counts) != len(buckets) + 1:
                problems.append(
                    f"{s.get('name')}: {len(counts)} bucket counts for "
                    f"{len(buckets)} bounds (want bounds+1)")
            elif sum(counts) != s.get("count", -1):
                problems.append(
                    f"{s.get('name')}: bucket counts sum to "
                    f"{sum(counts)}, count says {s.get('count')}")
    return problems


def check_trace(obj: dict) -> list[str]:
    """Validation problems of a Chrome trace (empty list = OK).

    Spans must bracket properly inside each ``(pid, tid)`` lane: sorted by
    start (ties: longer first), every span must either nest inside the
    enclosing open span or start after it ends.  Partial overlap means the
    recorder's enter/exit discipline was violated.
    """
    problems = []
    events = obj.get("traceEvents", [])
    spans = [ev for ev in events if ev.get("ph") == "X"]
    if not spans:
        problems.append("trace has no complete ('X') spans")
        return problems
    for i, ev in enumerate(spans):
        for field in ("name", "ts", "dur", "pid", "tid"):
            if field not in ev:
                problems.append(f"span #{i} missing field {field!r}")
    if problems:
        return problems
    lanes: dict[tuple, list[dict]] = {}
    for ev in spans:
        lanes.setdefault((ev["pid"], ev["tid"]), []).append(ev)
    eps = 1e-6
    for lane, evs in sorted(lanes.items()):
        evs = sorted(evs, key=lambda e: (e["ts"], -e["dur"]))
        stack: list[dict] = []
        for ev in evs:
            t0, t1 = ev["ts"], ev["ts"] + ev["dur"]
            while stack and t0 >= stack[-1]["ts"] + stack[-1]["dur"] - eps:
                stack.pop()
            if stack and t1 > stack[-1]["ts"] + stack[-1]["dur"] + eps:
                outer = stack[-1]
                problems.append(
                    f"lane {lane}: span {ev['name']!r} "
                    f"[{t0}, {t1}] overlaps {outer['name']!r} "
                    f"[{outer['ts']}, {outer['ts'] + outer['dur']}] "
                    f"without nesting")
            stack.append(ev)
    return problems


def main(argv=None) -> int:
    """CLI entry point for ``python -m repro_torch.obs summarize``."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="repro_torch.obs",
        description="summarize/validate telemetry files "
                    "(metrics snapshots, JSONL sinks, Chrome traces)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sm = sub.add_parser("summarize",
                        help="render telemetry files as text tables")
    sm.add_argument("paths", nargs="+",
                    help="metrics.json / metrics dir / sink.jsonl / "
                         "trace.json")
    sm.add_argument("--check", action="store_true",
                    help="validate instead of merely rendering: non-empty,"
                         " required service series present, spans nest")
    args = ap.parse_args(argv)

    failures = 0
    for path in args.paths:
        try:
            kind, obj = load_any(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"== {path}\nERROR: {e}")
            failures += 1
            continue
        print(f"== {path} ({kind})")
        print(summarize_metrics(obj) if kind == "metrics"
              else summarize_trace(obj), end="")
        if args.check:
            problems = (check_metrics(obj) if kind == "metrics"
                        else check_trace(obj))
            for p in problems:
                print(f"CHECK FAIL: {p}")
            failures += len(problems)
            if not problems:
                print("check ok")
    return 1 if failures else 0
