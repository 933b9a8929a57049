"""The traced run's profiler pass and its reduction to a record.

``torch.profiler`` traces the host's PyTorch operations and the card's
kernels and copies over the traced window, which the harness marks with
the ``bench.window`` annotation.  :func:`read` reduces the exported Chrome
trace to what the per-layer metrics and the ``breakdown`` read: device time
by operation, the union of device activity (busy time), and the idle gaps,
each named by the innermost host operation or annotation under way at its
midpoint on the harness's thread.
"""
from __future__ import annotations

import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
WINDOW = "bench.window"


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    depth, out = 0, []
    for ch in name:                 # drop the parameter list, keep templates
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out).strip() or name


def _union(intervals):
    """Sorted disjoint cover of ``(start, end)`` intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read(events: list) -> dict:
    """Reduce Chrome trace events (``traceEvents``) to the traced record.

    Times come back in seconds.  ``device_ops`` maps each device operation
    (kernels by short name, copies and sets by their names) to its total
    time inside the window; ``gaps`` maps what the host was doing to the
    idle time it left the device.
    """
    win = [e for e in events if e.get("ph") == "X"
           and e.get("name") == WINDOW and e.get("cat") in HOST_CATS]
    if not win:
        raise ValueError(f"the trace has no {WINDOW!r} annotation")
    w = win[0]
    lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
    dev, host, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        s = float(e["ts"])
        t = s + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            s, t = max(s, lo), min(t, hi)
            if t > s:
                dev.append((s, t))
                name = short_name(e["name"]) if cat == "kernel" else e["name"]
                ops[name] = ops.get(name, 0.0) + (t - s) * 1e-6
        elif cat in HOST_CATS and e.get("tid") == w.get("tid") \
                and e is not w:
            host.append((s, t, e["name"]))
    busy = _union(dev)
    gaps, prev = [], lo
    for s, t in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, t)
    if hi > prev:
        gaps.append((prev, hi))
    # host operations on one thread nest: walk them in start order with a
    # stack of those still open, and the gaps' midpoints in order
    host.sort(key=lambda h: (h[0], -h[1]))
    named: dict = {}
    stack, k = [], 0
    for s, t in gaps:
        mid = 0.5 * (s + t)
        while k < len(host) and host[k][0] <= mid:
            while stack and stack[-1][1] < host[k][0]:
                stack.pop()
            stack.append(host[k])
            k += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        label = stack[-1][2] if stack else "host outside any operation"
        named[label] = named.get(label, 0.0) + (t - s) * 1e-6
    return {"window_s": (hi - lo) * 1e-6,
            "busy_s": sum(t - s for s, t in busy) * 1e-6,
            "device_ops": ops, "gaps": named}


def load(path) -> dict:
    """:func:`read` of an exported Chrome trace file."""
    with open(path) as f:
        return read(json.load(f)["traceEvents"])


def top(d: dict, n: int = 10) -> list:
    """The ``n`` largest entries of a name -> seconds map, as pairs."""
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:n]]
