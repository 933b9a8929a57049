"""dtype-drift: no 64-bit value outside the port's two declared uses.

Cross-backend bit parity only holds if every backend computes in the
declared dtypes: a stray fp64 changes rounding and breaks trajectory
equality between ``horizon.conservative_update`` and the kernels.  The
reference's rule fires on any 64-bit node, which its clean tree never
has.  The port has 64-bit values by design (ROADMAP C1), so they are
declared here, each once with its reason (:data:`EXEMPTIONS`), and the
rule holds them to that use:

* **int64: the event-word carrier.**  Every 64-bit integer may flow into
  others (the hash, the trial and PE index arithmetic that feeds it,
  wherever it stands) and leave only through the decode's exits: a
  comparison to a bool (the site pick) or a cast to fp32 of a value the
  interval analysis bounds by ``2^24`` (exact: ``w1 >> 8``).
* **float64: C1's decode**, ``fp32(-log(fp64(x)))`` at
  :data:`FP64_SITE`: an island of exactly a cast from fp32, a ``log``, a
  ``neg`` and casts back to fp32, each read only by the next.  It is
  recognised by that shape, and where the trace kept provenance (the
  nodes' ``src``), only at that site.

Anything else fires: a 64-bit float elsewhere, or one read by anything
but a cast back to fp32; a 64-bit integer that leaves the carrier any
other way; any 64-bit output of the probe (tau, the moments); and tau's
output leaving its declared dtype.
"""
from __future__ import annotations

from ..probes import Probe
from ..report import Finding
from .common import dtype_of, is_wide, tau_io, where
from .monotonic import compute_intervals

RULE = "dtype-drift"

#: the fp64 log of the port's decode rule (``horizon.decode_eta``)
FP64_SITE = "core/horizon.py:140"

#: dtype -> (where it is declared, why)
EXEMPTIONS = {
    "int64": ("core/events.py",
              "uint32 event words, and the trial and PE indices hashed into "
              "them, are carried in int64: PyTorch on the CPU has no uint32 "
              "shifts; they leave only as the decode's site-pick comparison "
              "and its exact 24-bit cast to fp32"),
    "float64": (FP64_SITE,
                "C1's decode rule eta = fp32(-log(fp64(x))): the fp64 log "
                "makes the fp32 rounding agree across libm implementations "
                "and the kernels' own decode"),
}

_COMPARES = ("eq", "ne", "lt", "le", "gt", "ge")
_EXACT_F32 = 2 ** 24


def _decode_islands(graph, users) -> set:
    """gids of the fp64 nodes of C1's decode: ``c = fp64(x)`` of an fp32
    ``x``, ``l = log(c)``, ``m = neg(l)``, each read only by the next, and
    ``m`` read only by casts to fp32; at :data:`FP64_SITE` where the
    nodes carry provenance."""
    def only(gid, prim):
        us = [graph.node(u) for u in users[gid]]
        return len(us) == 1 and us[0].prim == prim and \
            dtype_of(us[0]) == "float64" and us[0]
    out = set()
    for c in graph.nodes:
        if c.prim != "convert_element_type" or dtype_of(c) != "float64" or \
                not c.deps or dtype_of(graph.node(c.deps[0])) != "float32":
            continue
        log = only(c.gid, "log")
        neg = log and only(log.gid, "neg")
        if not neg or not users[neg.gid] or any(
                graph.node(u).prim != "convert_element_type" or
                dtype_of(graph.node(u)) != "float32" for u in users[neg.gid]):
            continue
        island = (c, log, neg)
        if all(n.src in ("", FP64_SITE) for n in island):
            out.update(n.gid for n in island)
    return out


def check(probe: Probe, **_) -> list:
    graph = probe.graph
    users = graph.users()
    iv = None
    findings, seen = [], set()

    def fire(n, msg):
        key = (msg, n.prim, n.src, n.path)
        if key not in seen:
            seen.add(key)
            findings.append(Finding(rule=RULE, op=n.prim, path=where(n),
                                    message=msg))

    decode = _decode_islands(graph, users)
    for n in graph.nodes:
        if not is_wide(n) or n.prim in ("input", "const"):
            continue
        dt = dtype_of(n)
        if dt == "float64":
            if n.gid not in decode:
                fire(n, f"64-bit float outside the declared fp64 decode "
                        f"({FP64_SITE}); declared base dtype {probe.dtype}")
            for u in map(graph.node, users[n.gid]):
                if dtype_of(u) == "float64" or (
                        u.prim == "convert_element_type" and
                        dtype_of(u) == "float32"):
                    continue
                fire(u, f"a 64-bit float reaches {u.prim} "
                        f"({dtype_of(u) or 'no dtype'}); only a cast back "
                        "to fp32 may read it")
            continue
        for u in map(graph.node, users[n.gid]):
            if is_wide(u) and not dtype_of(u).startswith("float"):
                continue                 # still the carrier
            if u.prim in _COMPARES and dtype_of(u) == "bool":
                continue                 # the site pick
            if u.prim == "convert_element_type" and \
                    dtype_of(u) == "float32":
                iv = iv or compute_intervals(graph)
                lo, hi = iv.get(n.gid, (-float("inf"), float("inf")))
                if 0 <= lo and hi <= _EXACT_F32:
                    continue             # the exact 24-bit cast
            fire(u, f"a 64-bit integer ({dt}) leaves the event-word carrier "
                    f"through {u.prim} -> {dtype_of(u) or 'no dtype'}")
    for g in graph.out_gids:
        n = graph.node(g)
        if is_wide(n):
            fire(n, f"a 64-bit value ({dtype_of(n)}) is an output of the "
                    "step (tau or its moments)")
    _, tau_out = tau_io(graph, probe)
    out_dt = dtype_of(graph.node(tau_out))
    if out_dt and out_dt != probe.dtype:
        fire(graph.node(tau_out),
             f"tau output dtype {out_dt} != declared {probe.dtype}")
    return findings
