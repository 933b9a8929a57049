"""nondeterministic-reduction: no order-sensitive collective on the tau path.

The port claims *bit-identical* trajectories across backends, as the
reference does (the parity tests depend on it).  A floating-point SUM
all-reduce has an unspecified order across ranks, so its result may
differ between topologies — harmless for *statistics* (parity is claimed
for trajectories, and the stats SUM in ``_shard_body``'s ``finish_chunk``
is exempt: it reaches no tau), fatal if it feeds the trajectory itself
(e.g. deriving a window base from a mean).  MIN and MAX are
order-insensitive and always allowed; integer sums are exact and allowed
too.  The sharded body's all-reduces reach the graph as the
``ring_reduce`` marker op (``markers.py``): ``psum``, ``pmin`` and
``pmax`` here.
"""
from __future__ import annotations

from ..probes import Probe
from ..report import Finding
from .common import is_float, tau_io, where

RULE = "nondeterministic-reduction"

_ORDER_SENSITIVE = ("psum",)


def check(probe: Probe, **_) -> list:
    graph = probe.graph
    _, tau_out = tau_io(graph, probe)
    anc = graph.ancestors(tau_out)
    findings = []
    for n in graph.nodes:
        if n.prim not in _ORDER_SENSITIVE or not is_float(n):
            continue                   # integer sums are exact
        if n.gid not in anc:
            continue                   # stats-only reduction: exempt
        findings.append(Finding(
            rule=RULE, op=n.prim, path=where(n),
            message="order-unspecified floating-point cross-rank sum on "
                    "the tau dataflow path; bit-identical trajectory parity "
                    "cannot hold (use MIN/MAX or integer sums)"))
    return findings
