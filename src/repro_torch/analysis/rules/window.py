"""window-bound guard: every advance must be dominated by a comparison
against the window base when the window is finite.

The moving-window rule (paper Eq. (3), ``tau_k <= delta + GVT``) is what
bounds memory and guarantees measurement-phase scalability; a backend that
silently drops the comparison still produces plausible trajectories.  The
rule finds every *advance site* — a ``select_n`` (``torch.where``) of a
float dtype on the tau output's dataflow (the ``where(update, eta, 0)``
increments) — and requires its predicate's ancestry to contain a
comparison fed by the window base: a full-ring min reduction (``amin``
over the ring axis, or the sharded body's MIN all-reduce), or, for sweep
probes, the per-row Δ column operand (which must reach *every* site's
predicate — a sweep that ignores its Δ column for some rows is a silent
correctness bug).  The reference's rule, on aten graphs.
"""
from __future__ import annotations

import math

from ..probes import Probe
from ..report import Finding
from .common import is_float, ring_min_gids, tau_io, where

RULE = "window-bound"

_COMPARES = ("le", "lt", "ge", "gt")


def advance_sites(graph, tau_out):
    """select_n nodes of float dtype on the tau output's ancestry."""
    anc = graph.ancestors(tau_out)
    return [n for n in graph.nodes
            if n.gid in anc and n.prim == "select_n" and len(n.deps) >= 2
            and is_float(n)]


def check(probe: Probe, **_) -> list:
    finite = probe.delta is not None and math.isfinite(probe.delta)
    if not finite and probe.delta_input is None:
        return []                       # unconstrained run: nothing to guard
    graph = probe.graph
    _, tau_out = tau_io(graph, probe)
    window = ring_min_gids(graph, probe)
    delta_gid = (graph.in_gids[probe.delta_input]
                 if probe.delta_input is not None else None)
    findings = []
    sites = advance_sites(graph, tau_out)
    if not sites:
        findings.append(Finding(
            rule=RULE,
            message="no guarded advance site found on the tau output path "
                    "(expected a select over the update predicate)"))
        return findings
    for s in sites:
        pred_anc = graph.ancestors(s.deps[0])
        compares = [g for g in pred_anc
                    if graph.node(g).prim in _COMPARES]
        guarded = False
        sweep_guarded = delta_gid is None
        for c in compares:
            c_anc = graph.ancestors(c)
            if c_anc & window:
                guarded = True
            if delta_gid is not None and delta_gid in c_anc:
                sweep_guarded = True
        if not guarded:
            findings.append(Finding(
                rule=RULE, op=s.prim, path=where(s),
                message="advance is not dominated by a comparison against "
                        "the window base (no full-ring min reaches the "
                        "update predicate)"))
        elif not sweep_guarded:
            findings.append(Finding(
                rule=RULE, op=s.prim, path=where(s),
                message="sweep advance ignores the per-row Δ column: "
                        "the window comparison never reads it"))
    return findings
