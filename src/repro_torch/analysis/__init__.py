"""repro_torch.analysis — the causality linter (port of ``repro.analysis``).

A static-analysis pass that traces each backend's step function to an
aten graph (``torch.fx.experimental.proxy_tensor.make_fx``) and proves
the paper's protocol invariants plus the Hopper kernels' budgets over the
traced computation:

==============================  =============================================
rule                            invariant
==============================  =============================================
``stencil-locality``            tau updates reach only {i-1, i, i+1} ring
                                neighbors (rolls, slices, halo concats and
                                the sharded body's ``ppermute`` shifts)
``tau-monotonicity``            no dataflow path can decrease a local
                                virtual time
``window-bound``                finite-Δ advances are dominated by a
                                comparison against the window base
                                (including the per-row Δ column)
``dtype-drift``                 no 64-bit value but the port's two declared
                                ones (the int64 word carrier, C1's fp64 log)
``nondeterministic-reduction``  no order-unspecified float all-reduce on
                                the trajectory path
``vmem-budget``                 each kernel launch's shared memory (and,
                                where ``nvcc`` ran, registers) within one
                                H100 block's budget
==============================  =============================================

The graphs are of the port's own step functions: ``core.engine``'s chunk
advance for the single-device backends, one rank's
``core.distributed._shard_body`` for ``sharded`` (its collectives as the
marker ops of ``markers.py``), each kernel wrapper as its plain version.

Usage::

    python -m repro_torch.analysis --backend all --format text
    python -m repro_torch.analysis --backend sharded --format json -o r.json

or programmatically::

    from repro_torch.analysis import analyze
    report = analyze()          # all backends, all rules
    assert report.ok, report.to_text()
"""
from __future__ import annotations

from ..core.engine import BACKENDS
from .probes import Probe, iter_probes
from .report import (BackendReport, Finding, Report, apply_waivers,
                     parse_waivers, summary_verdict)
from .rules import ALL_RULES

__all__ = ["ALL_RULES", "BACKENDS", "BackendReport", "Finding", "Probe",
           "Report", "analysis_verdict", "analyze", "analyze_backend",
           "analyze_probe", "iter_probes"]


def analyze_probe(probe: Probe, rules=None, **options) -> list:
    """Run rules over one probe; returns contextualized findings."""
    selected = rules or ALL_RULES
    out = []
    for name, fn in selected.items():
        for f in fn(probe, **options):
            out.append(f.with_context(probe.backend, probe.name))
    return out


def analyze_backend(backend: str, rules=None, waivers=(),
                    **options) -> BackendReport:
    """Trace every probe of one backend and run the rule engine."""
    selected = rules or ALL_RULES
    rep = BackendReport(backend=backend, rules_run=list(selected))
    for probe in iter_probes(backend):
        rep.findings.extend(analyze_probe(probe, selected, **options))
    rep.findings = apply_waivers(rep.findings, waivers)
    return rep


def analyze(backends=None, rules=None, waivers=(), **options) -> Report:
    """Run the full pass.  ``backends=None`` means all four."""
    if backends is None or backends == "all" or backends == ("all",):
        backends = BACKENDS
    elif isinstance(backends, str):
        backends = (backends,)
    waivers = parse_waivers(waivers)
    rep = Report(waivers=waivers)
    for b in backends:
        rep.backends.append(
            analyze_backend(b, rules=rules, waivers=waivers, **options))
    return rep


_VERDICT_CACHE: dict = {}


def analysis_verdict(backends=None) -> dict:
    """Compact pass/fail verdict for embedding in a record's metadata.

    Cached per backend tuple.  Never raises: a crashed analysis is itself
    a failing verdict.
    """
    key = tuple(BACKENDS if backends is None else backends)
    if key not in _VERDICT_CACHE:
        try:
            _VERDICT_CACHE[key] = summary_verdict(analyze(backends=key))
        except Exception as e:  # pragma: no cover - defensive
            _VERDICT_CACHE[key] = {"ok": False, "error": repr(e)}
    return _VERDICT_CACHE[key]
