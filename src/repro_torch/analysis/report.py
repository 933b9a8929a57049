"""Findings, waivers, and report formatting for the causality linter.

A rule emits :class:`Finding`\\ s; the per-backend driver collects them into a
:class:`BackendReport`; ``analyze`` (see ``__init__``) aggregates those into a
:class:`Report` whose ``ok`` property is the CI gate.  A finding names the
rule that fired, the backend/probe it fired on, and — when the rule can trace
it — the graph op (primitive + provenance path) that violated the invariant.

Waivers: a waiver is ``"rule"`` or ``"rule:backend"``.  Waived findings stay
in the report (marked ``waived: true``) but do not fail the gate, so a known
exception is visible in the artifact instead of silently dropped.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation (or suspicion) with op provenance."""

    rule: str                 # e.g. "stencil-locality"
    message: str              # human-readable description of the violation
    backend: str = ""         # filled in by the driver
    probe: str = ""           # which traced entry point ("step", "sweep", ...)
    op: str = ""              # offending primitive, e.g. "roll" / "ppermute"
    path: str = ""            # provenance: the functions that called the op, if known
    waived: bool = False

    def with_context(self, backend: str, probe: str) -> "Finding":
        return dataclasses.replace(self, backend=backend, probe=probe)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        return {k: v for k, v in d.items() if v not in ("", False)}


@dataclasses.dataclass
class BackendReport:
    """All findings for one backend (every probe always runs)."""

    backend: str
    findings: list = dataclasses.field(default_factory=list)
    rules_run: list = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not [f for f in self.findings if not f.waived]

    def to_dict(self) -> dict:
        return {
            "backend": self.backend,
            "ok": self.ok,
            "rules_run": sorted(set(self.rules_run)),
            "findings": [f.to_dict() for f in self.findings],
        }


@dataclasses.dataclass
class Report:
    """Aggregate over backends — what the CLI prints and CI gates on."""

    backends: list = dataclasses.field(default_factory=list)
    waivers: tuple = ()

    @property
    def ok(self) -> bool:
        return all(b.ok for b in self.backends)

    @property
    def findings(self) -> list:
        return [f for b in self.backends for f in b.findings]

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "n_findings": len([f for f in self.findings if not f.waived]),
            "waivers": list(self.waivers),
            "backends": [b.to_dict() for b in self.backends],
        }

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def to_text(self) -> str:
        lines = []
        for b in self.backends:
            status = "OK" if b.ok else "FAIL"
            lines.append(f"[{status}] backend={b.backend} "
                         f"rules={','.join(sorted(set(b.rules_run)))}")
            for f in b.findings:
                tag = " (waived)" if f.waived else ""
                loc = f" at {f.op}" if f.op else ""
                if f.path:
                    loc += f" [{f.path}]"
                lines.append(
                    f"    {f.rule}{tag} probe={f.probe}{loc}: {f.message}")
        verdict = "PASS" if self.ok else "FAIL"
        n = len([f for f in self.findings if not f.waived])
        lines.append(f"analysis: {verdict} ({n} unwaived finding(s), "
                     f"{len(self.backends)} backend(s))")
        return "\n".join(lines)


def parse_waivers(items) -> tuple:
    """Normalize waiver strings ``rule`` / ``rule:backend``."""
    out = []
    for it in items or ():
        it = it.strip()
        if it:
            out.append(it)
    return tuple(out)


def is_waived(finding: Finding, waivers) -> bool:
    for w in waivers or ():
        rule, _, backend = w.partition(":")
        if rule != finding.rule:
            continue
        if not backend or backend == finding.backend:
            return True
    return False


def apply_waivers(findings, waivers) -> list:
    return [dataclasses.replace(f, waived=is_waived(f, waivers))
            for f in findings]


def summary_verdict(report: Report) -> dict[str, Any]:
    """Compact verdict for embedding in bench JSON metadata."""
    return {
        "ok": report.ok,
        "n_findings": len([f for f in report.findings if not f.waived]),
        "backends": {b.backend: b.ok for b in report.backends},
    }
