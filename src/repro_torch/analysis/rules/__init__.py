"""Rule registry for the causality linter.

Every rule is a function ``check(probe, **options) -> list[Finding]``.
``ALL_RULES`` maps the public rule name (as shown in reports and accepted by
``--rules`` / ``--waive``) to its checker: the reference's six names.
"""
from __future__ import annotations

from . import dtype_drift, monotonic, reductions, stencil, vmem, window

ALL_RULES = {
    stencil.RULE: stencil.check,
    monotonic.RULE: monotonic.check,
    window.RULE: window.check,
    dtype_drift.RULE: dtype_drift.check,
    reductions.RULE: reductions.check,
    vmem.RULE: vmem.check,
}

__all__ = ["ALL_RULES", "dtype_drift", "monotonic", "reductions", "stencil",
           "vmem", "window"]
