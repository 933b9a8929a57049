"""CLI for the causality linter: ``python -m repro_torch.analysis``.

Exit status 0 when every (unwaived) rule holds on every requested backend,
1 otherwise.
"""
from __future__ import annotations

import argparse
import sys

from ..core.engine import BACKENDS
from . import ALL_RULES, analyze
from .rules.vmem import DEFAULT_BUDGET


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Statically prove PDES protocol invariants and kernel "
                    "budgets over every backend's traced step function.")
    p.add_argument("--backend", default="all",
                   help="comma-separated backends, or 'all' "
                        f"(choices: {', '.join(BACKENDS)})")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule subset "
                        f"(choices: {', '.join(ALL_RULES)})")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--waive", action="append", default=[],
                   metavar="RULE[:BACKEND]",
                   help="keep a finding in the report but do not fail on it "
                        "(repeatable)")
    p.add_argument("--vmem-budget", type=int, default=DEFAULT_BUDGET,
                   help="shared-memory budget in bytes of one block for the "
                        "vmem-budget rule "
                        f"(default {DEFAULT_BUDGET})")
    p.add_argument("-o", "--output", default=None,
                   help="also write the JSON report to this path")
    args = p.parse_args(argv)

    backends = (BACKENDS if args.backend == "all"
                else tuple(b.strip() for b in args.backend.split(",")))
    for b in backends:
        if b not in BACKENDS:
            p.error(f"unknown backend {b!r}; choices: {', '.join(BACKENDS)}")
    rules = None
    if args.rules:
        rules = {}
        for r in args.rules.split(","):
            r = r.strip()
            if r not in ALL_RULES:
                p.error(f"unknown rule {r!r}; choices: "
                        f"{', '.join(ALL_RULES)}")
            rules[r] = ALL_RULES[r]

    report = analyze(backends=backends, rules=rules, waivers=args.waive,
                     vmem_budget=args.vmem_budget)
    if args.output:
        with open(args.output, "w") as f:
            f.write(report.to_json() + "\n")
    print(report.to_json() if args.format == "json" else report.to_text())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
