"""Readings that the limits of ``correct`` are set from, for one cell.

    python bench/calibrate.py --workload <name> --seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 3]

In one process: the program's compared numbers on each of ``--seeds``
(a run of ``--seconds`` each, the window's own load; the lower readings),
then the control's on each of ``--control-seeds``: the cell's reference
computed in bfloat16, the nearest precision below the configuration's
float32, put in the program's place for the requests a run compares, and
held to the float32 reference (the upper readings).  One JSON line a
reading on standard output.  The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_numbers(root, name: str, seed: int, device) -> dict:
    """The control's numbers on the requests a run of ``seed`` compares."""
    import torch

    from bench import check, harness, traffic
    cell = harness.load_cell(root, name)
    gen = traffic.rounds(cell["config"], cell["mix"], cell["cell"], seed)
    log = [[{"request": q} for q in rnd] for rnd in itertools.islice(gen, 2)]
    reqs = [e["request"] for e in check.sample(log, seed)]
    keep = check.drawn(cell["config"], seed)
    ref = cell["reference"]
    want = check.reference_records(reqs, device, keep=keep, reference=ref)
    got = check.reference_records(reqs, device, dtype=torch.bfloat16,
                                  keep=keep, reference=ref)
    return check.compare(got, want, reference=ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from bench import harness
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]
    for seed in seeds:
        t = time.perf_counter()
        res = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          device=args.device, t_start=t)
        print(json.dumps({"workload": args.workload, "kind": "program",
                          "seed": seed, "correct": res["correct"],
                          "attempted": res["attempted"],
                          "checks": {k: v["value"] for k, v in
                                     res["checks"].items()},
                          "seconds": time.perf_counter() - t}), flush=True)
    for seed in controls:
        t = time.perf_counter()
        numbers = control_numbers(ROOT, args.workload, seed, args.device)
        print(json.dumps({"workload": args.workload, "kind": "control",
                          "seed": seed, "checks": numbers,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
