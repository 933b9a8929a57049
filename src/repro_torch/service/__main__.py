"""``python -m repro_torch.service`` — drain a JSONL queue of sweep requests.

::

    python -m repro_torch.service queue.jsonl [--out responses.jsonl]
        [--device cuda|cpu] [--state-cache PATH] [--max-batch-rows N]
        [--max-wait-rounds N] [--fairness-rows N] [--quota-rows N]
        [--engine-retries N] [--state-cache-rows N]

Each input line is a wire-schema request (see ``wire.py``); one response
line is written per input line, in queue order, flushed as each completes.
Malformed lines get structured ``error`` responses.  The work runs on the
GPU unless ``--device cpu`` is given.  The ``serve`` daemon, telemetry and
``--fake-devices`` come with later slices (ROADMAP, queue A, item A9).
"""
from __future__ import annotations

import argparse
import os
import sys


def _summary(stats) -> str:
    return (f"served {stats.n_requests} request(s): "
            f"{stats.n_deduped} deduped, {stats.n_errors} error(s), "
            f"{stats.n_passes} coalesced pass(es), "
            f"{stats.rows_computed} rows computed, "
            f"{stats.rows_from_state_cache} rows from state cache, "
            f"{stats.engine_row_steps} engine row-steps; state cache "
            f"{stats.state_cache_hits} hit(s) / "
            f"{stats.state_cache_misses} miss(es) / "
            f"{stats.state_cache_evictions} eviction(s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Drain a JSONL window-sweep request queue.")
    ap.add_argument("queue", help="JSONL file of wire-schema requests")
    ap.add_argument("--out", default=None,
                    help="responses JSONL path (default: stdout)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the passes run (default: the GPU)")
    ap.add_argument("--state-cache", default=None, metavar="PATH",
                    help="persist/restore the burned-state cache here (npz)")
    ap.add_argument("--max-batch-rows", type=int, default=4096)
    ap.add_argument("--max-wait-rounds", type=int, default=0)
    ap.add_argument("--fairness-rows", type=float, default=float("inf"),
                    help="Eq. (3) window over cumulative served rows")
    ap.add_argument("--quota-rows", type=float, default=float("inf"),
                    help="per-requester row budget per scheduling round")
    ap.add_argument("--engine-retries", type=int, default=0,
                    help="capped-backoff retries per failing pass")
    ap.add_argument("--state-cache-rows", type=int, default=65536,
                    help="LRU bound of the burned-state cache, in rows")
    args = ap.parse_args(argv)

    from .api import SweepService
    from .wire import serve_queue

    try:
        service = SweepService(device=args.device,
                               max_batch_rows=args.max_batch_rows,
                               max_wait_rounds=args.max_wait_rounds,
                               fairness_rows=args.fairness_rows,
                               quota_rows=args.quota_rows,
                               engine_retries=args.engine_retries,
                               state_cache_rows=args.state_cache_rows)
    except RuntimeError as e:            # no CUDA and --device cuda
        print(f"error: {e}", file=sys.stderr)
        return 2
    if args.state_cache and os.path.exists(args.state_cache):
        service.state_cache.load(args.state_cache)
    if args.out:
        with open(args.out, "w") as fh:
            stats = serve_queue(args.queue, fh, service=service)
    else:
        stats = serve_queue(args.queue, sys.stdout, service=service)
    if args.state_cache and service.state_cache.dirty:
        service.state_cache.save(args.state_cache)
    print(_summary(stats), file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
