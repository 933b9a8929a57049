"""``python -m repro_torch.service`` — drain a queue, or run the serve daemon.

One-shot drain::

    python -m repro_torch.service queue.jsonl [--out responses.jsonl]
        [--device cuda|cpu] [--mesh data=2,model=4] [--state-cache PATH]
        [--max-batch-rows N] [--max-wait-rounds N] [--fairness-rows N]
        [--quota-rows N] [--engine-retries N] [--state-cache-rows N]
        [--metrics-dir DIR] [--trace FILE]

Each input line is a wire-schema request (see ``wire.py``); one response
line is written per input line, in queue order, flushed as each completes.
Malformed lines get structured ``error`` responses.

Daemon mode::

    python -m repro_torch.service serve --intake DIR [--out responses.jsonl]
        [--poll 0.25] [--idle-exit-rounds N] [--max-rounds N]
        [--max-line-bytes N] [--max-files-per-round N]
        [...the same service options as above...]

Watches DIR for ``*.jsonl`` request files, serves continuously, renames
processed files to ``*.done``, and appends responses as they complete;
SIGTERM/SIGINT flush in-flight work and exit 0 (see ``daemon.py``).

The work runs on the GPU unless ``--device cpu`` is given; without CUDA
the GPU default exits 2.  ``--metrics-dir`` writes atomic
``metrics.json`` + ``metrics.prom`` snapshots of the live registry and
``--trace`` a Chrome-trace JSON (one span per coalesced pass); render or
validate either with ``python -m repro_torch.obs summarize [--check]``.
Telemetry is off-path: responses are bit-identical with or without it.

``--mesh data=2,model=4`` serves ``backend="sharded"`` requests on a
process mesh of that shape: the command starts one copy of itself per
rank (``launch.py``: gloo ranks with ``--device cpu``, NCCL ranks, one a
GPU, otherwise).  Every rank drains the same queue; rank 0 alone writes
``--out``, ``--metrics-dir``, ``--trace`` and ``--state-cache``.  It
takes the place of ``repro.service``'s ``--fake-devices``, which sets
XLA's host device count and has no meaning here.
"""
from __future__ import annotations

import argparse
import math
import os
import sys

from . import launch

_MODULE = "repro_torch.service"


def _parse_mesh(text: str) -> list[tuple[str, int]]:
    out = []
    for part in text.split(","):
        name, _, size = part.partition("=")
        if not size:
            raise argparse.ArgumentTypeError(
                f"mesh axis {part!r} is not name=size")
        out.append((name.strip(), int(size)))
    return out


def _add_service_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the passes run (default: the GPU)")
    ap.add_argument("--mesh", type=_parse_mesh, default=None,
                    metavar="data=2,model=4",
                    help="process mesh for backend='sharded' requests: "
                         "starts one rank per mesh position")
    ap.add_argument("--state-cache", default=None, metavar="PATH",
                    help="persist/restore the burned-state cache here "
                         "(npz; survives process restarts)")
    ap.add_argument("--max-batch-rows", type=int, default=4096)
    ap.add_argument("--max-wait-rounds", type=int, default=0)
    ap.add_argument("--fairness-rows", type=float, default=float("inf"),
                    help="Eq. (3) window over cumulative served rows "
                         "(laggard = GVT); inf disables")
    ap.add_argument("--quota-rows", type=float, default=float("inf"),
                    help="per-requester row budget per scheduling round; "
                         "inf disables")
    ap.add_argument("--engine-retries", type=int, default=0,
                    help="capped-backoff retries per failing pass before "
                         "the per-request error response")
    ap.add_argument("--state-cache-rows", type=int, default=65536,
                    help="LRU bound of the burned-state cache, in rows")
    ap.add_argument("--metrics-dir", default=None, metavar="DIR",
                    help="write atomic metrics.json/metrics.prom snapshots "
                         "here (live paper observables + service health)")
    ap.add_argument("--trace", default=None, metavar="FILE",
                    help="record a Chrome-trace/Perfetto JSON here (one "
                         "span per coalesced pass, CompatKey-annotated)")


def _launch(args, argv) -> int | None:
    """As the launcher of ``--mesh``: run the ranks and return the exit
    code.  None when this process is to serve (no mesh, or a rank)."""
    if not args.mesh or launch.in_rank():
        return None
    world = math.prod(s for _, s in args.mesh)
    why = launch.world_problem(world, args.device)
    if why is not None:
        print(f"error: {why}", file=sys.stderr)
        return 2
    return launch.run_ranks(launch.self_command(argv, _MODULE), world)


def _build_telemetry(args, writer: bool):
    """A ``repro_torch.obs.Telemetry`` bundle when either flag asks for
    one; on a mesh, rank 0's alone."""
    if not writer or not (args.metrics_dir or args.trace):
        return None
    from ..obs import Telemetry, TraceRecorder
    return Telemetry(tracer=TraceRecorder() if args.trace else None)


def _serve(args, run) -> int:
    """Build the mesh (a rank) and the service, and ``run(service, tel,
    writer)``; exit 2 where the device cannot be had."""
    import torch.distributed as dist

    from .api import SweepService
    mesh = None
    try:
        if args.mesh:
            mesh = launch.init_rank(args.mesh, args.device)
        writer = mesh is None or dist.get_rank() == 0
        tel = _build_telemetry(args, writer)
        service = SweepService(device=args.device, mesh=mesh,
                               max_batch_rows=args.max_batch_rows,
                               max_wait_rounds=args.max_wait_rounds,
                               fairness_rows=args.fairness_rows,
                               quota_rows=args.quota_rows,
                               engine_retries=args.engine_retries,
                               state_cache_rows=args.state_cache_rows,
                               telemetry=tel)
    except RuntimeError as e:            # no CUDA and --device cuda
        print(f"error: {e}", file=sys.stderr)
        return 2
    if tel is not None and tel.tracer is not None:
        from ..obs import set_tracer
        set_tracer(tel.tracer)     # library-level spans join the trace
    stats = run(service, tel, writer)
    if writer:
        print(_summary(stats), file=sys.stderr)
    if mesh is not None:
        dist.destroy_process_group()
    return 0


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


def _main_drain(argv, argv_given) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service",
        description="Drain a JSONL window-sweep request queue "
                    "(or: `serve` for daemon mode).")
    ap.add_argument("queue", help="JSONL file of wire-schema requests")
    ap.add_argument("--out", default=None,
                    help="responses JSONL path (default: stdout)")
    _add_service_args(ap)
    args = ap.parse_args(argv)
    rc = _launch(args, argv_given)
    if rc is not None:
        return rc

    def run(service, tel, writer):
        from .wire import serve_queue
        if args.state_cache and os.path.exists(args.state_cache):
            service.state_cache.load(args.state_cache)
        if not writer:
            with open(os.devnull, "w") as fh:
                return serve_queue(args.queue, fh, service=service)
        if args.out:
            with open(args.out, "w") as fh:
                stats = serve_queue(args.queue, fh, service=service)
        else:
            stats = serve_queue(args.queue, sys.stdout, service=service)
        if args.state_cache and service.state_cache.dirty:
            service.state_cache.save(args.state_cache)
        if tel is not None:
            if args.metrics_dir:
                from ..obs import write_snapshot
                write_snapshot(tel.registry, args.metrics_dir)
            if args.trace:
                tel.tracer.save(args.trace)
        return stats

    return _serve(args, run)


def _main_serve(argv, argv_given) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.service serve",
        description="Long-running watch-directory sweep-service daemon.")
    ap.add_argument("--intake", required=True, metavar="DIR",
                    help="directory watched for *.jsonl request files "
                         "(processed files are renamed to *.done)")
    ap.add_argument("--out", default="responses.jsonl",
                    help="responses JSONL, append mode (default: "
                         "responses.jsonl)")
    ap.add_argument("--poll", type=float, default=0.25, metavar="SECONDS",
                    help="idle poll interval")
    ap.add_argument("--idle-exit-rounds", type=int, default=None,
                    metavar="N",
                    help="exit cleanly after N consecutive idle rounds "
                         "(default: run until SIGTERM)")
    ap.add_argument("--max-rounds", type=int, default=None, metavar="N",
                    help="hard cap on serve rounds (tests/smoke)")
    ap.add_argument("--max-line-bytes", type=int, default=None, metavar="N",
                    help="intake cap per request line (default 1 MiB); "
                         "longer lines get structured oversize errors")
    ap.add_argument("--max-files-per-round", type=int, default=None,
                    metavar="N",
                    help="intake meter: at most N request files per round")
    ap.add_argument("--crash-after-passes", type=int, default=None,
                    help=argparse.SUPPRESS)   # fault injection (tests)
    _add_service_args(ap)
    args = ap.parse_args(argv)
    rc = _launch(args, argv_given)
    if rc is not None:
        return rc

    def run(service, tel, writer):
        from .daemon import DaemonConfig, serve_daemon
        from .wire import DEFAULT_MAX_LINE_BYTES
        cfg = DaemonConfig(
            intake_dir=args.intake, out_path=args.out,
            state_cache_path=args.state_cache,
            poll_interval_s=args.poll,
            max_line_bytes=(DEFAULT_MAX_LINE_BYTES
                            if args.max_line_bytes is None
                            else args.max_line_bytes),
            max_files_per_round=args.max_files_per_round,
            idle_exit_rounds=args.idle_exit_rounds,
            max_rounds=args.max_rounds,
            crash_after_passes=args.crash_after_passes,
            metrics_dir=args.metrics_dir if writer else None,
            trace_path=args.trace if writer else None)
        return serve_daemon(cfg, service=service)

    return _serve(args, run)


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    if args and args[0] == "serve":
        return _main_serve(args[1:], argv)
    return _main_drain(args, argv)


if __name__ == "__main__":
    sys.exit(main())
