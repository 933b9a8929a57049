"""One run of one cell: set-up, the measured window, the check, the line.

The window drives ``repro_torch.service.api.SweepService`` as a closed
loop: each round's requests (``traffic.rounds``) are submitted together,
then ``drain`` runs them, streaming each response through ``on_response``;
the next round starts once every response of the round is back.  The
window closes after the round in flight at ``seconds``.

Everything that belongs to one cell is found by name under ``bench/``:
its configuration, mix and sizes (``configs/``, ``mixes/``, ``cells/``),
the reference its configuration names (``reference/<name>.py``) and, in a
traced run, the reader of each per-layer metric that lists the cell
(``metrics/<name>.py``, a ``read(record)`` that returns a number or
None).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import pathlib
import sys
import time
from contextlib import nullcontext

import numpy as np

from . import check, devtrace, roofline, traffic

#: Seconds of rounds a traced run profiles, unless its cell names
#: ``trace_rounds``.
TRACE_SECONDS = 3.0
#: Modules that no run may load (whole top-level names).
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        up = float(f.read().split()[0])
    return up - start / os.sysconf("SC_CLK_TCK")


def _json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root, name: str) -> dict:
    """A cell's data, found by the workload's name in ``BENCHMARK.json``,
    and its reference module; a configuration with a key no reader knows
    is refused (``traffic.check_config``)."""
    root = pathlib.Path(root)
    spec = _json(root / "BENCHMARK.json")
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    bench = root / "bench"
    config = _json(root / conf["file"])
    traffic.check_config(config)
    return {
        "name": name, "chips": int(w["chips"]),
        "config": config,
        "reference": check.load_reference(
            bench, config.get("reference", check.DEFAULT_REFERENCE)),
        "mix": _json(bench / "mixes" / f"{w['traffic']}.json"),
        "cell": _json(bench / "cells" / f"{name}.json"),
        "end_to_end": spec["end_to_end"],
        "per_layer": [m for m in spec["per_layer"]
                      if name in m.get("workloads", [name])],
        "bench": bench,
    }


def metric_reader(bench: pathlib.Path, name: str):
    """The ``read`` function of ``bench/metrics/<name>.py``."""
    path = bench / "metrics" / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no reader for metric {name!r} under "
                                f"{bench / 'metrics'}")
    mod_spec = importlib.util.spec_from_file_location(
        "bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is forbidden."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def check_spec(config: dict) -> None:
    """Refuse a configuration whose ``spec`` names a field that the port's
    ``WindowSweep`` lacks, before the service is built."""
    from repro_torch.experiments.sweep import WindowSweep
    lacks = sorted(set(traffic.spec_extra(config))
                   - {f.name for f in dataclasses.fields(WindowSweep)})
    if lacks:
        raise ValueError(f"the configuration's spec names {lacks}, which "
                         "WindowSweep lacks")


def _spec(q: dict):
    from repro_torch.experiments.sweep import WindowSweep
    return WindowSweep(**{k: v for k, v in q.items()
                          if k not in traffic.REQUEST_KEYS})


def _drive(svc, rounds, seconds: float, annotate, fields,
           clock=time.perf_counter, n_rounds: int = 0):
    """Run rounds until ``seconds`` have passed, or ``n_rounds`` rounds
    where it is not 0, logging each record's ``fields``; returns the round
    log, the window's (start, end) and the requests left unanswered."""
    log, unanswered = [], 0
    t0 = clock()
    while True:
        reqs = next(rounds)
        got = []
        svc.on_response = lambda resp: got.append((resp, clock()))
        with annotate("bench.submit"):
            t_sub = clock()
            for q in reqs:
                svc.submit(_spec(q), requester=q["requester"])
        with annotate("bench.drain"):
            svc.drain()
        by_who = {resp.requester: (resp, t) for resp, t in got}
        entries = []
        for q in reqs:
            if q["requester"] not in by_who:
                unanswered += 1
                continue
            resp, t = by_who[q["requester"]]
            entries.append({
                "request": q, "latency_s": t - t_sub,
                "error": resp.error, "cached": resp.cached,
                "records": None if resp.result is None else [
                    {"L": r.L, "n_v": r.n_v, "delta": r.delta,
                     **{f: getattr(r, f) for f in fields}}
                    for r in resp.result.records]})
        log.append(entries)
        if (len(log) >= n_rounds if n_rounds else clock() - t0 >= seconds):
            return log, (t0, clock()), unanswered


def run(root, name: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", out_dir=None,
        t_start: float | None = None) -> dict:
    """One run of cell ``name``; returns the result line's object."""
    import torch

    from repro_torch.service.api import SweepService
    cell = load_cell(root, name)
    conf, mix, sizes = cell["config"], cell["mix"], cell["cell"]
    check_spec(conf)
    ref = cell["reference"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    # set-up: the service, then warm-up rounds at the cell's own rows and
    # chunk (the second runs the extensions of the first)
    svc = SweepService(device=dev,
                       state_cache_rows=int(conf["state_cache_rows"]))
    warm = traffic.rounds(conf, mix, sizes, seed, warm=True)
    for _ in range(2):
        for q in next(warm):
            svc.submit(_spec(q), requester=q["requester"])
        svc.drain()
    sync()
    rounds = traffic.rounds(conf, mix, sizes, seed)
    window_s, n_rounds = seconds, 0
    annotate = lambda _name: nullcontext()  # noqa: E731
    log0, unanswered0 = [], 0
    if trace:
        # a cell that names ``trace_rounds`` traces that many rounds after
        # one untraced round, so that every traced round holds the
        # extensions of the round before it; the others, the first
        # TRACE_SECONDS of rounds
        n_rounds = int(sizes.get("trace_rounds", 0))
        if n_rounds:
            log0, _, unanswered0 = _drive(svc, rounds, 0.0, annotate,
                                          ref.RECORD_FIELDS, n_rounds=1)
        else:
            window_s = min(seconds, TRACE_SECONDS)
        from torch.profiler import ProfilerActivity, profile, record_function

        from repro_torch.obs import Telemetry, TraceRecorder
        tracer = TraceRecorder()
        svc.attach_telemetry(Telemetry(tracer=tracer))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
        annotate = record_function
    stats0 = svc.stats.snapshot()
    setup_s = (process_age() if t_start is None
               else time.perf_counter() - t_start)
    with annotate(devtrace.WINDOW):
        log, (t0, t1), unanswered = _drive(svc, rounds, window_s, annotate,
                                           ref.RECORD_FIELDS,
                                           n_rounds=n_rounds)
    sync()
    traced, log = log, log0 + log
    unanswered += unanswered0
    stats = svc.stats.diff(stats0)
    if trace:
        prof.__exit__(None, None, None)
        out = pathlib.Path(out_dir or cell["bench"] / "out")
        out.mkdir(parents=True, exist_ok=True)
        path = out / f"{name}.{seed}.trace.json"
        prof.export_chrome_trace(str(path))
        rec = devtrace.load(path)
        path.unlink()
        rec["spans"] = [e for e in tracer.events if e["name"] == "pass"]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    del svc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if trace:       # the card's peaks, read in this run, after its peak
        rec["card"] = roofline.card(dev) if cuda else None
        if cuda:
            print(f"[bench] card: {rec['card']}", file=sys.stderr)

    entries = [e for rnd in log for e in rnd]
    attempted = len(entries) + unanswered
    errors = sum(e["error"] is not None for e in entries)
    picked = check.sample(log, seed)
    keep = check.drawn(conf, seed)
    t_ref = time.perf_counter()
    refs = check.reference_records([e["request"] for e in picked], dev,
                                   keep=keep, reference=ref)
    t_ref = time.perf_counter() - t_ref
    numbers = check.compare([check.kept(e["records"], e["request"], keep)
                             if e["error"] is None else None
                             for e in picked], refs, reference=ref)
    limits = sizes["limits"]
    correct = check.judge(numbers, limits) and errors + unanswered == 0 \
        and bool(picked)
    print(f"[bench] {name} seed {seed}: {len(log)} rounds, {attempted} "
          f"requests in {t1 - t0:.3f} s; compared {len(picked)} responses "
          f"({'every point' if keep is None else f'{len(keep)} points'}) "
          f"with the reference in {t_ref:.3f} s", file=sys.stderr)

    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda
                   else dev.type, "count": 1, "memory_peak_bytes": int(peak)}
    metrics = {}
    units = {m["name"]: m["unit"] for m in
             cell["end_to_end"] + cell["per_layer"]}
    if trace:
        rec.update(stats=stats.as_dict(),
                   responses=[e for rnd in traced for e in rnd], config=conf,
                   cell=sizes, mix=mix)
        for m in cell["per_layer"]:
            v = metric_reader(cell["bench"], m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
        device_info.update(busy_s=rec["busy_s"], window_s=rec["window_s"])
    else:
        served = sum(traffic.pe_steps(e["request"]) for e in entries
                     if e["error"] is None)
        e2e = {"served_pe_steps_per_s": served / (t1 - t0),
               "response_p95_s": float(np.percentile(
                   [e["latency_s"] for e in entries], 95)),
               "setup_s": setup_s}
        for m in cell["end_to_end"]:
            if name in m.get("workloads", [name]):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": units[m["name"]]}
    result = {"correct": correct, "attempted": attempted,
              "failed": errors + unanswered, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": devtrace.top(rec["device_ops"]),
                               "idle_gaps": devtrace.top(rec["gaps"])}
    result["checks"] = {k: {"value": v if math.isfinite(v) else str(v),
                            "limit": limits[k]} for k, v in numbers.items()}
    return result
