"""Telemetry of the port (``repro_torch.obs``) against ``repro.obs``.

The counterparts of ``tests/test_obs.py``, with the reference computed
beside the port in the same test:

* the registry's semantics (monotone counters, get-or-create, series that
  exist from their first update only);
* exposition: for the same registry operations the port's Prometheus
  text, snapshot JSON, JSONL sink and ``metrics.json``/``metrics.prom``
  pair equal ``repro.obs``'s byte for byte (and the golden files of
  ``tests/golden``); the same for a trace under a fixed clock;
* ``summarize --check``: each package's CLI accepts the other's files and
  rejects the same broken ones with the same problems;
* the service's instruments are off-path: responses with telemetry on
  equal responses with it off, bit for bit, on the CPU and on 8 gloo
  ranks; the port's service snapshot is held to ``repro``'s on the same
  queue (names, kinds, labels, help texts and counters equal, histogram
  counts equal, the sums of ``repro_pass_u`` and ``repro_pass_gvt_rate``
  bitwise, ``repro_pass_w2`` and ``repro_pass_window_occupancy`` to
  ``RTOL``, wall-clock phase histograms left out);
* the daemon writes its snapshots and its trace.
"""
import itertools
import json
import math
import os
import textwrap

import pytest

import repro.obs as jobs
import repro.service as jsvc
from repro.obs import summarize as jsum
from repro_torch import obs as tobs
from repro_torch.core import horizon as th
from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
from repro_torch.obs import summarize as tsum
from repro_torch.service import SweepService, decode_request
from repro_torch.service.api import ServiceStats
from repro_torch.service.daemon import DaemonConfig, serve_daemon
from repro_torch.service.wire import encode_request

from torch_parity import (assert_service_snapshot_matches, jax_eta_table,
                          run_ranks)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE = os.path.join(REPO, "examples", "service_queue.jsonl")
COMMON = dict(Ls=(16,), n_vs=(2,), replicas=4, n_steps=32, burn_in=16,
              backend="pallas_multistep", k_fuse=8)
#: package -> (its obs, its summarize)
PKGS = {"repro": (jobs, jsum), "repro_torch": (tobs, tsum)}


# ---------------------------------------------------------------------------
# metrics core
# ---------------------------------------------------------------------------


def test_counter_monotone():
    c = tobs.MetricsRegistry().counter("c", "help text")
    c.inc()
    c.inc(2.5, requester="alice")
    assert c.value() == 1.0
    assert c.value(requester="alice") == 2.5
    with pytest.raises(ValueError):
        c.inc(-1)


def test_counter_set_total_mirrors_external_ledger():
    c = tobs.MetricsRegistry().counter("c")
    c.set_total(5)
    c.set_total(5)
    c.set_total(9)
    assert c.value() == 9.0
    with pytest.raises(ValueError):
        c.set_total(3)


def test_gauge_goes_both_ways():
    g = tobs.MetricsRegistry().gauge("g")
    g.set(4.0)
    g.set(1.5)
    assert g.value() == 1.5
    assert g.value(other="labels") == 0.0


def test_histogram_counts_and_validation():
    reg = tobs.MetricsRegistry()
    h = reg.histogram("h", buckets=(1.0, 2.0, 4.0))
    for v in (0.5, 1.0, 3.0, 100.0):
        h.observe(v)
    (series,) = h.series.values()
    assert series["counts"] == [2, 0, 1, 1]      # le=1 is inclusive
    assert series["count"] == 4 == h.count()
    assert series["sum"] == pytest.approx(104.5)
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=())
    with pytest.raises(ValueError):
        reg.histogram("bad", buckets=(1.0, 1.0))


def test_registry_get_or_create_and_kind_clash():
    reg = tobs.MetricsRegistry()
    assert reg.counter("x") is reg.counter("x")
    with pytest.raises(TypeError):
        reg.gauge("x")
    assert len(reg) == 1


def test_series_materialize_on_first_update_only():
    reg = tobs.MetricsRegistry(clock=lambda: 0.0)
    reg.counter("never_used")
    reg.histogram("never_observed")
    assert reg.snapshot()["series"] == []
    assert tobs.to_prometheus(reg) == ""


# ---------------------------------------------------------------------------
# exposition: the port's bytes are the reference's
# ---------------------------------------------------------------------------


def _golden_registry(obs):
    """tests/test_obs.py's golden operations on ``obs``'s registry."""
    reg = obs.MetricsRegistry(clock=lambda: 1700000000.0)
    reg.counter("repro_service_requests", "wire requests accepted").inc(5)
    served = reg.counter("repro_service_served_rows",
                         "rows returned, by requester", unit="rows")
    served.inc(8, requester="alice")
    served.inc(4, requester="bob")
    reg.gauge("repro_service_coalescing_ratio",
              "rows requested / rows computed").set(1.5)
    u = reg.histogram("repro_pass_u", "per-pass mean utilization",
                      buckets=(0.25, 0.5, 1.0))
    u.observe(0.125)
    u.observe(0.75)
    reg.histogram("repro_pass_w2", "per-pass mean squared width",
                  unit="tau^2", buckets=(1.0, 4.0, 16.0)).observe(2.5)
    reg.histogram("repro_pass_window_occupancy", "spread / Delta",
                  buckets=(0.5, 1.0)).observe(0.8)
    return reg


def test_prometheus_and_snapshot_equal_repro():
    port, ref = _golden_registry(tobs), _golden_registry(jobs)
    text = tobs.to_prometheus(port)
    assert text == jobs.to_prometheus(ref)
    with open(os.path.join(GOLDEN, "obs_metrics.prom")) as fh:
        assert text == fh.read()
    assert json.dumps(port.snapshot()) == json.dumps(ref.snapshot())
    # odd floats and label escaping take the same spelling
    texts = []
    for obs in (tobs, jobs):
        r = obs.MetricsRegistry(clock=lambda: 0.5)
        r.counter("c").inc(1, path='a"b\\c\nd')
        r.gauge("g").set(float("inf"))
        r.gauge("g").set(1e20, k="big")
        r.histogram("h", buckets=(0.1,)).observe(1 / 3)
        texts.append((obs.to_prometheus(r), json.dumps(r.snapshot())))
    assert texts[0] == texts[1]
    assert 'c{path="a\\"b\\\\c\\nd"} 1' in texts[0][0]


def _step_clock(step=1.0):
    counter = itertools.count()
    return lambda: step * next(counter)


def _golden_tracer(obs):
    tr = obs.TraceRecorder(clock=_step_clock(), pid=1)
    with tr.span("round", cat="daemon", args={"round": 1}):
        with tr.span("pass", cat="service") as sp:
            sp.args.update(n_rows=12, rows_burned=12, rows_from_cache=0)
        with tr.span("reduce"):
            pass
    return tr


def test_trace_equals_repro_and_golden(tmp_path):
    _golden_tracer(tobs).save(tmp_path / "port.json")
    _golden_tracer(jobs).save(tmp_path / "ref.json")
    text = (tmp_path / "port.json").read_text()
    assert text == (tmp_path / "ref.json").read_text()
    with open(os.path.join(GOLDEN, "obs_trace.json")) as fh:
        assert text == fh.read()
    assert tsum.check_trace(tsum.load_any(tmp_path / "port.json")[1]) == []


def test_trace_span_error_annotation():
    tr = tobs.TraceRecorder(clock=_step_clock(), pid=1)
    with pytest.raises(RuntimeError):
        with tr.span("boom"):
            raise RuntimeError("x")
    (ev,) = tr.events
    assert ev["args"]["error"] == "RuntimeError"


def test_ambient_tracer_helper_and_telemetry_spans():
    assert tobs.current_tracer() is None
    with tobs.span("nothing") as sp:
        assert sp is None
    tr = tobs.TraceRecorder()
    prev = tobs.set_tracer(tr)
    try:
        assert prev is None and tobs.current_tracer() is tr
        with tobs.span("real") as sp:
            assert sp is not None
        assert [e["name"] for e in tr.events] == ["real"]
    finally:
        tobs.set_tracer(prev)
    assert tobs.current_tracer() is None
    with tobs.Telemetry().spans("inert") as sp:     # no tracer: inert
        assert sp is None
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    with tel.spans("pass", cat="service", args={"n": 1}) as sp:
        assert sp is not None
    assert [(e["name"], e["cat"]) for e in tel.tracer.events] == \
        [("pass", "service")]


# ---------------------------------------------------------------------------
# sinks + snapshot files
# ---------------------------------------------------------------------------


def test_jsonl_sink_appends_and_loads_last(tmp_path):
    for name, (obs, summ) in PKGS.items():
        path = tmp_path / f"{name}.jsonl"
        reg = _golden_registry(obs)
        obs.append_jsonl(reg, path)
        reg.counter("repro_service_requests").inc(1)
        obs.append_jsonl(reg, path)
    text = (tmp_path / "repro_torch.jsonl").read_text()
    assert text == (tmp_path / "repro.jsonl").read_text()
    assert len(text.splitlines()) == 2
    kind, snap = tsum.load_any(tmp_path / "repro_torch.jsonl")
    assert kind == "metrics"
    (req,) = [s for s in snap["series"]
              if s["name"] == "repro_service_requests"]
    assert req["value"] == 6.0 and snap["ts"] == 1700000000.0


def test_write_snapshot_atomic_pair_equals_repro(tmp_path):
    for name, (obs, _) in PKGS.items():
        reg = _golden_registry(obs)
        snap = obs.write_snapshot(reg, tmp_path / name)
        d = tmp_path / name
        assert sorted(os.listdir(d)) == ["metrics.json", "metrics.prom"]
        assert (d / "metrics.prom").read_text() == obs.to_prometheus(reg)
        assert json.loads((d / "metrics.json").read_text()) == snap
    for base in ("metrics.json", "metrics.prom"):
        assert (tmp_path / "repro_torch" / base).read_bytes() == \
            (tmp_path / "repro" / base).read_bytes()
    kind, loaded = tsum.load_any(tmp_path / "repro_torch")
    assert kind == "metrics" and loaded == snap


# ---------------------------------------------------------------------------
# summarize --check: either package's gate on either package's files
# ---------------------------------------------------------------------------


def _broken_files():
    base = {"cat": "t", "ph": "X", "pid": 1, "tid": 1}
    reg = tobs.MetricsRegistry(clock=lambda: 0.0)
    reg.counter("repro_service_requests").inc(1)
    return {
        "empty": {"ts": 0.0, "series": []},
        "missing_observables": reg.snapshot(),
        "bad_histogram": {"series": [{
            "name": "h", "type": "histogram", "buckets": [1.0],
            "counts": [1, 0], "count": 3, "sum": 0.5}]},
        "non_nesting": {"traceEvents": [dict(base, name="a", ts=0, dur=10),
                                        dict(base, name="b", ts=5, dur=10)]},
        "no_spans": {"traceEvents": []},
    }


@pytest.mark.parametrize("case", sorted(_broken_files()))
def test_check_rejects_what_repro_rejects(case, tmp_path, capsys):
    obj = _broken_files()[case]
    path = tmp_path / f"{case}.json"
    path.write_text(json.dumps(obj))
    kind = "trace" if "traceEvents" in obj else "metrics"
    check = "check_trace" if kind == "trace" else "check_metrics"
    problems = getattr(tsum, check)(obj)
    assert problems and problems == getattr(jsum, check)(obj)
    for _, summ in PKGS.values():
        assert summ.main(["summarize", "--check", str(path)]) == 1
        assert "CHECK FAIL" in capsys.readouterr().out


def test_check_accepts_nesting_and_plain_snapshots():
    base = {"cat": "t", "ph": "X", "pid": 1, "tid": 1}
    ok = {"traceEvents": [dict(base, name="outer", ts=0, dur=10),
                          dict(base, name="inner", ts=2, dur=3),
                          dict(base, name="later", ts=20, dur=5),
                          dict(base, name="lane2", ts=5, dur=10, tid=2)]}
    reg = tobs.MetricsRegistry(clock=lambda: 0.0)
    reg.counter("repro_bench_calls").inc(1)      # not a service snapshot
    for _, summ in PKGS.values():
        assert summ.check_trace(ok) == []
        assert summ.check_metrics(reg.snapshot()) == []
    assert tsum.REQUIRED_SERVICE_SERIES == jsum.REQUIRED_SERVICE_SERIES


@pytest.mark.parametrize("writer,checker",
                         list(itertools.product(PKGS, PKGS)))
def test_summarize_cli_cross_package(writer, checker, tmp_path, capsys):
    obs, _ = PKGS[writer]
    mdir = tmp_path / "metrics"
    obs.write_snapshot(_golden_registry(obs), mdir)
    _golden_tracer(obs).save(tmp_path / "trace.json")
    summ = PKGS[checker][1]
    assert summ.main(["summarize", "--check", str(mdir),
                      str(tmp_path / "trace.json")]) == 0
    out = capsys.readouterr().out
    assert out.count("check ok") == 2
    assert "repro_pass_u" in out and "round" in out


# ---------------------------------------------------------------------------
# the service: off-path, bit for bit; its snapshot against repro's
# ---------------------------------------------------------------------------


def _serve_once(telemetry):
    spec = WindowSweep(deltas=(2.0, 4.0, math.inf), **COMMON)
    svc = SweepService(device="cpu", telemetry=telemetry)
    svc.submit(spec, requester="alice")
    (resp,) = svc.drain()
    assert resp.error is None
    return resp.result


def test_service_telemetry_is_off_path_bit_identical():
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    with_tel = _serve_once(tel)
    without = _serve_once(None)
    assert with_tel.records == without.records
    assert with_tel.records == run_window_sweep(with_tel.spec,
                                                device="cpu").records
    snap = tel.registry.snapshot()
    assert tsum.check_metrics(snap) == [] == jsum.check_metrics(snap)
    by_name = {}
    for s in snap["series"]:
        by_name.setdefault(s["name"], []).append(s)
    for req in ("repro_pass_u", "repro_pass_w2", "repro_pass_gvt_rate",
                "repro_pass_window_occupancy"):
        assert sum(s["count"] for s in by_name[req]) == 1, req
    (served,) = by_name["repro_service_served_rows"]
    assert served["labels"] == {"requester": "alice"}
    passes = [e for e in tel.tracer.events if e["name"] == "pass"]
    assert len(passes) == 1
    args = passes[0]["args"]
    assert args["L"] == 16 and args["n_v"] == 2
    assert args["backend"] == COMMON["backend"]
    assert args["n_rows"] == 3 * COMMON["replicas"] and args["n_pad"] == 0
    assert args["rows_burned"] + args["rows_from_cache"] == args["n_rows"]
    assert args["requesters"] == ["alice"]
    assert tsum.check_trace(tel.tracer.to_dict()) == []


def test_service_snapshot_matches_repro():
    with open(QUEUE) as fh:
        lines = [json.loads(li) for li in fh.read().strip().splitlines()]
    jtel = jobs.Telemetry(registry=jobs.MetricsRegistry(clock=lambda: 0.0))
    ttel = tobs.Telemetry(registry=tobs.MetricsRegistry(clock=lambda: 0.0))
    jax_service = jsvc.SweepService(telemetry=jtel)
    port_service = SweepService(device="cpu", telemetry=ttel)
    follow = []
    for obj in lines:
        jax_service.submit(jsvc.decode_request(obj)[0],
                           requester=obj["requester"])
        port_service.submit(decode_request(obj)[0],
                            requester=obj["requester"])
        obj = json.loads(json.dumps(obj))
        obj["spec"]["n_steps"] = 48         # a second pass, from the cache
        follow.append(obj)
    jax_service.drain()
    with th.eta_override(jax_eta_table()):
        port_service.drain()
        for obj in follow[:2]:
            jax_service.submit(jsvc.decode_request(obj)[0],
                               requester=obj["requester"])
            port_service.submit(decode_request(obj)[0],
                                requester=obj["requester"])
        jax_service.drain()
        port_service.drain()
    assert port_service.stats.as_dict() == jax_service.stats.as_dict()
    assert port_service.stats.rows_from_state_cache > 0
    assert_service_snapshot_matches(ttel.registry.snapshot(),
                                    jtel.registry.snapshot())


def test_service_stats_snapshot_diff():
    a = ServiceStats()
    a.n_requests, a.rows_computed = 3, 100
    snap = a.snapshot()
    a.n_requests, a.rows_computed = 5, 160
    d = a.diff(snap)
    assert (d.n_requests, d.rows_computed) == (2, 60)
    assert d.n_errors == 0
    assert snap.n_requests == 3            # snapshot is an isolated copy
    assert isinstance(d, ServiceStats)


# ---------------------------------------------------------------------------
# the daemon's exposition, and the sweep's spans
# ---------------------------------------------------------------------------


def test_daemon_writes_snapshots_and_trace(tmp_path):
    intake = tmp_path / "intake"
    intake.mkdir()
    spec = WindowSweep(deltas=(2.0, 4.0), **COMMON)
    (intake / "a.jsonl").write_text(
        json.dumps(encode_request(spec, "alice")) + "\n")
    cfg = DaemonConfig(intake_dir=str(intake),
                       out_path=str(tmp_path / "responses.jsonl"),
                       poll_interval_s=0.01, idle_exit_rounds=2,
                       metrics_dir=str(tmp_path / "metrics"),
                       trace_path=str(tmp_path / "trace.json"))
    lines = []
    stats = serve_daemon(cfg, service=SweepService(device="cpu"),
                         log=lines.append)
    assert stats.n_requests == 1 and stats.n_errors == 0
    round_lines = [ln for ln in lines if ln.startswith("round ")]
    assert any("+1 request(s)" in ln and "1 pass(es)" in ln
               for ln in round_lines)
    mdir = tmp_path / "metrics"
    assert sorted(os.listdir(mdir)) == ["metrics.json", "metrics.prom"]
    for _, summ in PKGS.values():       # both gates accept the port's files
        assert summ.main(["summarize", "--check", str(mdir),
                          str(tmp_path / "trace.json")]) == 0
    prom = (mdir / "metrics.prom").read_text()
    for name in (*tsum.REQUIRED_SERVICE_SERIES, "repro_daemon_rounds",
                 "repro_daemon_phase_seconds", "repro_service_queue_depth",
                 "repro_service_phase_seconds"):
        assert name in prom, name
    trace = json.loads((tmp_path / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"]]
    assert names.count("pass") == stats.n_passes == 1
    rounds = [e for e in trace["traceEvents"] if e["name"] == "round"]
    assert rounds and rounds[0]["args"]["n_passes"] == 1
    (resp,) = (tmp_path / "responses.jsonl").read_text().splitlines()
    assert json.loads(resp)["result"]["records"] == \
        run_window_sweep(spec, device="cpu").as_dict()["records"]


def test_sweep_emits_phase_spans_under_ambient_tracer():
    spec = WindowSweep(deltas=(2.0,), **COMMON)
    baseline = run_window_sweep(spec, device="cpu")
    tr = tobs.TraceRecorder()
    prev = tobs.set_tracer(tr)
    try:
        traced = run_window_sweep(spec, device="cpu")
    finally:
        tobs.set_tracer(prev)
    assert traced.records == baseline.records
    names = [e["name"] for e in tr.events]
    assert [names.count(n) for n in ("burn", "measure", "reduce")] == \
        [1, 1, 1]
    (burn,) = [e for e in tr.events if e["name"] == "burn"]
    assert burn["args"]["rows"] == spec.n_trajectories
    assert burn["args"]["steps"] == COMMON["burn_in"]
    assert tsum.check_trace(tr.to_dict()) == []


# ---------------------------------------------------------------------------
# 8 gloo ranks: telemetry on rank 0 alone moves no bit and no collective
# ---------------------------------------------------------------------------

_MESH_SCRIPT = textwrap.dedent("""
    import datetime, json, math, os
    import torch, torch.distributed as dist
    from repro_torch.core.mesh import make_mesh
    from repro_torch.experiments.sweep import WindowSweep
    from repro_torch.obs import Telemetry, TraceRecorder
    from repro_torch.obs.summarize import check_metrics, check_trace
    from repro_torch.service import SweepService

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method="file://" + os.environ["STORE"], rank=rank,
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    spec = WindowSweep(Ls=(16,), n_vs=(2,), deltas=(1.0, 2.0, 4.0, math.inf),
                       replicas=4, n_steps=16, burn_in=8,
                       backend="sharded", k_fuse=4)

    def serve(telemetry):
        svc = SweepService(mesh=mesh, telemetry=telemetry)
        svc.submit(spec, requester="alice")
        (resp,) = svc.drain()
        assert resp.error is None, resp.error
        return resp.result

    # telemetry on rank 0 only, the way the CLI runs it
    tel = Telemetry(tracer=TraceRecorder()) if rank == 0 else None
    with_tel = serve(tel)
    without = serve(None)
    out = {"with": json.dumps(with_tel.as_dict()),
           "without": json.dumps(without.as_dict())}
    if rank == 0:
        passes = [e for e in tel.tracer.events if e["name"] == "pass"]
        out.update(metrics_ok=check_metrics(tel.registry.snapshot()) == [],
                   trace_ok=check_trace(tel.tracer.to_dict()) == [],
                   n_pass_spans=len(passes))
    with open(os.path.join(os.environ["OUT"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.mark.distributed
def test_sharded_service_telemetry_bit_identical(tmp_path):
    run_ranks(_MESH_SCRIPT, 8, tmp_path, env={"OUT": str(tmp_path)})
    outs = [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(8)]
    for out in outs:
        assert out["with"] == out["without"] == outs[0]["with"]
    assert outs[0]["metrics_ok"] and outs[0]["trace_ok"]
    assert outs[0]["n_pass_spans"] == 1
