"""The port's spans on the profiler's clock (``repro_torch.obs.trace``).

Every span has two listeners: a :class:`TraceRecorder` (the ambient one,
or a service's telemetry), and a recording ``torch.profiler``, which sees
it as a ``user_annotation`` on the caller's thread.  On the CPU:

* with neither listener ``span()`` hands back the shared no-op context,
  and a span only the profiler sees yields None (no ``sync_if_traced``
  site synchronizes for it); the recorder's JSON is the golden file's
  with the profiler on;
* a small ``SweepService`` drain under the profiler exports every span of
  the service, the state cache and the engine, nested as the code nests
  them, each chunk's aten operations inside its span; responses are the
  same bits with the profiler on and off;
* each ``pass`` span carries the bytes its burned-state splice moved;
* the daemon installs its tracer as the ambient one while it serves, so
  the engine's spans reach its trace file.
"""
import json
import os
import threading

import pytest
from torch.profiler import ProfilerActivity, profile

from repro_torch import obs as tobs
from repro_torch.experiments.sweep import WindowSweep
from repro_torch.obs import summarize as tsum
from repro_torch.obs import trace as ttrace
from repro_torch.service import SweepService
from repro_torch.service.daemon import DaemonConfig, serve_daemon
from repro_torch.service.wire import encode_request

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
L = 16
COMMON = dict(Ls=(L,), n_vs=(2,), replicas=4, n_steps=32, burn_in=16,
              backend="pallas_multistep", k_fuse=8)
#: every span under ``SweepService.drain``, by layer
SERVICE = ("service.schedule", "pass", "service.reduce", "service.flush",
           "service.observe")
STATE_CACHE = ("state_cache.lookup", "state_cache.to_host", "state_cache.put",
               "state_cache.assemble", "state_cache.to_device")
ENGINE = ("engine.run", "engine.chunk", "engine.advance")
#: bytes of one row of burned state: τ and the Kahan pair, float32
ROW_BYTES = 4 * (L + 2)


def _profiled(fn, tmp_path):
    """``fn()`` under a CPU profiler; its result and the exported events."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    return out, json.loads(path.read_text())["traceEvents"]


def _inside(a, b) -> bool:
    """Whether complete event ``a`` lies within ``b`` (same thread)."""
    eps = 1e-3
    return a["tid"] == b["tid"] and a["ts"] >= b["ts"] - eps and \
        a["ts"] + a["dur"] <= b["ts"] + b["dur"] + eps


def _disjoint(a, b) -> bool:
    return a["ts"] + a["dur"] <= b["ts"] or b["ts"] + b["dur"] <= a["ts"]


def _drain(telemetry=None):
    """Two rounds: a burned pass, then its extension from the state cache
    and a pass without burn-in; the streamed responses."""
    svc = SweepService(device="cpu", telemetry=telemetry)
    got = []
    svc.on_response = got.append
    svc.submit(WindowSweep(deltas=(2.0, 4.0), **COMMON), requester="alice")
    svc.drain()
    svc.submit(WindowSweep(deltas=(2.0, 4.0), **dict(COMMON, n_steps=64)),
               requester="dave")
    svc.submit(WindowSweep(deltas=(4.0,), **dict(COMMON, burn_in=0)),
               requester="erin")
    svc.drain()
    return got


# ---------------------------------------------------------------------------
# the span API
# ---------------------------------------------------------------------------


def test_span_is_the_shared_null_without_recorder_or_profiler():
    assert tobs.current_tracer() is None
    assert tobs.span("engine.chunk") is ttrace._NULL
    assert tobs.span_on(None, "pass", args={"n": 1}) is ttrace._NULL
    assert tobs.Telemetry().spans("pass") is ttrace._NULL


def test_profiler_only_span_yields_none_and_annotates(tmp_path):
    def body():
        yielded = []
        for ctx in (tobs.span("a.ambient"), tobs.Telemetry().spans("a.tel"),
                    tobs.span_on(None, "a.none")):
            with ctx as sp:
                yielded.append(sp)
        with pytest.raises(RuntimeError):
            with tobs.span("a.raises"):
                raise RuntimeError("x")
        return yielded

    yielded, events = _profiled(body, tmp_path)
    assert yielded == [None, None, None]
    tid = threading.get_native_id()
    ann = {e["name"] for e in events if e.get("cat") == "user_annotation"
           and e["tid"] == tid}
    assert {"a.ambient", "a.tel", "a.none", "a.raises"} <= ann


def test_recorder_json_is_golden_under_the_profiler(tmp_path):
    clock = iter(range(100))

    def body():
        tr = tobs.TraceRecorder(clock=lambda: float(next(clock)), pid=1)
        with tr.span("round", cat="daemon", args={"round": 1}):
            with tr.span("pass", cat="service") as sp:
                sp.args.update(n_rows=12, rows_burned=12, rows_from_cache=0)
            with tr.span("reduce"):
                pass
        return tr

    tr, events = _profiled(body, tmp_path)
    tr.save(tmp_path / "port.json")
    with open(os.path.join(GOLDEN, "obs_trace.json")) as fh:
        assert (tmp_path / "port.json").read_text() == fh.read()
    ann = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert sorted(ann) == ["pass", "reduce", "round"]


# ---------------------------------------------------------------------------
# the service's drain under the profiler
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_telemetry", [False, True],
                         ids=["no_telemetry", "telemetry"])
def test_drain_spans_nest_on_the_profiler_clock(with_telemetry, tmp_path):
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder()) if with_telemetry \
        else None
    _, events = _profiled(lambda: _drain(tel), tmp_path)
    tid = threading.get_native_id()
    ann = [e for e in events if e.get("cat") == "user_annotation"]
    by = {}
    for e in ann:
        by.setdefault(e["name"], []).append(e)
    wanted = SERVICE + STATE_CACHE + ENGINE
    if not with_telemetry:       # the telemetry's own cost is absent
        wanted = tuple(n for n in wanted if n != "service.observe")
        assert "service.observe" not in by
    for name in wanted:
        assert by.get(name), name
        assert {e["tid"] for e in by[name]} == {tid}, name
    passes = by["pass"]
    assert len(passes) == 3
    for e in by["engine.run"] + [e for n in STATE_CACHE for e in by[n]] \
            + by["service.reduce"]:
        assert any(_inside(e, p) for p in passes), e["name"]
    for e in by["engine.chunk"]:
        assert any(_inside(e, r) for r in by["engine.run"])
    for e in by["engine.advance"]:
        assert any(_inside(e, c) for c in by["engine.chunk"])
    # at K = 8: burn 16 and measure 32, measure 64 (from the cache),
    # measure 32 (no burn-in): 2 + 4 + 8 + 4 chunks
    assert len(by["engine.chunk"]) == len(by["engine.advance"]) == 18
    # a chunk's aten operations lie inside its span, none straddles it,
    # and its rebase (one amin outside the advance) is among them
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == tid]
    for chunk in by["engine.chunk"]:
        (adv,) = [a for a in by["engine.advance"] if _inside(a, chunk)]
        assert all(_inside(op, chunk) or _disjoint(op, chunk) for op in ops)
        rebase = [op for op in ops if op["name"] == "aten::amin"
                  and _inside(op, chunk) and not _inside(op, adv)]
        assert len(rebase) == 1


def test_responses_bit_identical_with_the_profiler(tmp_path):
    plain = _drain()
    profiled, _ = _profiled(_drain, tmp_path)
    assert [r.result.records for r in profiled] == \
        [r.result.records for r in plain]
    assert all(r.error is None for r in plain) and len(plain) == 3


# ---------------------------------------------------------------------------
# the byte counters
# ---------------------------------------------------------------------------


def test_pass_span_counts_the_bytes_its_splice_moved():
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    _drain(tel)
    args = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    rows = 2 * COMMON["replicas"]
    assert [a["n_rows"] for a in args] == [rows, rows, COMMON["replicas"]]
    moved = [(a["state_bytes_to_host"], a["state_bytes_to_device"])
             for a in args]
    # burned: every row down and up; extension: up from the cache; no
    # burn-in: the state starts on the device
    assert moved == [(rows * ROW_BYTES, rows * ROW_BYTES),
                     (0, rows * ROW_BYTES), (0, 0)]
    assert [a["rows_burned"] for a in args] == [rows, 0, 0]


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


def test_daemon_trace_holds_engine_spans_inside_passes(tmp_path):
    intake = tmp_path / "intake"
    intake.mkdir()
    spec = WindowSweep(deltas=(2.0, 4.0), **COMMON)
    (intake / "a.jsonl").write_text(
        json.dumps(encode_request(spec, "alice")) + "\n")
    trace_path = tmp_path / "trace.json"
    cfg = DaemonConfig(intake_dir=str(intake),
                       out_path=str(tmp_path / "responses.jsonl"),
                       poll_interval_s=0.01, idle_exit_rounds=2,
                       metrics_dir=str(tmp_path / "metrics"),
                       trace_path=str(trace_path))
    stats = serve_daemon(cfg, service=SweepService(device="cpu"),
                         log=lambda _msg: None)
    assert stats.n_passes == 1 and stats.n_errors == 0
    assert tobs.current_tracer() is None          # restored on exit
    events = json.loads(trace_path.read_text())["traceEvents"]
    by = {}
    for e in events:
        by.setdefault(e["name"], []).append(e)
    (p,) = by["pass"]
    # burn 16 + measure 32 at K = 8
    assert len(by["engine.chunk"]) == 6
    assert all(_inside(c, p) for c in by["engine.chunk"])
    assert all(_inside(s, p) for s in by["state_cache.put"])
    assert tsum.main(["summarize", "--check", str(tmp_path / "metrics"),
                      str(trace_path)]) == 0
