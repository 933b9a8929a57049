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
* each ``pass`` span carries the bytes its burned-state splice moved
  between the cache's tiers: none while the device tier holds every row,
  and ``state_cache.to_host``/``.to_device`` spans only where rows cross;
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
from repro_torch.service import StateCache, SweepService
from repro_torch.service.daemon import DaemonConfig, serve_daemon
from repro_torch.service.wire import encode_request

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
L = 16
COMMON = dict(Ls=(L,), n_vs=(2,), replicas=4, n_steps=32, burn_in=16,
              backend="pallas_multistep", k_fuse=8)
#: every span under ``SweepService.drain``, by layer
SERVICE = ("service.schedule", "pass", "service.reduce", "service.flush",
           "service.observe")
STATE_CACHE = ("state_cache.lookup", "state_cache.put", "state_cache.assemble")
#: spans around rows that cross between the state cache's tiers
CROSSINGS = ("state_cache.to_host", "state_cache.to_device")
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


def _drain(telemetry=None, budget_rows=None):
    """Two rounds: a burned pass, then its extension from the state cache
    and a pass without burn-in; the streamed responses.  ``budget_rows``:
    the rows the cache's device tier may hold (None: unbounded)."""
    svc = SweepService(device="cpu")
    if budget_rows is not None:
        svc.state_cache = StateCache(device="cpu",
                                     budget_bytes=budget_rows * ROW_BYTES)
    svc.attach_telemetry(telemetry)
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
    # the device tier holds every row: nothing crosses to the host
    assert not any(name in by for name in CROSSINGS)
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
    # and its rebase is among them: on the fused path B1 takes it in its
    # store (here B1's plain version, inside the advance: an amin a step
    # for the GVT and one for the `min` moment, then the rebase's), and
    # the chunk loop takes no amin of its own
    ops = [e for e in events if e.get("cat") == "cpu_op"
           and e.get("tid") == tid]
    for chunk in by["engine.chunk"]:
        (adv,) = [a for a in by["engine.advance"] if _inside(a, chunk)]
        assert all(_inside(op, chunk) or _disjoint(op, chunk) for op in ops)
        amins = [op for op in ops if op["name"] == "aten::amin"
                 and _inside(op, chunk)]
        assert not [op for op in amins if not _inside(op, adv)]
        assert len(amins) == 2 * 8 + 1


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
    # the device tier holds every row: the burned rows stay on the
    # device, the extension gathers them there, the pass without burn-in
    # starts on the device
    assert moved == [(0, 0), (0, 0), (0, 0)]
    assert [a["rows_burned"] for a in args] == [rows, 0, 0]
    assert [a["rows_from_device_cache"] for a in args] == [0, rows, 0]
    assert [(a["rows_promoted"], a["rows_demoted"]) for a in args] == \
        [(0, 0)] * 3


def test_spans_name_b1s_tier_and_count_its_device_bytes(monkeypatch):
    """The fused path's ``engine.run`` and ``pass`` spans name B1's tier
    (a ring of 16 PEs: one block), and each ``pass`` carries the bytes in
    device memory of every B1 launch it made, its burn-in's included: the
    growth of ``pdes_multistep.offchip_bytes`` over the pass (here a
    stand-in that counts 1000 bytes a row-step; the CPU launches
    nothing)."""
    from repro_torch.kernels import pdes_multistep as pm
    plain = pm.pdes_multistep_counter

    def counted(tau, *a, k_steps, **kw):
        out = plain(tau, *a, k_steps=k_steps, **kw)
        pm.offchip_bytes += 1000 * tau.shape[0] * k_steps
        return out

    monkeypatch.setattr(pm, "pdes_multistep_counter", counted)
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    prev = ttrace.set_tracer(tel.tracer)     # the engine's spans too
    try:
        _drain(tel)
    finally:
        ttrace.set_tracer(prev)
    events = tel.tracer.events
    runs = [e["args"] for e in events if e["name"] == "engine.run"]
    assert runs and all(a["tier"] == "block" for a in runs)
    args = [e["args"] for e in events if e["name"] == "pass"]
    assert [a["b1_tier"] for a in args] == ["block"] * 3
    assert [a["b1_offchip_bytes"] for a in args] == [
        1000 * (a["rows_burned"] * a["burn"] + a["n_rows"] * a["n_steps"])
        for a in args]
    assert args[0]["rows_burned"] > 0
    _drain(tobs.Telemetry(tracer=tobs.TraceRecorder()))
    assert pm.offchip_bytes > 0
    monkeypatch.setattr(pm, "pdes_multistep_counter", plain)
    before = pm.offchip_bytes
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    _drain(tel)
    assert pm.offchip_bytes == before        # the CPU's plain version
    assert [e["args"]["b1_offchip_bytes"] for e in tel.tracer.events
            if e["name"] == "pass"] == [0, 0, 0]


def test_pass_spans_count_b1s_stale_launches(monkeypatch):
    """A fused pass names its window, and its ``b1_rebased_launches`` are
    its B1 launches, the burn-in's included, each taking the pass's window
    (so a stale pass's launches are all stale); the engine's
    ``engine.run`` spans name the window (the CPU launches nothing, so a
    stand-in for B1's wrapper counts each launch as the card's does)."""
    from repro_torch.kernels import pdes_multistep as pm
    plain = pm.pdes_multistep_counter
    windows = []

    def counted(*a, rebase=False, stale=False, **kw):
        pm.launches += 1
        pm.rebased_launches += rebase
        windows.append("stale" if stale else "exact")
        return plain(*a, rebase=rebase, stale=stale, **kw)

    monkeypatch.setattr(pm, "pdes_multistep_counter", counted)
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    svc = SweepService(device="cpu")
    svc.attach_telemetry(tel)
    prev = ttrace.set_tracer(tel.tracer)     # the engine's spans too
    try:
        for window in ("stale", "exact"):    # burn-in 20 at K = 8: three
            svc.submit(WindowSweep(**dict(   # launches; 32 steps: four
                COMMON, deltas=(2.0, 4.0), burn_in=20, window=window)),
                requester=window)
            svc.drain()
    finally:
        ttrace.set_tracer(prev)
    events = tel.tracer.events
    args = [e["args"] for e in events if e["name"] == "pass"]
    assert [(a["window"], a["b1_rebased_launches"]) for a in args] == [
        ("stale", 7), ("exact", 7)]
    assert windows == ["stale"] * 7 + ["exact"] * 7
    runs = [e["args"] for e in events if e["name"] == "engine.run"]
    assert [(a["mode"], a["window"]) for a in runs] == [
        ("burn", "stale"), ("record", "stale"), ("burn", "exact"),
        ("record", "exact")]


def test_zero_budget_pass_spans_count_the_crossings():
    """With no room on the device every burned row is demoted (one copy
    down) and every hit crosses up; the burned pass itself takes its rows
    from the sub-pass on the device."""
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    _drain(tel, budget_rows=0)
    args = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    rows = 2 * COMMON["replicas"]
    moved = [(a["state_bytes_to_host"], a["state_bytes_to_device"])
             for a in args]
    assert moved == [(rows * ROW_BYTES, 0), (0, rows * ROW_BYTES), (0, 0)]
    assert [(a["rows_from_device_cache"], a["rows_promoted"],
             a["rows_demoted"]) for a in args] == \
        [(0, 0, rows), (0, 0, 0), (0, 0, 0)]


def test_crossing_spans_wrap_the_demotions_and_promotions(tmp_path):
    """A one-row device tier: the burned pass demotes all but one row
    inside its ``state_cache.put``, the extension brings them up inside
    its ``state_cache.assemble``; responses are the same bits."""
    got, events = _profiled(lambda: _drain(budget_rows=1), tmp_path)
    assert [r.result.records for r in got] == \
        [r.result.records for r in _drain()]
    by = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            by.setdefault(e["name"], []).append(e)
    assert len(by["state_cache.to_host"]) >= 1
    assert len(by["state_cache.to_device"]) == 1
    for e in by["state_cache.to_host"]:
        assert any(_inside(e, p) for p in by["state_cache.put"])
    for e in by["state_cache.to_device"]:
        assert any(_inside(e, a) for a in by["state_cache.assemble"])


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
