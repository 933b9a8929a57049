"""The readers of the program's spans, on a synthetic trace: the idle
shares of the state cache, the engine and the service, and the state
cache's bytes a row.

The trace is reduced by ``devtrace.read`` as in a traced run, so each
gap is named after the innermost host operation at its midpoint; the
three shares, the idle named after aten operations and the idle no layer
claims partition ``device.idle_share``.  A program without the spans (its
``pass`` spans carry no byte counters) reads None, as a run without a
card does (the CPU's)."""
import pytest
from conftest import ROOT

from bench import devtrace, harness

BENCH = ROOT / "bench"
SHARES = ("state_cache.idle_share", "engine.idle_share",
          "service.idle_share")
BYTES = "state_cache.host_bytes_per_row"
#: bytes of one ring10k row of burned state: τ and the Kahan pair
ROW = 4 * (10_000 + 2)


def _read(name, rec):
    return harness.metric_reader(BENCH, name)(rec)


def _host(name, s, t, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": s, "dur": t - s,
            "pid": 1, "tid": 7}


def _kernel(s, t):
    return {"ph": "X", "cat": "kernel", "name": "void k(int)", "ts": s,
            "dur": t - s, "pid": 1, "tid": 99}


def _events():
    """A 1000 µs window: host spans on the harness's thread, kernels
    between the idle gaps named in ``GAPS``."""
    host = [_host(devtrace.WINDOW, 0, 1000), _host("bench.drain", 0, 990),
            _host("pass", 100, 950), _host("state_cache.put", 150, 250),
            _host("engine.run", 300, 700), _host("engine.chunk", 300, 500),
            _host("aten::add", 320, 330, cat="cpu_op"),
            _host("service.reduce", 730, 850),
            _host("service.observe", 800, 830)]
    busy = [(0, 100), (300, 320), (330, 480), (510, 600), (720, 740),
            (780, 800), (840, 880), (940, 970), (980, 990)]
    return host + [_kernel(s, t) for s, t in busy]


#: idle µs by the name at each gap's midpoint
GAPS = {"state_cache.put": 200, "aten::add": 10, "engine.chunk": 30,
        "engine.run": 120, "service.reduce": 40, "service.observe": 40,
        "pass": 60, "bench.drain": 10, "host outside any operation": 10}


def _passes(counted=True):
    """A ring10k round's two passes: 448 rows burned, then dave's 256
    from the cache."""
    out = []
    for rows, down in ((448, 448), (256, 0)):
        args = {"n_rows": rows, "rows_burned": down}
        if counted:
            args.update(state_bytes_to_host=down * ROW,
                        state_bytes_to_device=rows * ROW)
        out.append({"name": "pass", "ph": "X", "ts": 0, "dur": 1,
                    "args": args})
    return out


@pytest.fixture
def rec():
    r = devtrace.read(_events())
    r.update(spans=_passes(), card={"sms": 132})
    return r


def test_the_synthetic_gaps_are_named_as_designed(rec):
    assert rec["window_s"] == pytest.approx(1e-3)
    assert rec["busy_s"] == pytest.approx(480e-6)
    assert rec["gaps"] == pytest.approx({k: v * 1e-6
                                         for k, v in GAPS.items()})


def test_each_share_reads_its_layer(rec):
    got = {m: _read(m, rec) for m in SHARES}
    assert got == pytest.approx({"state_cache.idle_share": 20.0,
                                 "engine.idle_share": 15.0,
                                 "service.idle_share": 10.0})


def test_the_shares_partition_the_idle(rec):
    shares = sum(_read(m, rec) for m in SHARES)
    aten = sum(s for k, s in rec["gaps"].items() if k.startswith("aten::"))
    # what no layer claims: the harness's own annotations, the host
    # outside any, and the telemetry's own cost
    rest = sum(rec["gaps"][k] for k in ("bench.drain", "service.observe",
                                        "host outside any operation"))
    assert shares + 100 * (aten + rest) / rec["window_s"] == \
        pytest.approx(_read("device.idle_share", rec))
    assert _read("device.idle_share", rec) == pytest.approx(52.0)


def test_bytes_per_row(rec):
    # 448 rows down and 704 up over 704 rows measured
    assert _read(BYTES, rec) == pytest.approx(1152 * ROW / 704)
    rec["spans"] = [dict(p, args=dict(p["args"], state_bytes_to_host=0,
                                      state_bytes_to_device=0))
                    for p in rec["spans"]]
    assert _read(BYTES, rec) == 0.0       # a cell without burn-in


@pytest.mark.parametrize("name", SHARES + (BYTES,))
def test_none_without_the_program_spans_a_card_or_a_window(name, rec):
    assert _read(name, rec) is not None
    assert _read(name, dict(rec, spans=_passes(counted=False))) is None
    assert _read(name, dict(rec, spans=[])) is None
    if name == BYTES:
        assert _read(name, dict(rec, card=None)) is None
    else:
        assert _read(name, dict(rec, busy_s=0.0)) is None
        assert _read(name, dict(rec, window_s=0.0)) is None
