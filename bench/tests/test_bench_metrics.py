"""Each per-layer metric's arithmetic, and the trace reduction, on a small
synthetic profiler trace and span set."""
import pytest
from conftest import ROOT, full_spec

from bench import devtrace, harness, roofline

B1 = "void multistep_counter_grid_kernel<false, false>(float const*, int)"
B2 = "void pdes_step_kernel<true>(float const*, uint2 const*)"
HTOD = "Memcpy HtoD (Pageable -> Device)"
#: 132 SMs at 1.98 GHz: 16.73e12 integer and 33.45e12 issued
#: instructions a second; 3e12 bytes a second.
CARD = {"sms": 132, "clock_hz": 1.98e9, "clock_from": "card",
        "hbm_bytes_per_s": 3e12}
#: A pass of 500 row-steps at L = 10,000: 10 rows burned 10 steps, then
#: run 40; two of them make the record's 1,000.
PASS = {"L": 10_000, "n_rows": 10, "n_pad": 0, "n_steps": 40,
        "rows_burned": 10, "burn": 10}
INT_RATE, ISSUE_RATE = 132 * 1.98e9 * 64, 132 * 1.98e9 * 128


def _x(cat, name, ts, dur, tid=1, pid=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "pid": pid, "tid": tid}


def _events():
    """A 1 s window: B1 0.2 s, B2 0.1 s overlapping B1 by 0.05 s, a copy
    0.05 s, a kernel that starts before the window; host operations on
    the window's thread and on another."""
    return [
        _x("user_annotation", devtrace.WINDOW, 1000.0, 1e6),
        _x("kernel", B1, 1000.0 + 1e5, 2e5, tid=7),
        _x("kernel", B2, 1000.0 + 2.5e5, 1e5, tid=7),
        _x("gpu_memcpy", HTOD, 1000.0 + 5e5, 5e4, tid=7),
        _x("kernel", B1, 0.0, 1100.0, tid=7),        # 100 us inside
        _x("cpu_op", "aten::copy_", 1000.0 + 6e5, 2e5),
        _x("user_annotation", "bench.drain", 1000.0 + 3e5, 6e5),
        _x("cpu_op", "aten::other_thread", 1000.0, 1e6, tid=2),
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0},
    ]


def _record():
    rec = devtrace.read(_events())
    rec.update(
        spans=[{"name": "pass", "dur": 2.5e5, "args": PASS},
               {"name": "pass", "dur": 2.5e5, "args": PASS}],
        stats={"engine_row_steps": 1000},
        config={"L": 10_000, "n_v": 10, "k_fuse": 16}, card=CARD,
        responses=[{"request": {"replicas": 2, "burn_in": 10, "n_steps": 30},
                    "records": [{"L": 10_000, "u": 0.25},
                                {"L": 10_000, "u": 0.75}]},
                   {"request": {"replicas": 1, "burn_in": 0, "n_steps": 40},
                    "records": None}])
    return rec


def test_trace_reduction():
    rec = devtrace.read(_events())
    assert rec["window_s"] == pytest.approx(1.0)
    # B1 0.1..0.3 and B2 0.25..0.35 s unite to 0.25 s; the copy 0.05 s;
    # the early kernel's last 100 us
    assert rec["busy_s"] == pytest.approx(0.25 + 0.05 + 1e-4)
    name = "multistep_counter_grid_kernel<false, false>"
    assert rec["device_ops"][name] == pytest.approx(0.2 + 1e-4)
    assert rec["device_ops"]["pdes_step_kernel<true>"] == pytest.approx(0.1)
    assert rec["device_ops"][HTOD] == pytest.approx(0.05)
    gaps = rec["gaps"]
    assert sum(gaps.values()) == pytest.approx(1.0 - rec["busy_s"])
    # each gap goes by the innermost host operation at its midpoint:
    # 0.0011..0.1 s none, 0.35..0.5 the drain, 0.55..1.0 the copy
    assert gaps["host outside any operation"] == pytest.approx(0.1 - 1e-4)
    assert gaps["bench.drain"] == pytest.approx(0.15)
    assert gaps["aten::copy_"] == pytest.approx(0.45)
    assert "aten::other_thread" not in gaps
    assert devtrace.top(gaps, 1) == [["aten::copy_", pytest.approx(0.45)]]


def test_short_name():
    assert devtrace.short_name(B1) == \
        "multistep_counter_grid_kernel<false, false>"
    assert devtrace.short_name("ampere_sgemm") == "ampere_sgemm"


def test_a_window_is_required():
    with pytest.raises(ValueError, match="bench.window"):
        devtrace.read(_events()[1:])


def _metric(name):
    return harness.metric_reader(ROOT / "bench", name)


def test_utilization_weights_by_pe_steps():
    assert roofline.utilization(_record()["responses"]) == pytest.approx(0.5)


def test_b1_roofline():
    rec = _record()
    pe = 1000 * 10_000
    n_int, n_fp = pe * (23 + 10 * 0.5), pe * (11 + 5 * 0.5)
    ops_s = max(n_int / INT_RATE, (n_int + n_fp) / ISSUE_RATE)
    assert ops_s == n_int / INT_RATE          # the integer pipes bind
    n_bytes = 8 * pe / 16 + 24 * 1000
    want = 100 * max(ops_s, n_bytes / 3e12) / (0.2 + 1e-4)
    assert _metric("b1_roofline")(rec) == pytest.approx(want)


def test_b2_roofline():
    rec = _record()
    n_bytes = 1000 * (16 * 10_000 + 36)
    ops = 1000 * 10_000 * (14 + 6 * 0.5)
    want = 100 * max(ops / ISSUE_RATE, n_bytes / 3e12) / 0.1
    assert _metric("b2_roofline")(rec) == pytest.approx(want)


def test_drain_mfu():
    pe = 1000 * 10_000
    want = 100 * pe * (23 + 10 * 0.5) / INT_RATE
    assert _metric("drain_mfu")(_record()) == pytest.approx(want)


def test_the_card_bounds_the_ops():
    """A card of half the SMs doubles the instructions' least time."""
    rec = _record()
    half = dict(rec, card=dict(CARD, sms=66))
    assert roofline.algorithm_s(half) == \
        pytest.approx(2 * roofline.algorithm_s(rec))
    assert roofline.ops_seconds(CARD, 0, ISSUE_RATE) == pytest.approx(1.0)
    assert roofline.ops_seconds(CARD, INT_RATE, 0) == pytest.approx(1.0)


def test_device_shares():
    rec = _record()
    assert _metric("device.idle_share")(rec) == pytest.approx(
        100 * (1 - (0.3 + 1e-4)))
    assert _metric("device.memcpy_share")(rec) == pytest.approx(5.0)


def test_service_outside_pass_share():
    assert _metric("service.outside_pass_share")(_record()) == \
        pytest.approx(50.0)


def test_readers_with_nothing_to_read_return_none():
    names = [m["name"] for m in full_spec()["per_layer"]]
    rec = _record()
    rec.update(device_ops={}, busy_s=0.0, spans=[])
    for name in names:
        assert _metric(name)(rec) is None, name
    # a run that read no card (on the CPU) has no roofline to share
    rec = dict(_record(), card=None)
    for name in ("b1_roofline", "b2_roofline", "drain_mfu"):
        assert _metric(name)(rec) is None, name


def test_a_metric_is_read_by_the_file_of_its_name():
    for m in full_spec()["per_layer"]:
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    with pytest.raises(FileNotFoundError):
        _metric("b1_roofline.device_bound")
    with pytest.raises(FileNotFoundError):
        _metric("no_such.metric")
