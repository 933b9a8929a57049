"""The stream tier's two per-layer metrics (``b1d_roofline``,
``b1d.offchip_bytes_per_pe_step``) on synthetic records: what each reads,
and that each is silent where its tier did not run, as on a program
without the tier's kernel or the pass spans' counters."""
import pytest
from conftest import ROOT

from bench import harness, roofline

CARD = {"sms": 132, "clock_hz": 1.98e9, "clock_from": "card",
        "hbm_bytes_per_s": 3e12}
STREAM = "multistep_counter_stream_kernel<false, false>"
GRID = "multistep_counter_grid_kernel<false, false>"
L = 1 << 23


def _pass(tier, offchip, rows, burned, burn=256, steps=256):
    args = {"L": L, "n_rows": rows, "n_pad": 0, "rows_burned": burned,
            "burn": burn, "n_steps": steps}
    if tier is not None:
        args.update(b1_tier=tier, b1_offchip_bytes=offchip)
    return {"name": "pass", "dur": 1e5, "args": args}


def _record(device_ops, spans):
    return {"device_ops": device_ops, "spans": spans, "card": CARD,
            "window_s": 3.0, "busy_s": 2.9,
            "stats": {"engine_row_steps": 14 * 512 + 8 * 512},
            "config": {"L": L, "n_v": 100, "k_fuse": 16},
            "responses": [{"request": {"replicas": 2, "burn_in": 256,
                                       "n_steps": 256},
                           "records": [{"L": L, "u": 0.5}]}]}


def test_b1d_roofline_reads_the_stream_kernel_alone():
    read = harness.metric_reader(ROOT / "bench", "b1d_roofline")
    passes = [_pass("stream", 0, 14, 14), _pass("stream", 0, 8, 0, steps=512)]
    rec = _record({STREAM: 2.0, GRID: 5.0, "Memcpy DtoD": 1.0}, passes)
    assert roofline.pe_steps(rec) == rec["stats"]["engine_row_steps"] * L
    assert read(rec) == pytest.approx(100 * roofline.b1_bound_s(rec) / 2.0)
    assert read(_record({GRID: 5.0}, [])) is None    # the tier did not run
    assert read(dict(rec, card=None)) is None


def test_offchip_bytes_per_pe_step_over_the_stream_passes():
    read = harness.metric_reader(ROOT / "bench",
                                 "b1d.offchip_bytes_per_pe_step")
    per = 8 * 869_888                  # the plan's bytes a row-step at 2^23
    main = _pass("stream", per * (14 * 256 + 14 * 256), 14, 14)
    dave = _pass("stream", per * 8 * 512, 8, 0, steps=512)
    other = _pass("grid", 0, 28, 28)
    got = read(_record({}, [main, dave, other]))
    assert got == pytest.approx(per / L) == pytest.approx(0.82958984375)
    assert read(_record({}, [other])) is None
    assert read(_record({}, [_pass(None, 0, 14, 14)])) is None  # no counter
    assert read(_record({}, [])) is None
