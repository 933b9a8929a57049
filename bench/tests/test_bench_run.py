"""The result line: its keys and their order, with the trace off and on;
and the runs that must print none."""
import json
import subprocess
import sys
import time
import types

import pytest
from conftest import ROOT

from bench import harness, run

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(tiny_root, name, trace, tmp_path):
    return harness.run(tiny_root, name, 2**31 + 99, 0.3, trace,
                       device="cpu", out_dir=tmp_path,
                       t_start=time.perf_counter())


def _of(metrics, name):
    return [m for m in metrics if name in m.get("workloads", [name])]


@pytest.mark.parametrize("name", ["exact_mix.ring10k", "stale_mix.ring10k",
                                  "growth_mix.ring1m", "exact_mix.ring512k",
                                  "exact_mix.size_grid"])
def test_untraced_line(tiny_root, spec, name, tmp_path):
    res = json.loads(json.dumps(_run(tiny_root, name, False, tmp_path)))
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] >= 3
    mine = _of(spec["end_to_end"], name)
    assert set(res["metrics"]) == {m["name"] for m in mine}
    assert {m["name"] for m in mine} >= {"setup_s"} and len(mine) == 3
    for m in mine:
        got = res["metrics"][m["name"]]
        assert got["unit"] == m["unit"] and got["value"] > 0
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    assert res["checks"] == {
        "max_rel_gap": {"value": 0.0, "limit": pytest.approx(
            res["checks"]["max_rel_gap"]["limit"])},
        "exact_fields_differ": {"value": 0, "limit": 0}}


@pytest.mark.parametrize("name", ["exact_mix.ring10k", "growth_mix.ring1m",
                                  "exact_mix.ring512k", "exact_mix.size_grid"])
def test_traced_line(tiny_root, spec, name, tmp_path):
    res = _run(tiny_root, name, True, tmp_path)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert res["correct"] is True
    # on the CPU only the service's own spans have something to read
    assert "service.outside_pass_share" in \
        {m["name"] for m in _of(spec["per_layer"], name)}
    assert set(res["metrics"]) == {"service.outside_pass_share"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert not list(tmp_path.iterdir())        # the trace file is removed


def test_no_result_without_cuda(tmp_path):
    proc = subprocess.run(
        [sys.executable, "bench/run.py", "--workload", "exact_mix.ring10k",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert harness.forbidden_modules() == []
    import repro_torch  # noqa: F401  (its name begins with "repro")
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert harness.forbidden_modules() == ["jax"]


def test_no_result_when_jax_was_loaded(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run", lambda *a, **k: {"checks": {}})
    monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    assert run.main(["--workload", "exact_mix.ring10k", "--seed", "1",
                     "--seconds", "1"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "flax" in out.err
