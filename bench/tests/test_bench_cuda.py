"""The benchmark on the card: every cell runs a short window to a correct
line, and a checkout of the benchmark alone prints none.  Skips without a
GPU; on one::

    python -m pytest -q -m cuda bench/tests/test_bench_cuda.py
"""
import json
import shutil
import subprocess
import sys

import pytest
import torch
from conftest import ROOT

pytestmark = pytest.mark.cuda

WORKLOADS = [w["name"] for w in
             json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the benchmark measures the card")


def _run(cwd, name, trace=0):
    return subprocess.run(
        [sys.executable, "bench/run.py", "--workload", name, "--seed",
         "3000000017", "--seconds", "2", "--trace", str(trace)], cwd=cwd,
        capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("name", WORKLOADS)
def test_cell_runs_correct(card, name):
    proc = _run(ROOT, name)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    assert res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name()


def test_benchmark_alone_prints_nothing(card, tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    proc = _run(tmp_path, WORKLOADS[0])
    assert proc.returncode != 0 and proc.stdout == ""
