"""The port's PDES examples (``examples/*_torch.py``) run on the CPU.

Each runs through its own ``main`` with ``--device cpu`` into a
``tmp_path`` output directory: ``paper_figures_torch.py --fast --backend
reference`` (its claims asserted), ``pdes_scaling_study_torch.py --fast
--backend reference``, and ``quickstart_torch.py``, whose ring sizes and
window widths are cut to L = 32 and Δ = 5 here (its full run takes minutes
on the CPU).  Nothing is written under ``results/``.
"""
import importlib.util
import json
import math
import pathlib

import pytest

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"


@pytest.fixture(autouse=True)
def one_thread():
    """The examples step small ensembles, where Python sets the pace: one
    torch thread keeps their time when the test workers share the cores."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_paper_figures_hold_on_the_cpu(tmp_path, capsys):
    example = _load("paper_figures_torch")
    example.main(["--fast", "--backend", "reference", "--device", "cpu",
                  "--out", str(tmp_path)])
    assert "all paper-figure claims hold" in capsys.readouterr().out
    names = sorted(p.name for p in (tmp_path / "figures").iterdir())
    assert names == ["fig_efficiency_vs_delta.json", "fig_rate_vs_delta.json",
                     "fig_util_vs_L.json", "fig_w2_vs_delta.json"]
    eff = json.loads((tmp_path / "figures" /
                      "fig_efficiency_vs_delta.json").read_text())
    assert any(v["interior"] for v in eff.values())


def test_scaling_study_runs_on_the_cpu(tmp_path, capsys):
    example = _load("pdes_scaling_study_torch")
    example.main(["--fast", "--backend", "reference", "--device", "cpu",
                  "--out", str(tmp_path)])
    out = json.loads((tmp_path / "example_scaling.json").read_text())
    assert out["backend"] == "reference"
    keys = [f"delta{d}_nv{nv}" for d in (5.0, 20.0) for nv in (1, 10, "rd")]
    assert sorted(out) == sorted(keys + ["backend"])
    for k in keys:
        assert out[k]["L"] == [32, 64, 128, 256]
        assert all(0.0 < u <= 1.0 for u in out[k]["u"]), out[k]
        assert math.isfinite(out[k]["u_inf"])
    assert f"wrote {tmp_path / 'example_scaling.json'}" in \
        capsys.readouterr().out


def test_quickstart_runs_on_the_cpu(monkeypatch, capsys):
    example = _load("quickstart_torch")
    monkeypatch.setattr(example, "LS", (32,))
    monkeypatch.setattr(example, "DELTAS", (5.0,))
    example.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert sum("utilization=" in ln for ln in lines) == 1
    assert sum(ln.strip().startswith("Δ=  5.0 L=  32") for ln in lines) == 1
    assert sum("u_RD=" in ln for ln in lines) == 3


@pytest.mark.parametrize("name", ["quickstart_torch", "pdes_scaling_study_torch",
                                  "paper_figures_torch"])
def test_examples_run_on_the_gpu_by_default(name, monkeypatch):
    import torch
    example = _load(name)
    if name == "quickstart_torch":
        monkeypatch.setattr(example, "LS", (32,))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        example.main(["--fast"] if name != "quickstart_torch" else [])
