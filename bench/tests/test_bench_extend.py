"""A cell, a mix and a per-layer metric come in as new files and new
entries of ``BENCHMARK.json`` alone: the harness finds them by name, and no
file that was there changes."""
import hashlib
import json
import time

from bench import harness

MIX = {"about": "two requests a round, the second a duplicate",
       "backend": "pallas_multistep", "window": "exact",
       "requests": [{"requester": "nina", "deltas": "a"},
                    {"requester": "otto", "same_as": "nina"}]}
CELL = {"replicas": 2, "burn_in": 16, "n_steps": 32,
        "deltas": {"a": [2, "inf"]},
        "limits": {"max_rel_gap": 1e-3, "exact_fields_differ": 0}}
METRIC = '''"""Rounds a second of the traced window: the passes' spans counted."""


def read(rec):
    return len(rec["spans"]) / rec["window_s"] if rec["spans"] else None
'''


def _digests(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "bench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_and_entries_alone(tiny_root, tmp_path_factory, tmp_path):
    import shutil
    root = tmp_path_factory.mktemp("extended")
    shutil.copytree(tiny_root, root, dirs_exist_ok=True)
    before = _digests(root)
    (root / "bench/mixes/pair_mix.json").write_text(json.dumps(MIX))
    (root / "bench/cells/pair_mix.ring10k.json").write_text(json.dumps(CELL))
    (root / "bench/metrics/service.passes_per_s.py").write_text(METRIC)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "pair_mix.ring10k",
                              "config": "ring10k", "traffic": "pair_mix",
                              "chips": 1, "why": "a test cell"})
    spec["per_layer"].append({"name": "service.passes_per_s", "unit": "1/s",
                              "better": "higher", "source": "program_span",
                              "layer": "service",
                              "moves": "served_pe_steps_per_s",
                              "workloads": ["pair_mix.ring10k"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {k: after[k] for k in before} == before
    kw = dict(device="cpu", out_dir=tmp_path, t_start=time.perf_counter())
    res = harness.run(root, "pair_mix.ring10k", 5, 0.3, False, **kw)
    assert res["correct"] is True
    assert res["attempted"] >= 2
    res = harness.run(root, "pair_mix.ring10k", 6, 0.3, True, **kw)
    assert res["correct"] is True
    assert res["metrics"]["service.passes_per_s"]["value"] > 0
    assert res["metrics"]["service.passes_per_s"]["unit"] == "1/s"
    # the new metric lists only the new cell
    res = harness.run(root, "exact_mix.ring10k", 7, 0.3, True, **kw)
    assert "service.passes_per_s" not in res["metrics"]
