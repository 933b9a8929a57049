"""A configuration, a cell, a mix and a per-layer metric come in as new
files and new entries of ``BENCHMARK.json`` alone: the harness finds them
by name, the tests' tiny copy cuts them by rule, and no file that was
there changes."""
import hashlib
import json
import shutil
import time

from conftest import TINY_L_SPLIT, shrink

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


#: A configuration at its full size, as a later change would add it: a ring
#: of three blocks of a cluster, under a name no table knows.
CONFIG = {"name": "ring128k", "about": "a test deployment", "L": 131072,
          "n_v": 100, "k_fuse": 16, "rd_mode": False, "border_both": False,
          "steady_frac": 0.5, "deltas": [10, 100, "inf"],
          "state_cache_rows": 64, "dtype": "float32",
          "guarantees": "bit for bit a direct run", "source": "a test",
          "reduced": ["burn_in", "n_steps", "replicas"]}
NEW_CELL = {"replicas": 4, "burn_in": 512, "n_steps": 512,
            "deltas": {"a": [10, 100], "b": [100, "inf"]},
            "limits": {"max_rel_gap": 0.1, "exact_fields_differ": 0}}


def test_new_configuration_as_data_alone(full_root, tmp_path_factory,
                                         tmp_path):
    root = tmp_path_factory.mktemp("configured")
    shutil.copytree(full_root, root, dirs_exist_ok=True)
    before = _digests(root)
    name = "exact_mix.ring128k"
    (root / "bench/configs/ring128k.json").write_text(json.dumps(CONFIG))
    (root / f"bench/cells/{name}.json").write_text(json.dumps(NEW_CELL))
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ring128k", "source": "a test",
                            "file": "bench/configs/ring128k.json",
                            "reduced": CONFIG["reduced"], "why": "a test"})
    spec["workloads"].append({"name": name, "config": "ring128k",
                              "traffic": "exact_mix", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(name)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {k: after[k] for k in before} == before
    shrink(root)
    cell = harness.load_cell(root, name)
    assert cell["config"]["L"] == TINY_L_SPLIT
    assert cell["cell"]["replicas"] == 2 and cell["cell"]["n_steps"] == 32
    kw = dict(device="cpu", out_dir=tmp_path, t_start=time.perf_counter())
    res = harness.run(root, name, 2**31 + 5, 0.3, False, **kw)
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {"served_pe_steps_per_s",
                                   "response_p95_s", "setup_s"}
    res = harness.run(root, name, 2**31 + 6, 0.3, True, **kw)
    assert res["correct"] is True
