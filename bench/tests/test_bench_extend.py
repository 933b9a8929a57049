"""A configuration, a cell, a mix and a per-layer metric come in as new
files and new entries of ``BENCHMARK.json`` alone: the harness finds them
by name, the tests' tiny copy cuts them by rule, and no file that was
there changes.  So does a configuration with physics of its own: further
``WindowSweep`` fields (``spec``) and its own reference (``reference``)."""
import dataclasses
import hashlib
import json
import shutil
import time

import pytest
from conftest import ROOT, TINY_L_SPLIT, shrink

import repro_torch.experiments.sweep as sweep
import repro_torch.service.api as api
from bench import check, harness, traffic

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


#: A reference of its own, as a deployment with new physics brings one: it
#: reuses ``pdes.py``'s ring and records the field it is handed.
STUB = '''"""The ring of pdes.py, handed a partner probability it records."""
from . import pdes

request_rows, records = pdes.request_rows, pdes.records
RECORD_FIELDS = pdes.RECORD_FIELDS
CALLS = []


def run_rows(*, p_partner, **kw):
    CALLS.append(p_partner)
    return pdes.run_rows(**kw)
'''
PARTNER = "exact_mix.ring10k_partner"


@dataclasses.dataclass(frozen=True)
class PartnerSweep(sweep.WindowSweep):
    """``WindowSweep`` with one field more, as a later port would have it."""

    p_partner: float = 0.0


def _partner_root(full_root, tmp_path_factory, **changes):
    """A copy with configuration ``ring10k_partner`` (ring10k's, with
    ``spec`` and ``reference``, then ``changes``), its cell, and the stub
    reference; every file that was there unchanged; cut by ``shrink``."""
    root = tmp_path_factory.mktemp("partner")
    shutil.copytree(full_root, root, dirs_exist_ok=True)
    before = _digests(root)
    conf = json.loads((ROOT / "bench/configs/ring10k.json").read_text())
    conf.update(name="ring10k_partner", spec={"p_partner": 0.25},
                reference="partner_stub")
    conf.update(changes)
    (root / "bench/configs/ring10k_partner.json").write_text(json.dumps(conf))
    (root / "bench/reference/partner_stub.py").write_text(STUB)
    shutil.copy(root / "bench/cells/exact_mix.ring10k.json",
                root / f"bench/cells/{PARTNER}.json")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "ring10k_partner", "source": "a test",
                            "file": "bench/configs/ring10k_partner.json",
                            "reduced": conf["reduced"], "why": "a test"})
    spec["workloads"].append({"name": PARTNER, "config": "ring10k_partner",
                              "traffic": "exact_mix", "chips": 1,
                              "why": "a test cell"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    after = _digests(root)
    assert {k: after[k] for k in before} == before
    return shrink(root)


def _submitted(monkeypatch) -> list:
    """The specs the service receives, recorded as they come."""
    seen, submit = [], api.SweepService.submit

    def spy(self, spec, *a, **kw):
        seen.append(spec)
        return submit(self, spec, *a, **kw)
    monkeypatch.setattr(api.SweepService, "submit", spy)
    return seen


def test_a_configuration_brings_its_spec_and_reference(
        full_root, tmp_path_factory, tmp_path, monkeypatch):
    root = _partner_root(full_root, tmp_path_factory)
    monkeypatch.setattr(sweep, "WindowSweep", PartnerSweep)
    seen = _submitted(monkeypatch)
    cell = harness.load_cell(root, PARTNER)
    stub = cell["reference"]
    assert stub.__file__ == str(root / "bench/reference/partner_stub.py")
    res = harness.run(root, PARTNER, 2**31 + 9, 0.3, False, device="cpu",
                      out_dir=tmp_path, t_start=time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0
    # the field reaches the service's spec, the stream key and run_rows
    assert seen and all(type(s) is PartnerSweep and s.p_partner == 0.25
                        for s in seen)
    assert stub.CALLS and set(stub.CALLS) == {0.25}
    q = next(traffic.rounds(cell["config"], cell["mix"], cell["cell"],
                            3))[0]
    assert q["p_partner"] == 0.25
    key = check._stream_key(q, 64, 10)
    assert key[-1] == ("p_partner", 0.25)
    assert key != check._stream_key(dict(q, p_partner=0.5), 64, 10)
    assert check._stream_key(dict(q, pairs=[[0, 1], [2, 3]]), 64, 10)[-1] \
        == ("pairs", ((0, 1), (2, 3)))


@pytest.mark.parametrize("bad, why", [
    ({"spec": {"p_partner": 0.25, "rd_mode": True}}, "harness sets itself"),
    ({"spec": {"p_partner": 0.25, "p_partnr": 0.5}}, "WindowSweep lacks"),
    ({"rd_mod": True}, "unknown keys"),
    ({"reference": "partner_stbu"}, "no reference"),
])
def test_a_malformed_configuration_is_refused_before_the_window(
        full_root, tmp_path_factory, tmp_path, monkeypatch, bad, why):
    root = _partner_root(full_root, tmp_path_factory, **bad)
    monkeypatch.setattr(sweep, "WindowSweep", PartnerSweep)
    seen = _submitted(monkeypatch)
    with pytest.raises(ValueError, match=why):
        harness.run(root, PARTNER, 2**31 + 9, 0.3, False, device="cpu",
                    out_dir=tmp_path, t_start=time.perf_counter())
    assert seen == []


def test_a_spec_field_the_port_lacks_fails_at_once(
        full_root, tmp_path_factory, tmp_path, monkeypatch):
    """The parent of a change that adds the field runs the new cell so."""
    root = _partner_root(full_root, tmp_path_factory)
    seen = _submitted(monkeypatch)
    with pytest.raises(ValueError, match="WindowSweep lacks"):
        harness.run(root, PARTNER, 2**31 + 9, 0.3, False, device="cpu",
                    out_dir=tmp_path, t_start=time.perf_counter())
    assert seen == []
