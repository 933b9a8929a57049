"""The port's causality linter (``repro_torch.analysis``): golden reports,
the probes, waivers, the budget and the CLI — ``tests/test_analysis.py``'s
tests, on the port.

The reference linter cannot run as a live oracle on this machine's JAX
(ROADMAP, "A reference failure that is not a port fault"), so the port is
held to the reference's committed reports: for every backend,
``tests/golden/analysis_<backend>.json`` (no finding, every rule run).
The seeded-violation fixtures are in ``test_torch_analysis_rules.py``.
"""
import functools
import json
import pathlib

import pytest

from repro_torch.analysis import (ALL_RULES, analyze, analyze_backend,
                                  analyze_probe)
from repro_torch.analysis.fixtures import FIXTURES
from repro_torch.analysis.probes import iter_probes
from repro_torch.core.engine import BACKENDS
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

GOLDEN = pathlib.Path(__file__).parent / "golden"


@functools.cache
def _report(backend):
    return analyze_backend(backend)


@functools.cache
def _probes(backend):
    return list(iter_probes(backend))


@pytest.mark.parametrize("backend", BACKENDS)
def test_golden_report(backend):
    got = _report(backend).to_dict()
    want = json.loads((GOLDEN / f"analysis_{backend}.json").read_text())
    assert got == want


@pytest.mark.parametrize("backend", BACKENDS)
def test_clean_tree_has_zero_findings(backend):
    rep = _report(backend)
    assert rep.ok, "\n".join(str(f) for f in rep.findings)
    assert sorted(set(rep.rules_run)) == sorted(ALL_RULES)


def test_sharded_sweep_probe_runs():
    """Every backend, sharded included, yields a sweep probe with a traced
    Δ-column operand."""
    sweeps = [p for p in _probes("sharded") if p.name == "sweep"]
    assert len(sweeps) == 1
    (p,) = sweeps
    assert p.delta_input is not None and p.delta == 0.0
    assert p.shard_L == {"model": 8}
    # one rank's body: its halo and its all-reduces are in the graph
    prims = {n.prim for n in p.graph.nodes}
    assert {"ppermute", "pmin", "psum"} <= prims


@pytest.mark.parametrize("backend", BACKENDS)
def test_service_probe_traces_trial_vector(backend):
    """The coalesced-batch entry point is a probe on every backend: the
    per-row Δ column and the per-row trial-index vector are traced
    operands."""
    probes = [p for p in _probes(backend) if p.name == "service"]
    assert len(probes) == 1
    (p,) = probes
    assert p.delta_input is not None
    assert p.trial_input is not None
    g = p.graph
    trial = g.in_gids[p.trial_input]
    # the trial vector reaches tau (through the counter stream's hash)
    assert trial in g.ancestors(g.out_gids[p.tau_out])


def test_waiver_keeps_finding_but_passes_gate():
    probe, rule = FIXTURES["decreasing_tau"]()
    from repro_torch.analysis.report import BackendReport, apply_waivers
    findings = apply_waivers(analyze_probe(probe), (rule,))
    assert findings and all(f.waived for f in findings)
    rep = BackendReport(backend=probe.backend, findings=findings)
    assert rep.ok                       # waived findings don't fail the gate
    # a waiver scoped to a different backend does NOT apply
    findings = apply_waivers(analyze_probe(probe),
                             (f"{rule}:some_other_backend",))
    assert not BackendReport(backend=probe.backend, findings=findings).ok


def test_vmem_budget_is_configurable():
    # the clean kernels fit one block's shared memory but not 1 byte
    rep = analyze_backend("pallas", vmem_budget=1)
    assert not rep.ok
    assert {f.rule for f in rep.findings} == {"vmem-budget"}
    assert {f.op for f in rep.findings} == {"pdes_step"}


def test_cli_json_roundtrip(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main
    out = tmp_path / "report.json"
    rc = main(["--backend", "reference", "--format", "json",
               "-o", str(out)])
    assert rc == 0
    printed = json.loads(capsys.readouterr().out)
    on_disk = json.loads(out.read_text())
    assert printed == on_disk
    assert on_disk["ok"] and on_disk["n_findings"] == 0
    assert [b["backend"] for b in on_disk["backends"]] == ["reference"]


def test_cli_rule_subset_and_unknown_args(capsys):
    from repro_torch.analysis.__main__ import main
    rc = main(["--backend", "reference", "--rules", "vmem-budget"])
    assert rc == 0
    assert "rules=vmem-budget" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        main(["--backend", "nope"])
    with pytest.raises(SystemExit):
        main(["--rules", "nope"])
    capsys.readouterr()


def test_full_report_shape():
    rep = analyze(backends="all")
    d = rep.to_dict()
    assert d["ok"] is True
    assert [b["backend"] for b in d["backends"]] == list(BACKENDS)
    # text rendering mentions every backend and the final verdict line
    txt = rep.to_text()
    for b in BACKENDS:
        assert f"backend={b}" in txt
    assert txt.splitlines()[-1].startswith("analysis: PASS")
