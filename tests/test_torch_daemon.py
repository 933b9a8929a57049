"""The port's serve daemon (``repro_torch.service.daemon``) against ``repro``'s.

The counterparts of ``tests/test_service_hardening.py``'s daemon tests,
all on ``device="cpu"`` at the size of ``examples/service_queue.jsonl``:

* crash and restart: ``python -m repro_torch.service serve`` killed by
  fault injection after its first pass resumes from the persisted state
  cache, burns nothing again, and every response equals a direct run bit
  for bit — with telemetry on the responses are those of telemetry off;
* SIGTERM while the scheduler holds a request: flushed, exit 0;
* the intake protocol: sorted ``*.jsonl`` files, one per round under
  ``max_files_per_round``, renamed ``*.done``, other names left alone;
* both daemons on one intake: equal request ids and error documents,
  ``u``, ``u_err`` and ``rate`` bitwise, the rest to ``RTOL`` (ROADMAP, C3),
  and their metrics snapshots by the rules of ``tests/test_torch_obs.py``;
* ``serve`` without CUDA exits 2, as the drain does.
"""
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.service.daemon import DaemonConfig as JaxDaemonConfig
from repro.service.daemon import serve_daemon as jax_serve_daemon
from repro_torch import obs as tobs
from repro_torch.core import horizon as th
from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
from repro_torch.obs.summarize import main as summarize_main
from repro_torch.service import SweepService, decode_response, encode_request
from repro_torch.service import __main__ as cli
from repro_torch.service.daemon import DaemonConfig, serve_daemon

from torch_parity import (RTOL, SRC, assert_service_snapshot_matches,
                          jax_eta_table)

COMMON = dict(Ls=(16,), n_vs=(2,), replicas=4, n_steps=32, burn_in=16,
              backend="pallas_multistep", k_fuse=8)
DEADLINE = 300


def _env():
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    env.pop("RANK", None)
    return env


def _drop(intake, name, spec, requester):
    tmp = intake / (name + ".tmp")
    tmp.write_text(json.dumps(encode_request(spec, requester)) + "\n")
    os.replace(tmp, intake / name)


def _daemon_args(intake, out, extra):
    return [sys.executable, "-m", "repro_torch.service", "serve",
            "--intake", str(intake), "--out", str(out), "--poll", "0.05",
            "--device", "cpu"] + extra


def _responses(path):
    out = {}
    for line in path.read_text().strip().splitlines():
        resp = decode_response(json.loads(line))
        assert resp.error is None, resp.error
        out[resp.requester] = resp
    return out


def _crash_and_restart(tmp_path, name, telemetry):
    """The two runs of the gate; returns (responses, restart metrics)."""
    work = tmp_path / name
    intake = work / "intake"
    intake.mkdir(parents=True)
    out, cache = work / "responses.jsonl", work / "cache.npz"
    first = WindowSweep(deltas=(2.0, 4.0), **COMMON)
    longer = dataclasses.replace(first, n_steps=64)
    _drop(intake, "a.jsonl", first, "alice")
    _drop(intake, "b.jsonl", longer, "bob")
    args = _daemon_args(intake, out, [
        "--state-cache", str(cache), "--max-files-per-round", "1"])
    tel = (["--metrics-dir", str(work / "metrics"),
            "--trace", str(work / "trace.json")] if telemetry else [])
    crash = subprocess.run(args + tel + ["--crash-after-passes", "1"],
                           capture_output=True, text=True, env=_env(),
                           cwd=work, timeout=DEADLINE)
    assert crash.returncode == 70, crash.stderr[-4000:]
    assert "fault injection" in crash.stderr
    assert len(out.read_text().strip().splitlines()) == 1
    assert cache.exists()
    assert (intake / "a.jsonl.done").exists()
    assert (intake / "b.jsonl").exists()
    if telemetry:       # saved before the hard exit
        assert (work / "trace.json").exists()
        assert (work / "metrics" / "metrics.json").exists()
    restart = subprocess.run(args + tel + ["--idle-exit-rounds", "1"],
                             capture_output=True, text=True, env=_env(),
                             cwd=work, timeout=DEADLINE)
    assert restart.returncode == 0, restart.stderr[-4000:]
    n = first.n_trajectories
    assert f"restored {n} burned row(s)" in restart.stderr
    assert f"{n} rows from state cache" in restart.stderr
    snap = None
    if telemetry:
        snap = json.loads((work / "metrics" / "metrics.json").read_text())
        assert summarize_main(["summarize", "--check", str(work / "metrics"),
                               str(work / "trace.json")]) == 0
    return _responses(out), snap, {"alice": first, "bob": longer}


def test_daemon_crash_restart_resumes_from_persisted_cache(tmp_path):
    on, snap, specs = _crash_and_restart(tmp_path, "on", telemetry=True)
    off, _, _ = _crash_and_restart(tmp_path, "off", telemetry=False)
    assert set(on) == set(off) == {"alice", "bob"}
    for who, spec in specs.items():
        direct = run_window_sweep(spec, device="cpu")
        assert on[who].result.records == direct.records, who
        assert off[who].result.records == direct.records, who
    value = {s["name"]: s.get("value") for s in snap["series"]}
    assert value["repro_service_rows_burned"] == 0
    assert value["repro_service_rows_from_state_cache"] == \
        specs["alice"].n_trajectories


def test_daemon_sigterm_flushes_inflight_work(tmp_path):
    intake = tmp_path / "intake"
    intake.mkdir()
    out = tmp_path / "responses.jsonl"
    spec = WindowSweep(deltas=(2.0,), **COMMON)
    _drop(intake, "a.jsonl", spec, "alice")
    proc = subprocess.Popen(
        _daemon_args(intake, out, ["--max-wait-rounds", "1000000000"]),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=_env(), cwd=tmp_path)
    try:
        deadline = time.monotonic() + DEADLINE
        while not (intake / "a.jsonl.done").exists():   # accepted, held
            assert proc.poll() is None, proc.communicate()[1][-4000:]
            assert time.monotonic() < deadline, "daemon never read intake"
            time.sleep(0.05)
        assert not out.exists() or out.read_text() == ""
        proc.send_signal(signal.SIGTERM)
        _, stderr = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, stderr[-4000:]
    assert "flushing in-flight work" in stderr
    (line,) = out.read_text().strip().splitlines()
    resp = decode_response(json.loads(line))
    assert resp.requester == "alice" and resp.error is None
    assert resp.result.records == run_window_sweep(spec,
                                                   device="cpu").records


def test_intake_done_renames_and_max_files_per_round(tmp_path):
    intake = tmp_path / "intake"
    intake.mkdir()
    specs = {f"{i}.jsonl": WindowSweep(deltas=(float(2 ** i),), **COMMON)
             for i in (3, 1, 2)}
    for name, spec in specs.items():
        _drop(intake, name, spec, f"user{name[0]}")
    (intake / "notes.txt").write_text("not a request\n")
    out = intake / "responses.jsonl"          # the output inside the intake
    lines = []
    cfg = DaemonConfig(intake_dir=str(intake), out_path=str(out),
                       poll_interval_s=0.01, idle_exit_rounds=1,
                       max_files_per_round=1)
    stats = serve_daemon(cfg, service=SweepService(device="cpu"),
                         log=lines.append)
    assert stats.n_requests == 3 and stats.n_passes == 3
    rounds = [ln for ln in lines if ln.startswith("round ")]
    assert len(rounds) == 3
    assert all("+1 request(s)" in ln and "1 pass(es)" in ln
               for ln in rounds)
    assert sorted(os.listdir(intake)) == [
        "1.jsonl.done", "2.jsonl.done", "3.jsonl.done", "notes.txt",
        "responses.jsonl"]
    got = [json.loads(li)["requester"]
           for li in out.read_text().strip().splitlines()]
    assert got == ["user1", "user2", "user3"]      # sorted-name order
    assert lines[-1].startswith("served 3 request(s)")


def _mixed_intake(intake):
    first = WindowSweep(deltas=(2.0, 4.0, math.inf), **COMMON)
    _drop(intake, "a.jsonl", first, "alice")
    _drop(intake, "b.jsonl", dataclasses.replace(first, deltas=(2.0, 8.0)),
          "bob")
    with open(intake / "b.jsonl", "a") as fh:
        fh.write("{not json\n")
        fh.write(json.dumps({"version": 99, "requester": "x",
                             "spec": {}}) + "\n")
    _drop(intake, "c.jsonl", dataclasses.replace(first, n_steps=48),
          "carol")


def test_both_daemons_on_one_intake_agree(tmp_path):
    runs = {}
    for name in ("repro", "repro_torch"):
        intake = tmp_path / name / "intake"
        intake.mkdir(parents=True)
        _mixed_intake(intake)
        out = tmp_path / name / "responses.jsonl"
        kw = dict(intake_dir=str(intake), out_path=str(out),
                  poll_interval_s=0.01, idle_exit_rounds=1,
                  max_files_per_round=2)
        if name == "repro":
            tel = jobs.Telemetry(jobs.MetricsRegistry(clock=lambda: 0.0))
            from repro.service import SweepService as JaxSweepService
            stats = jax_serve_daemon(JaxDaemonConfig(**kw),
                                     service=JaxSweepService(telemetry=tel),
                                     log=lambda m: None)
        else:
            tel = tobs.Telemetry(tobs.MetricsRegistry(clock=lambda: 0.0))
            with th.eta_override(jax_eta_table()):
                stats = serve_daemon(DaemonConfig(**kw), service=SweepService(
                    device="cpu", telemetry=tel), log=lambda m: None)
        docs = [json.loads(li) for li in out.read_text().splitlines()]
        runs[name] = (stats, docs, tel.registry.snapshot(),
                      sorted(os.listdir(intake)))
    (ps, pdocs, psnap, pfiles), (js, jdocs, jsnap, jfiles) = \
        runs["repro_torch"], runs["repro"]
    assert ps.as_dict() == js.as_dict()
    assert pfiles == jfiles == ["a.jsonl.done", "b.jsonl.done",
                                "c.jsonl.done"]
    assert len(pdocs) == len(jdocs) == 5
    assert [d.get("request_id") for d in pdocs] == \
        [d.get("request_id") for d in jdocs]
    for p, j in zip(pdocs, jdocs):
        if "error" in j:
            assert p == j
            continue
        assert p["result"]["spec"] == j["result"]["spec"]
        # the GVT rate is a least-squares slope over the measured steps: a
        # mean numpy and XLA sum in another order once there are more than
        # the example queue's 16 (ROADMAP, C3), so bitwise only there
        exact = {"L", "n_v", "delta", "u", "u_err"}
        if p["result"]["spec"]["n_steps"] == 32:
            exact.add("rate")
        for a, b in zip(p["result"]["records"], j["result"]["records"]):
            for k in exact:
                assert a[k] == b[k], (k, a, b)
            for k in a.keys() - exact:
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-6,
                                           err_msg=k)
    assert_service_snapshot_matches(psnap, jsnap)


def test_serve_without_cuda_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    intake = tmp_path / "intake"
    intake.mkdir()
    _drop(intake, "a.jsonl", WindowSweep(deltas=(2.0,), **COMMON), "alice")
    assert cli.main(["serve", "--intake", str(intake), "--out",
                     str(tmp_path / "r.jsonl"), "--idle-exit-rounds",
                     "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert (intake / "a.jsonl").exists()          # nothing consumed
    assert not (tmp_path / "r.jsonl").exists()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_daemon(DaemonConfig(intake_dir=str(intake),
                                  out_path=str(tmp_path / "r.jsonl")))
