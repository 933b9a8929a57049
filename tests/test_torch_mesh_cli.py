"""``--mesh`` in the port's CLI: one process per mesh position.

``python -m repro_torch.service --mesh data=2,model=4 --device cpu``
starts 8 gloo ranks of itself (``service/launch.py``); ``repro``'s CLI
serves the same mesh in one process over 8 fake XLA devices
(``--fake-devices 8``).  Held here:

1. the drain of ``examples/service_queue.jsonl`` turned to
   ``backend="sharded"``, on both CLIs, run side by side: equal request ids,
   ``u``, ``u_err`` and ``rate`` bit for bit, ``w2`` to 1e-4 absolute
   (ROADMAP, C5), the rest to ``RTOL``; JAX's η goes into every rank, since
   the launcher starts copies of its own command line;
2. ``serve --mesh`` on 8 ranks with intake files dropped between rounds,
   ended by SIGTERM to the launcher (forwarded to every rank): each
   response equal in ``u``, ``u_err``, ``rate`` and ``rate_err`` to the
   single-device ``pallas_multistep`` run of its spec;
3. a rank that fails brings the launcher down non-zero, every rank gone;
4. on the GPU, a world larger than the visible GPU count exits 2 before
   any rank starts.
"""
import dataclasses
import json
import math
import os
import signal
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
from repro_torch.service import decode_response, encode_request
from repro_torch.service import __main__ as cli
from repro_torch.service import launch

from torch_parity import RTOL, SRC, jax_eta_table

pytestmark = pytest.mark.distributed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE = os.path.join(REPO, "examples", "service_queue.jsonl")
MESH = ["--mesh", "data=2,model=4"]
#: every launch and the reference CLI finish well inside this
DEADLINE = 240

#: the port's CLI with JAX's η (``ETA``, an .npy) under the decode
ETA_CLI = textwrap.dedent("""
    import os, sys
    import numpy as np
    from repro_torch.core import horizon
    from repro_torch.service.__main__ import main
    with horizon.eta_override(np.load(os.environ["ETA"], mmap_mode="c")):
        sys.exit(main())
""")


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1", **extra)
    env.pop("XLA_FLAGS", None)
    env.pop("RANK", None)
    return env


def _sharded_queue(path):
    with open(QUEUE) as fh:
        lines = [json.loads(li) for li in fh.read().strip().splitlines()]
    for obj in lines:
        obj["spec"]["backend"] = "sharded"
    path.write_text("".join(json.dumps(obj) + "\n" for obj in lines))
    return lines


def _records(path):
    out = {}
    for line in path.read_text().strip().splitlines():
        obj = json.loads(line)
        assert "error" not in obj, obj
        out[obj["request_id"]] = obj
    return out


def test_mesh_drain_matches_repro_fake_devices(tmp_path):
    queue = tmp_path / "q.jsonl"
    _sharded_queue(queue)
    eta = tmp_path / "eta.npy"
    np.save(eta, jax_eta_table())
    port_out, ref_out = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    port = subprocess.Popen(
        [sys.executable, "-c", ETA_CLI, str(queue), "--out", str(port_out),
         "--device", "cpu", *MESH, "--metrics-dir", str(tmp_path / "m")],
        env=_env(ETA=str(eta)), cwd=tmp_path, stderr=subprocess.PIPE,
        text=True)
    ref = subprocess.run(
        [sys.executable, "-m", "repro.service", str(queue), "--out",
         str(ref_out), "--fake-devices", "8", *MESH], env=_env(), cwd=REPO,
        capture_output=True, text=True, timeout=DEADLINE)
    try:
        _, port_err = port.communicate(timeout=DEADLINE)
    finally:
        if port.poll() is None:
            port.kill()
            port.communicate()
    assert ref.returncode == 0, ref.stderr[-3000:]
    assert port.returncode == 0, port_err[-3000:]
    assert "1 deduped" in port_err and "1 coalesced pass" in port_err
    assert port_err.count("served 3 request(s)") == 1     # rank 0 alone
    p, r = _records(port_out), _records(ref_out)
    assert list(p) == list(r)           # queue order, equal request ids
    for rid in r:
        assert p[rid]["cached"] == r[rid]["cached"]
        recs = zip(p[rid]["result"]["records"], r[rid]["result"]["records"])
        for a, b in recs:
            assert a.keys() == b.keys()
            for k in ("L", "n_v", "delta", "u", "u_err", "rate"):
                assert a[k] == b[k], (k, a, b)
            assert abs(a["w2"] - b["w2"]) <= 1e-4, (a, b)
            assert math.isnan(a["wa"]) and math.isnan(b["wa"])
            for k in ("w2_err", "w", "spread", "rate_err"):
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-4,
                                           err_msg=k)
    # rank 0 alone wrote the metrics, and saw the one pass
    snap = json.loads((tmp_path / "m" / "metrics.json").read_text())
    (passes,) = [s for s in snap["series"]
                 if s["name"] == "repro_service_passes"]
    assert passes["value"] == 1.0


def _drop(intake, name, spec, requester):
    tmp = intake / (name + ".tmp")
    tmp.write_text(json.dumps(encode_request(spec, requester)) + "\n")
    os.replace(tmp, intake / name)


def _wait_for(pred, proc, what, deadline):
    while not pred():
        assert proc.poll() is None, f"launcher exited {proc.returncode}"
        assert time.monotonic() < deadline, f"never saw {what}"
        time.sleep(0.05)


def test_serve_mesh_intake_between_rounds_and_sigterm(tmp_path):
    intake = tmp_path / "intake"
    intake.mkdir()
    out = tmp_path / "responses.jsonl"
    common = dict(Ls=(16,), n_vs=(2,), n_steps=32, burn_in=16,
                  backend="sharded", k_fuse=8)
    first = WindowSweep(deltas=(2.0, 4.0, math.inf), replicas=4, **common)
    second = WindowSweep(deltas=(2.0, 8.0), replicas=3, **common)
    _drop(intake, "a.jsonl", first, "alice")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.service", "serve", "--intake",
         str(intake), "--out", str(out), "--poll", "0.05", "--device", "cpu",
         *MESH, "--state-cache", str(tmp_path / "cache.npz")],
        env=_env(), cwd=tmp_path, stderr=subprocess.PIPE, text=True)
    deadline = time.monotonic() + DEADLINE
    try:
        _wait_for(lambda: (intake / "a.jsonl.done").exists(), proc,
                  "a.jsonl.done", deadline)
        _drop(intake, "b.jsonl", second, "bob")
        _wait_for(lambda: (intake / "b.jsonl.done").exists()
                  and out.exists()
                  and len(out.read_text().splitlines()) == 2, proc,
                  "two responses", deadline)
        proc.send_signal(signal.SIGTERM)
        _, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    assert "flushing in-flight work" in err
    assert err.count("served 2 request(s):") == 1         # rank 0 alone
    assert (tmp_path / "cache.npz").exists()              # rank 0 saved it
    by_requester = {}
    for line in out.read_text().strip().splitlines():
        resp = decode_response(json.loads(line))
        assert resp.error is None
        by_requester[resp.requester] = resp
    for who, spec in (("alice", first), ("bob", second)):
        fused = run_window_sweep(
            dataclasses.replace(spec, backend="pallas_multistep"),
            device="cpu")
        for rec, ref in zip(by_requester[who].result.records, fused.records):
            assert (rec.u, rec.u_err, rec.rate, rec.rate_err) == \
                (ref.u, ref.u_err, ref.rate, ref.rate_err), (who, rec, ref)
            assert math.isclose(rec.w2, ref.w2, rel_tol=RTOL, abs_tol=1e-4)


FAILING_RANK = textwrap.dedent("""
    import os, sys
    if "RANK" in os.environ:
        with open(os.path.join(os.environ["PIDS"], os.environ["RANK"]),
                  "w") as fh:
            fh.write(str(os.getpid()))
        if os.environ["RANK"] == "5":
            sys.exit(7)
    from repro_torch.service.__main__ import main
    sys.exit(main())
""")


def test_failed_rank_brings_the_launcher_down(tmp_path):
    queue = tmp_path / "q.jsonl"
    _sharded_queue(queue)
    pids = tmp_path / "pids"
    pids.mkdir()
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-c", FAILING_RANK, str(queue), "--device", "cpu",
         *MESH, "--out", str(tmp_path / "r.jsonl")],
        env=_env(PIDS=str(pids)), cwd=tmp_path, capture_output=True,
        text=True, timeout=DEADLINE)
    assert proc.returncode == 7, proc.stderr[-3000:]
    assert time.monotonic() - t0 < DEADLINE
    started = sorted(int(p.name) for p in pids.iterdir())
    assert 5 in started
    for p in pids.iterdir():        # the launcher reaped every rank
        with pytest.raises(ProcessLookupError):
            os.kill(int(p.read_text()), 0)


def test_mesh_larger_than_the_gpus_exits_2(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("RANK", raising=False)

    def no_ranks(*a, **k):
        raise AssertionError("no rank may start")

    monkeypatch.setattr(launch, "run_ranks", no_ranks)
    out = tmp_path / "r.jsonl"
    assert cli.main([QUEUE, "--out", str(out), "--mesh",
                     "data=2,model=1"]) == 2
    err = capsys.readouterr().err
    assert "needs 2 GPU(s)" in err and "1 is visible" in err
    assert "does not fall back" in err
    assert cli.main(["serve", "--intake", str(tmp_path / "in"), "--mesh",
                     "data=1,model=4"]) == 2
    assert "needs 4 GPU(s)" in capsys.readouterr().err
    assert not out.exists()
    # gloo ranks on the CPU ask nothing of the GPU count
    assert launch.world_problem(8, "cpu") is None
    assert launch.world_problem(1, "cuda") is None
