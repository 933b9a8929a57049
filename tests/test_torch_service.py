"""The slice as a whole: the port's sweep service against ``repro``'s.

1. ``examples/service_queue.jsonl`` drained through both services, with
   JAX's η injected into the port: every record's ``u`` is equal, the other
   fields agree to ``RTOL``.
2. Inside the port, every response equals a direct ``run_window_sweep``
   bit for bit, across coalescing, dedup and the state cache.
3. A ``StateCache`` saved by ``repro`` loads in the port and serves the
   same responses.  The port's cache keeps its rows on the service's
   device in front of a host tier; under any device budget it hits,
   misses and evicts as ``repro``'s, and responses stay the same bits.
4. The port's CLI writes response lines with ``repro``'s keys.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.service as jsvc
from repro.experiments.sweep import run_window_sweep as jax_sweep
from repro_torch.core import horizon as th
from repro_torch.experiments import sweep as tsweep
from repro_torch.experiments.sweep import (WindowSweep, run_window_sweep,
                                           serial_window_sweep)
from repro_torch.service import (StateCache, SweepService, decode_request,
                                 decode_response, encode_response)
from repro_torch.service import __main__ as cli

from torch_parity import RTOL, jax_eta_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUEUE = os.path.join(REPO, "examples", "service_queue.jsonl")
COMMON = dict(Ls=(16,), n_vs=(2,), replicas=4, n_steps=32, burn_in=16,
              backend="pallas_multistep", k_fuse=8)


def _queue_lines():
    with open(QUEUE) as fh:
        return [json.loads(li) for li in fh.read().strip().splitlines()]


def _assert_records_match_repro(port_records, jax_records):
    assert len(port_records) == len(jax_records)
    for p, j in zip(port_records, jax_records):
        p, j = dataclasses.asdict(p), dataclasses.asdict(j)
        assert p.keys() == j.keys()
        assert (p["L"], p["n_v"], p["delta"]) == (j["L"], j["n_v"],
                                                  j["delta"])
        assert p["u"] == j["u"], (p, j)
        for k in p.keys() - {"L", "n_v", "delta", "u"}:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=1e-6,
                                       err_msg=k)


def test_example_queue_matches_repro():
    jax_service = jsvc.SweepService()
    port_service = SweepService(device="cpu")
    for obj in _queue_lines():
        spec, who = jsvc.decode_request(obj)
        jax_service.submit(spec, requester=who)
        spec, who = decode_request(obj)
        assert spec.backend == "pallas_multistep"
        port_service.submit(spec, requester=who)
    jax_resps = jax_service.drain()
    with th.eta_override(jax_eta_table()):
        port_resps = port_service.drain()
    assert [r.request_id for r in port_resps] == \
        [r.request_id for r in jax_resps]
    assert [r.cached for r in port_resps] == [r.cached for r in jax_resps]
    for p, j in zip(port_resps, jax_resps):
        assert p.error is None and j.error is None
        _assert_records_match_repro(p.result.records, j.result.records)
    assert port_service.stats.as_dict() == jax_service.stats.as_dict()


def test_coalesced_pass_bit_identical_to_direct_runs():
    specs = {
        "alice": WindowSweep(deltas=(2.0, 4.0, math.inf), **COMMON),
        "bob": WindowSweep(deltas=(2.0, 4.0), **COMMON),
        "carol": WindowSweep(deltas=(1.0, 4.0, 8.0), **COMMON),
    }
    svc = SweepService(device="cpu")
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    responses = svc.drain()
    assert svc.stats.n_passes == 1
    assert svc.stats.rows_computed < sum(
        s.n_trajectories for s in specs.values())
    for resp in responses:
        direct = run_window_sweep(resp.spec, device="cpu")
        assert resp.result.records == direct.records, resp.requester


def test_dedup_identical_specs_no_recompute():
    spec = WindowSweep(deltas=(2.0, 4.0), **COMMON)
    svc = SweepService(device="cpu")
    svc.submit(spec, requester="alice")
    svc.submit(spec, requester="bob")
    r1, r2 = svc.drain()
    assert not r1.cached and r2.cached
    assert r1.result.records == r2.result.records
    svc.submit(spec, requester="carol")
    (r3,) = svc.drain()
    assert r3.cached and r3.result.records == r1.result.records
    assert svc.stats.n_passes == 1 and svc.stats.n_deduped == 2


def test_state_cache_reuse_and_partial_overlap_bit_identical():
    first = WindowSweep(deltas=(2.0, 4.0), **COMMON)
    longer = dataclasses.replace(first, n_steps=48)
    svc = SweepService(device="cpu")
    svc.submit(first, requester="alice")
    svc.drain()
    svc.submit(longer, requester="alice")
    (resp,) = svc.drain()
    assert svc.stats.rows_from_state_cache == first.n_trajectories
    assert resp.result.records == run_window_sweep(longer,
                                                   device="cpu").records
    mixed = WindowSweep(deltas=(2.0, 8.0), **COMMON)   # one Δ cached
    svc.submit(mixed, requester="bob")
    (resp,) = svc.drain()
    assert resp.result.records == run_window_sweep(mixed,
                                                   device="cpu").records
    assert svc.stats.rows_burned == first.n_trajectories + 4


STALE = dict(COMMON, Ls=(96,), n_vs=(3,), replicas=2, burn_in=20,
             window="stale")


def test_stale_fused_drain_equals_direct_runs():
    """The stale window on the fused path: a coalesced pass, a duplicate
    (a result-cache hit), a burned-state extension over a burn-in that is
    not a whole number of chunks, and the exact window beside it in a pass
    of its own; every response equals a direct run of its spec."""
    alice = WindowSweep(deltas=(2.0, 4.0, math.inf), **STALE)
    svc = SweepService(device="cpu")
    svc.submit(alice, requester="alice")
    svc.submit(WindowSweep(deltas=(4.0, 8.0), **STALE), requester="bob")
    svc.submit(alice, requester="carol")
    exact = dataclasses.replace(alice, window="exact")
    svc.submit(exact, requester="erin")
    responses = svc.drain()
    assert svc.stats.n_passes == 2 and svc.stats.n_deduped == 1
    assert responses[2].cached
    dave = dataclasses.replace(alice, n_steps=64)
    svc.submit(dave, requester="dave")
    responses += svc.drain()
    assert svc.stats.rows_from_state_cache == alice.n_trajectories
    for resp in responses:
        direct = run_window_sweep(resp.spec, device="cpu")
        assert resp.result.records == direct.records, resp.requester
    assert responses[0].result.records != responses[3].result.records


def test_state_cache_saved_by_repro_serves_the_port(tmp_path):
    first = WindowSweep(deltas=(2.0, math.inf), **COMMON)
    longer = dataclasses.replace(first, n_steps=40)
    jax_service = jsvc.SweepService()
    jax_service.submit(jsvc.decode_request(
        {"version": 1, "requester": "alice",
         "spec": tsweep.spec_to_dict(first)})[0], requester="alice")
    jax_service.drain()
    path = tmp_path / "cache.npz"
    assert jax_service.state_cache.save(path) == first.n_trajectories
    svc = SweepService(device="cpu")
    assert svc.state_cache.load(path) == first.n_trajectories
    svc.submit(longer, requester="alice")
    with th.eta_override(jax_eta_table()):
        (resp,) = svc.drain()
    assert svc.stats.rows_from_state_cache == first.n_trajectories
    assert svc.stats.rows_burned == 0
    direct = jax_sweep(jsvc.decode_request(
        {"version": 1, "requester": "alice",
         "spec": tsweep.spec_to_dict(longer)})[0])
    _assert_records_match_repro(resp.result.records, direct.records)
    # and the cache the port writes loads back in repro
    svc.state_cache.save(tmp_path / "port.npz")
    assert jsvc.StateCache().load(tmp_path / "port.npz") == \
        first.n_trajectories


def _budget(rows, L):
    """Device bytes for ``rows`` rows of ring length ``L`` (None: all)."""
    return None if rows is None else rows * 4 * (L + 2)


def _cpu_service(budget_rows, **kw):
    svc = SweepService(device="cpu", **kw)
    svc.state_cache = StateCache(svc.state_cache.max_rows, device="cpu",
                                 budget_bytes=_budget(budget_rows, 16))
    return svc


@pytest.mark.parametrize("budget_rows", [0, 1, None],
                         ids=["no_device_rows", "one_device_row",
                              "unbounded"])
def test_two_tier_cache_bit_identical_under_any_budget(budget_rows):
    first = WindowSweep(deltas=(2.0, 4.0), **COMMON)
    later = [dataclasses.replace(first, n_steps=48),
             WindowSweep(deltas=(2.0, 8.0), **COMMON),
             WindowSweep(deltas=(4.0, 8.0, math.inf), **COMMON)]
    svc = _cpu_service(budget_rows)
    svc.submit(first, requester="alice")
    svc.drain()
    for i, spec in enumerate(later):
        svc.submit(spec, requester=f"r{i}")
        (resp,) = svc.drain()
        assert resp.result.records == run_window_sweep(
            spec, device="cpu").records
    assert svc.stats.rows_from_state_cache == 8 + 4 + 4
    assert (svc.stats.state_cache_hits, svc.stats.state_cache_misses) == \
        (16, 8 + 4 + 8)
    cache = svc.state_cache
    if budget_rows is None:       # the device tier holds every row
        assert cache.device_hits == 16 and cache.demotions == 0
        assert svc.state_bytes_to_host == svc.state_bytes_to_device == 0
    else:
        assert cache.demotions > 0 and svc.state_bytes_to_host > 0
    assert sum(len(sl.slots) for sl in cache._slabs.values()) <= \
        (len(cache) if budget_rows is None else budget_rows)


@pytest.mark.parametrize("budget_rows", [0, 2, None],
                         ids=["no_device_rows", "two_device_rows",
                              "unbounded"])
def test_two_tier_cache_counts_and_orders_as_repro(budget_rows):
    rng = np.random.default_rng(7)
    Ls = (8, 24, 40)
    keys = [("s", L, t) for L in Ls for t in range(5)]
    ref = jsvc.StateCache(max_rows=6)
    port = StateCache(max_rows=6, budget_bytes=_budget(budget_rows, 8))
    for _ in range(300):
        if rng.random() < 0.5:
            key = keys[rng.integers(len(keys))]
            want, got = ref.get(key), port.get(key)
            assert (want is None) == (got is None), key
            if want is not None:
                assert np.array_equal(want[0], got[0].numpy())
                assert (want[1], want[2]) == (got[1].item(), got[2].item())
        else:
            L = Ls[rng.integers(len(Ls))]
            batch = [keys[i] for i in rng.choice(
                np.arange(len(keys))[[k[1] == L for k in keys]],
                size=rng.integers(1, 8))]
            tau = rng.normal(size=(len(batch), L)).astype(np.float32)
            off = rng.normal(size=len(batch)).astype(np.float32)
            comp = rng.normal(size=len(batch)).astype(np.float32)
            ref.put_batch(batch, tau, off, comp)
            port.put_batch(batch, torch.from_numpy(tau),
                           torch.from_numpy(off), torch.from_numpy(comp))
        assert (port.hits, port.misses, port.evictions) == \
            (ref.hits, ref.misses, ref.evictions)
        assert list(port._rows) == list(ref._rows)
    assert ref.evictions > 0 and ref.hits > 0
    if budget_rows == 2:
        assert port.promotions > 0 and port.demotions > 0


@pytest.mark.parametrize("budget_rows", [1, None],
                         ids=["one_device_row", "unbounded"])
def test_pass_wider_than_the_cache_bit_identical(budget_rows):
    first = WindowSweep(deltas=(2.0, 4.0), **COMMON)          # 8 rows
    later = [dataclasses.replace(first, n_steps=48),
             WindowSweep(deltas=(4.0, 8.0), **COMMON)]
    svc = _cpu_service(budget_rows, state_cache_rows=3)
    for i, spec in enumerate([first] + later):
        svc.submit(spec, requester=f"r{i}")
        (resp,) = svc.drain()
        assert resp.result.records == run_window_sweep(
            spec, device="cpu").records
    assert len(svc.state_cache) == 3 and svc.stats.state_cache_evictions > 0
    assert svc.stats.rows_from_state_cache == 3


def test_save_from_both_tiers_loads_in_repro_and_back(tmp_path):
    rng = np.random.default_rng(3)
    port = StateCache(max_rows=16, budget_bytes=_budget(2, 8))
    rows = {}
    for L in (8, 12):
        keys = [("s", L, float(t)) for t in range(4)] + \
            [("s", L, math.inf)]
        tau = rng.normal(size=(len(keys), L)).astype(np.float32)
        off = rng.normal(size=len(keys)).astype(np.float32)
        comp = rng.normal(size=len(keys)).astype(np.float32)
        port.put_batch(keys, torch.from_numpy(tau), torch.from_numpy(off),
                       torch.from_numpy(comp))
        rows.update((k, (tau[i], off[i], comp[i]))
                    for i, k in enumerate(keys))
    assert port.demotions == 3 + 4 and len(port._host) == 7
    order = list(port._rows)
    assert port.save(tmp_path / "port.npz") == 10
    ref = jsvc.StateCache(max_rows=16)
    assert ref.load(tmp_path / "port.npz") == 10
    assert list(ref._rows) == order
    for key, (tau, off, comp) in rows.items():
        got = ref._rows[key]
        assert np.array_equal(got[0], tau) and (got[1], got[2]) == (off,
                                                                    comp)
    ref.save(tmp_path / "ref.npz")
    back = StateCache(max_rows=16, budget_bytes=_budget(2, 8))
    assert back.load(tmp_path / "ref.npz") == 10
    assert list(back._rows) == order
    for key, (tau, off, comp) in rows.items():
        got = back.get(key)                     # promoted on first hit
        assert np.array_equal(got[0].numpy(), tau)
        assert (got[1].item(), got[2].item()) == (off, comp)
    assert back.promotions > 0 and back.hits == 10


def test_engine_failure_is_a_structured_error(monkeypatch):
    svc = SweepService(device="cpu", engine_retries=1, retry_base_s=0.0)

    def boom(p):
        raise RuntimeError("device lost")

    monkeypatch.setattr(svc, "_execute", boom)
    svc.submit(WindowSweep(deltas=(2.0,), **COMMON), requester="alice")
    (resp,) = svc.drain()
    assert resp.result is None and resp.error["code"] == "engine"
    assert "device lost" in resp.error["message"]
    assert svc.stats.n_retries == 1 and svc.stats.n_errors == 1
    obj = json.loads(json.dumps(encode_response(resp)))
    assert decode_response(obj).error == resp.error


def test_batched_sweep_equals_serial_and_json_matches_repro():
    spec = WindowSweep(Ls=(16, 24), n_vs=(1, 3), deltas=(1.0, 4.0, math.inf),
                       replicas=3, n_steps=24, burn_in=8,
                       backend="pallas_multistep", k_fuse=8)
    batched = run_window_sweep(spec, device="cpu")
    assert batched.records == serial_window_sweep(spec, device="cpu").records
    ref = serial_window_sweep(dataclasses.replace(spec, backend="reference"),
                              device="cpu")
    assert batched.records == ref.records
    jspec = jsvc.decode_request({"version": 1, "requester": "x",
                                 "spec": tsweep.spec_to_dict(spec)})[0]
    from repro.experiments.sweep import spec_to_dict as jax_spec_to_dict
    assert json.dumps(tsweep.spec_to_dict(spec)) == \
        json.dumps(jax_spec_to_dict(jspec))
    back = tsweep.SweepResult.from_dict(
        json.loads(json.dumps(batched.as_dict())))
    assert back == batched
    for rec in batched.records:
        assert 0.0 < rec.u <= 1.0
    with pytest.raises(ValueError, match="only meaningful for "
                                         "backend='sharded'"):
        run_window_sweep(spec, device="cpu", mesh=object())


def test_sharded_spec_is_rejected_per_line(tmp_path):
    lines = _queue_lines()[:1]
    bad = json.loads(json.dumps(lines[0]))
    bad["spec"]["backend"] = "sharded"
    queue = tmp_path / "q.jsonl"
    queue.write_text("\n".join(json.dumps(x) for x in lines + [bad]) + "\n")
    from repro_torch.service.wire import serve_queue
    out = tmp_path / "r.jsonl"
    with open(out, "w") as fh:
        stats = serve_queue(queue, fh, service=SweepService(device="cpu"))
    docs = [json.loads(li) for li in out.read_text().splitlines()]
    assert "result" in docs[0] and docs[1]["error"]["code"] == "reject"
    assert "need a service mesh" in docs[1]["error"]["message"]
    assert stats.n_errors == 1


def _drain_cli(module, out_path, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, "-m", module, QUEUE, "--out",
                           str(out_path), *extra], capture_output=True,
                          text=True, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stderr, [json.loads(li) for li in
                         out_path.read_text().strip().splitlines()]


def _keys(obj):
    if isinstance(obj, dict):
        return {k: _keys(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_keys(v) for v in obj]
    return type(obj).__name__


def test_cli_drain_writes_repro_keys(tmp_path):
    err, port = _drain_cli("repro_torch.service", tmp_path / "port.jsonl",
                           "--device", "cpu")
    assert "1 deduped" in err and "1 coalesced pass" in err
    _, ref = _drain_cli("repro.service", tmp_path / "ref.jsonl")
    assert len(port) == len(ref) == 3
    assert [_keys(p) for p in port] == [_keys(r) for r in ref]
    assert [p["requester"] for p in port] == ["alice", "bob", "carol"]
    assert [decode_response(p).request_id for p in port] == \
        [r["request_id"] for r in ref]


def test_cli_default_device_needs_cuda(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([QUEUE, "--out", str(tmp_path / "r.jsonl")]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SweepService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_window_sweep(WindowSweep(**COMMON))
