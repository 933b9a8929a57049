"""The path above the engine on ``pallas`` + ``window="stale"``, against ``repro``.

1. A stale ``pallas`` queue through the port's ``SweepService`` and
   ``repro``'s, with JAX's η injected into the port: every record's ``u``
   is equal, the other fields agree to ``RTOL``, and the dedup, coalescing
   and state-cache counters are equal.
2. ``find_optimal_window`` and ``optimal_windows`` on one ``SweepResult``
   dict give ``repro``'s JSON.
3. ``refine_optimal_window`` probes the same Δ sequence and finds the same
   Δ* as ``repro``'s; the efficiencies agree to ``RTOL``.  The port alone
   repeats ``tests/test_service.py``'s refiner checks on ``pallas`` + stale.
4. The ``ensemble`` drivers on ``backend="pallas"`` against ``repro``'s,
   and on ``backend=None`` (the threefry stream): ``width_evolution``'s
   ``u`` and ``gvt`` and ``steady_state``'s ``rate`` bitwise, the rest to
   ``RTOL`` (ROADMAP C3: the reference's time average may fuse into an
   FMA).
"""
import dataclasses
import json
import math

import numpy as np
import pytest

import repro.service as jsvc
from repro.core import PDESConfig as JConfig
from repro.core import ensemble as jens
from repro.experiments import optimal_window as jopt
from repro.experiments.sweep import SweepResult as JResult
from repro_torch.core import ensemble as tens
from repro_torch.core import horizon as th
from repro_torch.core.horizon import PDESConfig
from repro_torch.experiments import (SweepResult, WindowSweep,
                                     find_optimal_window, optimal_windows,
                                     refine_optimal_window, run_window_sweep,
                                     spec_to_dict)
from repro_torch.service import SweepService

from torch_parity import RTOL, jax_eta_table

COMMON = dict(Ls=(16,), n_vs=(2,), replicas=4, n_steps=32, burn_in=16,
              backend="pallas", window="stale", k_fuse=8)


def _jspec(spec):
    """The same spec as a ``repro`` WindowSweep, through the wire format."""
    return jsvc.decode_request({"version": 1, "requester": "x",
                                "spec": spec_to_dict(spec)})[0]


def _assert_records_match_repro(port_records, jax_records):
    assert len(port_records) == len(jax_records)
    for p, j in zip(port_records, jax_records):
        p, j = dataclasses.asdict(p), dataclasses.asdict(j)
        assert (p["L"], p["n_v"], p["delta"]) == (j["L"], j["n_v"],
                                                  j["delta"])
        assert p["u"] == j["u"], (p, j)
        for k in p.keys() - {"L", "n_v", "delta", "u"}:
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, atol=1e-6,
                                       err_msg=k)


def test_stale_pallas_queue_matches_repro_service():
    alice = WindowSweep(deltas=(1.0, 4.0, math.inf), **COMMON)
    rounds = [
        [("alice", alice),
         ("bob", WindowSweep(deltas=(4.0, 8.0), **COMMON)),
         ("carol", alice)],
        # a longer series resumes alice's burned rows from the state cache
        [("alice", dataclasses.replace(alice, n_steps=48))],
    ]
    jax_service, port_service = jsvc.SweepService(), \
        SweepService(device="cpu")
    for queue in rounds:
        for who, spec in queue:
            assert (spec.backend, spec.window) == ("pallas", "stale")
            jax_service.submit(_jspec(spec), requester=who)
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
    st = port_service.stats
    assert st.as_dict() == jax_service.stats.as_dict()
    assert st.n_deduped == 1 and st.n_passes == 2
    assert st.rows_from_state_cache == alice.n_trajectories


def test_stale_pallas_service_equals_direct_runs():
    """Inside the port: coalescing, dedup and the state cache, bitwise."""
    first = WindowSweep(deltas=(2.0, 4.0, math.inf), **COMMON)
    svc = SweepService(device="cpu")
    svc.submit(first, requester="alice")
    svc.submit(WindowSweep(deltas=(2.0, 8.0), **COMMON), requester="bob")
    svc.submit(first, requester="carol")
    responses = svc.drain()
    assert svc.stats.n_passes == 1 and svc.stats.n_deduped == 1
    longer = dataclasses.replace(first, n_steps=40)
    svc.submit(longer, requester="alice")
    responses += svc.drain()
    assert svc.stats.rows_from_state_cache == first.n_trajectories
    for resp in responses:
        direct = run_window_sweep(resp.spec, device="cpu")
        assert resp.result.records == direct.records, resp.requester


def test_optimal_windows_match_repro_json():
    spec = WindowSweep(Ls=(16, 24), n_vs=(1, 3),
                       deltas=(0.5, 2.0, math.inf, 8.0), replicas=3,
                       n_steps=24, burn_in=8, backend="pallas",
                       window="stale", k_fuse=8)
    doc = json.loads(json.dumps(run_window_sweep(spec, device="cpu")
                                .as_dict()))
    port, ref = SweepResult.from_dict(doc), JResult.from_dict(doc)
    got = [o.as_dict() for o in optimal_windows(port)]
    want = [o.as_dict() for o in jopt.optimal_windows(ref)]
    assert json.dumps(got) == json.dumps(want)
    one = find_optimal_window(port, L=24, n_v=3).as_dict()
    assert json.dumps(one) == json.dumps(
        jopt.find_optimal_window(ref, L=24, n_v=3).as_dict())
    assert got[0]["deltas"][-1] == "inf"
    assert optimal_windows(spec, device="cpu") == optimal_windows(port)
    with pytest.raises(ValueError, match="no records"):
        find_optimal_window(port, L=99, n_v=1)


def test_refiner_matches_repro():
    common = dict(COMMON, Ls=(32,), replicas=6, burn_in=32)
    coarse = WindowSweep(deltas=(0.5, 1.0, 2.0, 4.0, 8.0), **common)
    jref = jopt.refine_optimal_window(_jspec(coarse), rounds=3,
                                      service=jsvc.SweepService())
    svc = SweepService(device="cpu")
    with th.eta_override(jax_eta_table()):
        tref = refine_optimal_window(coarse, rounds=3, service=svc)
    t, j = tref.as_dict(), jref.as_dict()
    assert [e[0] for e in t["evaluations"]] == \
        [e[0] for e in j["evaluations"]]
    np.testing.assert_allclose([e[1] for e in t["evaluations"]],
                               [e[1] for e in j["evaluations"]], rtol=RTOL)
    for k in ("delta_star", "bracket", "rounds", "interior", "L", "n_v"):
        assert t[k] == j[k], k
    assert t["u_star"] == j["u_star"]
    np.testing.assert_allclose([t["eff_star"], t["w_star"]],
                               [j["eff_star"], j["w_star"]], rtol=RTOL)
    assert json.dumps(sorted(t)) == json.dumps(sorted(j))


def test_refiner_matches_dense_grid_with_fewer_engine_steps():
    common = dict(COMMON, Ls=(32,), replicas=6, burn_in=32)
    coarse = WindowSweep(deltas=(0.5, 1.0, 2.0, 4.0, 8.0), **common)
    svc = SweepService(device="cpu")
    ref = refine_optimal_window(coarse, rounds=3, service=svc)
    assert ref.bracket[0] <= ref.delta_star <= ref.bracket[1]
    assert all(math.isfinite(e) for _, e in ref.evaluations)
    # the polish round re-measured the winner off cached burned-in rows
    assert svc.stats.rows_from_state_cache > 0
    # the coarse round coalesced its five single-Δ probes into one pass
    assert svc.stats.n_passes < svc.stats.n_requests

    dense = tuple(float(x) for x in np.round(np.linspace(0.5, 8.0, 12), 4))
    svc2 = SweepService(device="cpu")
    svc2.submit(WindowSweep(deltas=dense, **common), "grid")
    opt = optimal_windows(svc2.drain()[0].result)[0]
    assert abs(ref.delta_star - opt.delta_star) <= 1.5 * (dense[1] - dense[0])
    assert svc.stats.engine_row_steps < svc2.stats.engine_row_steps
    with pytest.raises(ValueError, match="service mesh"):
        refine_optimal_window(dataclasses.replace(coarse, backend="sharded"),
                              service=svc)


def _close(port, ref, fields):
    for f in fields:
        np.testing.assert_allclose(getattr(port, f), getattr(ref, f),
                                   rtol=RTOL, atol=1e-6, err_msg=f)


STEADY = ("utilization", "utilization_err", "w", "w2", "wa", "rate")


@pytest.mark.parametrize("window", ["exact", "stale"])
def test_ensemble_drivers_match_repro(window):
    opts = dict(window=window, k_fuse=8)
    kw = dict(n_trials=4, seed=3, burn_in_steps=16, measure_steps=24,
              backend="pallas", engine_opts=opts)
    cfg, jcfg = PDESConfig(L=32, n_v=2, delta=4.0), \
        JConfig(L=32, n_v=2, delta=4.0)
    with th.eta_override(jax_eta_table()):
        t_ss = tens.steady_state(cfg, device="cpu", **kw)
        t_sw = tens.steady_state_sweep(cfg, (1.0, math.inf), device="cpu",
                                       **kw)
        t_we = tens.width_evolution(cfg, n_steps=20, n_trials=4, seed=3,
                                    backend="pallas", engine_opts=opts,
                                    device="cpu")
        t_ul = tens.utilization_vs_L((16, 24), n_v=2, delta=4.0,
                                     device="cpu", **kw)
    _close(t_ss, jens.steady_state(jcfg, **kw), STEADY)
    j_sw = jens.steady_state_sweep(jcfg, (1.0, math.inf), **kw)
    assert [s.cfg.delta for s in t_sw] == [1.0, math.inf]
    for t, j in zip(t_sw, j_sw):
        assert t.utilization == j.utilization
        _close(t, j, STEADY)
    j_we = jens.width_evolution(jcfg, n_steps=20, n_trials=4, seed=3,
                                backend="pallas", engine_opts=opts)
    assert t_we.keys() == j_we.keys()
    np.testing.assert_array_equal(t_we["t"], j_we["t"])
    for k in t_we.keys() - {"t"}:
        np.testing.assert_allclose(t_we[k], np.asarray(j_we[k]), rtol=RTOL,
                                   atol=1e-5, err_msg=k)
    j_ul = jens.utilization_vs_L((16, 24), n_v=2, delta=4.0, **kw)
    for t, j in zip(t_ul, j_ul):
        assert t.cfg.L == j.cfg.L
        _close(t, j, STEADY)


@pytest.mark.parametrize("delta", [4.0, math.inf])
def test_ensemble_threefry_path_matches_repro(delta):
    kw = dict(n_trials=4, seed=5, burn_in_steps=20, measure_steps=24)
    cfg, jcfg = PDESConfig(L=24, n_v=3, delta=delta), \
        JConfig(L=24, n_v=3, delta=delta)
    with th.eta_override(jax_eta_table()):
        t_ss = tens.steady_state(cfg, device="cpu", **kw)
        t_we = tens.width_evolution(cfg, n_steps=20, n_trials=4, seed=5,
                                    device="cpu")
        t_ul = tens.utilization_vs_L((16, 20), n_v=3, delta=delta,
                                     device="cpu", **kw)
    j_ss = jens.steady_state(jcfg, **kw)
    assert t_ss.rate == j_ss.rate
    _close(t_ss, j_ss, STEADY)
    j_we = jens.width_evolution(jcfg, n_steps=20, n_trials=4, seed=5)
    assert t_we.keys() == j_we.keys()
    for k in ("t", "u", "gvt"):
        np.testing.assert_array_equal(t_we[k], np.asarray(j_we[k]),
                                      err_msg=k)
    for k in t_we.keys() - {"t", "u", "gvt"}:
        np.testing.assert_allclose(t_we[k], np.asarray(j_we[k]), rtol=RTOL,
                                   atol=1e-5, err_msg=k)
    j_ul = jens.utilization_vs_L((16, 20), n_v=3, delta=delta, **kw)
    for t, j in zip(t_ul, j_ul):
        assert t.cfg.L == j.cfg.L and t.rate == j.rate
        _close(t, j, STEADY)


def test_ensemble_threefry_path_is_not_ported():
    """What of ``ensemble`` is still refused, and its burn-in heuristic.

    The threefry path (``backend=None``) this test once held as unported
    is ported now and held against ``repro`` by
    ``test_ensemble_threefry_path_matches_repro``, and the sharded engine
    is reached through ``engine_opts={"mesh": ...}``
    (``tests/test_torch_sharded_sweep.py``).  A mesh for a non-sharded
    backend and options a batched sweep does not take raise, as in
    ``repro``.
    """
    cfg = PDESConfig(L=16)
    with pytest.raises(ValueError, match="only meaningful for "
                                         "backend='sharded'"):
        tens.steady_state_sweep(cfg, (1.0,), burn_in_steps=4,
                                measure_steps=4, device="cpu",
                                engine_opts={"mesh": object()})
    with pytest.raises(ValueError, match="engine_opts"):
        tens.steady_state_sweep(cfg, (1.0,), device="cpu",
                                engine_opts={"block_b": 8})
    assert tens.default_burn_in(cfg) == jens.default_burn_in(JConfig(L=16))
