"""Sharded sweeps and sharded service passes of the port (8 gloo ranks).

Mirrors ``tests/test_sharded_sweep.py`` and the sharded gate of
``tests/test_service.py``.  One module-scoped fixture runs 8 gloo ranks
on a 2 x 4 ``("data", "model")`` process mesh, every rank making the same
calls:

* the engine's batched sharded sweep, ``run_window_sweep(mesh=)`` with
  ragged padding and several grid points, ``serial_window_sweep(mesh=)``,
  the stale window (mode ``commavoid``);
* a ``SweepService(mesh=)`` pass of four requesters (padded to the
  ensemble extent) and a follow-up
  served from the state cache, each response against a direct
  ``run_window_sweep(mesh=)``;
* ``refine_optimal_window``, ``ensemble.steady_state_sweep`` and
  ``ensemble.steady_state`` on the sharded backend.

The parent holds the results against the single-device ``reference``
backend of the port: trajectories with ``array_equal``, ``u`` and the GVT
rate exactly, the moment stats to ``RTOL``.  ``plan_mesh_sweep`` is checked
in-process on ``ProcessMesh.abstract`` against ``repro``'s on an
``AbstractMesh``.
"""
import dataclasses
import json
import math
import textwrap

import numpy as np
import pytest

from repro_torch.core import ensemble
from repro_torch.core.engine import PDESEngine
from repro_torch.core.horizon import PDESConfig
from repro_torch.core.mesh import ProcessMesh
from repro_torch.experiments import optimal_window as opt
from repro_torch.experiments.sweep import (SweepResult, WindowSweep,
                                           plan_mesh_sweep, run_window_sweep,
                                           serial_window_sweep)
from repro_torch.service import SweepService

from torch_parity import RTOL, run_ranks

pytestmark = pytest.mark.distributed

WORLD = 8
DELTAS = (1.0, 2.0, 4.0, math.inf)
SPEC = WindowSweep(Ls=(32,), n_vs=(4,), deltas=DELTAS, replicas=3,
                   n_steps=16, burn_in=8, backend="sharded", k_fuse=4, seed=5)
SPECS = {
    "records": SPEC,
    "stale": dataclasses.replace(SPEC, window="stale"),
    "serial": dataclasses.replace(SPEC, replicas=2),
    # 3 deltas x 1 replica = 3 rows on an ensemble extent of 2
    "ragged": WindowSweep(Ls=(16,), n_vs=(2,), deltas=(1.0, 4.0, math.inf),
                          replicas=1, n_steps=8, burn_in=4,
                          backend="sharded", k_fuse=4, seed=9),
    "grid": WindowSweep(Ls=(16, 32), n_vs=(2,), deltas=(2.0, math.inf),
                        replicas=1, n_steps=8, burn_in=4, backend="sharded",
                        k_fuse=4, seed=2),
}
SERVICE = dict(Ls=(16,), n_vs=(2,), n_steps=32, burn_in=16,
               backend="sharded")
#: requester -> (deltas, replicas).  The union is 15 rows of alice, bob
#: and carol and dave's 2: 17, so the pass and its burn-in each take a pad
#: row to reach a multiple of the ensemble extent 2
REQUESTS = {"alice": ((2.0, 4.0, math.inf), 3), "bob": ((4.0, 8.0), 3),
            "carol": ((2.0, 8.0, math.inf), 3), "dave": ((3.0, 5.0), 1)}
COARSE = WindowSweep(Ls=(16,), n_vs=(2,), deltas=(0.5, 1.0, 2.0, 4.0, 8.0),
                     replicas=2, n_steps=32, burn_in=32, backend="sharded",
                     k_fuse=8, seed=3)

RANK_SCRIPT = textwrap.dedent("""
    import dataclasses, datetime, json, math, os
    import torch, torch.distributed as dist
    from repro_torch.core import ensemble
    from repro_torch.core.engine import PDESEngine
    from repro_torch.core.horizon import PDESConfig
    from repro_torch.core.mesh import make_mesh
    from repro_torch.experiments import optimal_window as opt
    from repro_torch.experiments.sweep import (WindowSweep, run_window_sweep,
                                               serial_window_sweep,
                                               spec_from_dict)
    from repro_torch.service import SweepService

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method="file://" + os.environ["STORE"], rank=rank,
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=60))
    mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
    cfg = json.loads(os.environ["CFG"])
    out = {}

    # the engine's batched sharded sweep
    eng = PDESEngine(PDESConfig(L=32, n_v=4, delta=4.0), backend="sharded",
                     k_fuse=4, mesh=mesh)
    st0, drows = eng.init_sweep(cfg["deltas"], replicas=3)
    state, stats = eng.run(st0, seed=5, n_steps=16, deltas=drows)
    out["engine"] = {"tau": state.tau.tolist(),
                     "offset": state.offset.tolist(),
                     "stats": {f: getattr(stats, f).tolist()
                               for f in stats._fields}}

    # experiments: batched, stale, serial, ragged, several grid points
    specs = {k: spec_from_dict(v) for k, v in cfg["specs"].items()}
    out["sweeps"] = {k: run_window_sweep(s, mesh=mesh).as_dict()
                     for k, s in specs.items()}
    out["serial"] = serial_window_sweep(specs["serial"], mesh=mesh).as_dict()

    # the service: three requesters in one coalesced pass, then a
    # follow-up with longer n_steps from the burned-state cache
    svc = SweepService(mesh=mesh)
    reqs = {who: WindowSweep(deltas=tuple(d), replicas=r, **cfg["service"])
            for who, (d, r) in cfg["requests"].items()}
    for who, spec in reqs.items():
        svc.submit(spec, requester=who)
    out["service"] = {}
    for resp in svc.drain():
        out["service"][resp.requester] = [
            resp.result.as_dict(),
            run_window_sweep(resp.spec, mesh=mesh).as_dict()]
    out["one_pass"] = svc.stats.n_passes == 1
    out["pass_rows"] = [svc.stats.rows_computed, svc.stats.engine_row_steps]
    follow = dataclasses.replace(reqs["bob"], n_steps=48)
    svc.submit(follow, requester="bob")
    (r2,) = svc.drain()
    out["follow"] = [r2.result.as_dict(),
                     run_window_sweep(follow, mesh=mesh).as_dict()]
    out["cache_rows"] = svc.stats.rows_from_state_cache

    # tuning and the ensemble driver on the sharded backend
    out["refine"] = opt.refine_optimal_window(
        spec_from_dict(cfg["coarse"]), rounds=2, mesh=mesh).as_dict()
    out["steady"] = [dataclasses.asdict(s) | {"cfg": None}
                     for s in ensemble.steady_state_sweep(
                         PDESConfig(L=16, n_v=2), (1.0, math.inf),
                         n_trials=2, burn_in_steps=8, measure_steps=16,
                         backend="sharded",
                         engine_opts={"k_fuse": 4, "mesh": mesh})]
    ss = ensemble.steady_state(
        PDESConfig(L=16, n_v=2, delta=2.0), n_trials=4, burn_in_steps=8,
        measure_steps=16, backend="sharded",
        engine_opts={"k_fuse": 4, "mesh": mesh})
    out["steady_state"] = dataclasses.asdict(ss) | {"cfg": None}
    with open(os.path.join(os.environ["OUT"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results (JSON) from one run of 8 gloo ranks."""
    from repro_torch.experiments.sweep import spec_to_dict
    work = tmp_path_factory.mktemp("sharded_sweep")
    cfg = {"deltas": DELTAS,
           "specs": {k: spec_to_dict(s) for k, s in SPECS.items()},
           "service": SERVICE, "requests": REQUESTS,
           "coarse": spec_to_dict(COARSE)}
    run_ranks(RANK_SCRIPT, WORLD, work,
              env={"CFG": json.dumps(cfg), "OUT": str(work)})
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _single(spec):
    """The spec on the port's single-device reference backend."""
    return run_window_sweep(dataclasses.replace(spec, backend="reference"),
                            device="cpu")


def _records_match(sharded: dict, single: SweepResult, w2_rtol=1e-4):
    got = SweepResult.from_dict(sharded).records
    assert len(got) == len(single.records)
    for a, b in zip(got, single.records):
        assert (a.L, a.n_v, a.delta) == (b.L, b.n_v, b.delta)
        assert (a.u, a.u_err, a.rate, a.rate_err) == \
            (b.u, b.u_err, b.rate, b.rate_err), (a, b)
        assert np.isclose(a.w2, b.w2, rtol=w2_rtol, atol=1e-6), (a, b)
        assert math.isnan(a.wa) and not math.isnan(b.wa)


def test_every_rank_returns_the_same(ranks):
    for r, out in enumerate(ranks[1:], 1):
        assert json.dumps(out, sort_keys=True) == \
            json.dumps(ranks[0], sort_keys=True), f"rank {r}"


def test_sweep_bit_identical_to_serial_loop(ranks):
    """The batched sharded sweep's trajectories equal the single-device
    serial per-Δ loop bit for bit."""
    out = ranks[0]["engine"]
    tau = np.asarray(out["tau"], np.float32)
    off = np.asarray(out["offset"], np.float32)
    e_1d = PDESEngine(PDESConfig(L=32, n_v=4, delta=4.0), k_fuse=4,
                      device="cpu")
    R = 3
    for w, d in enumerate(DELTAS):
        s1, _ = e_1d.run(e_1d.init(R), seed=5, n_steps=16,
                         deltas=[d] * R, trial_base=w * R)
        blk = slice(w * R, (w + 1) * R)
        np.testing.assert_array_equal(s1.tau.numpy(), tau[blk])
        np.testing.assert_array_equal(s1.offset.numpy(), off[blk])


def test_sweep_stats_contract(ranks):
    stats = {f: np.asarray(v, np.float32)
             for f, v in ranks[0]["engine"]["stats"].items()}
    e_1d = PDESEngine(PDESConfig(L=32, n_v=4, delta=4.0), k_fuse=4,
                      device="cpu")
    st0, dr = e_1d.init_sweep(DELTAS, replicas=3)
    _, sw1 = e_1d.run(st0, seed=5, n_steps=16, deltas=dr)
    np.testing.assert_array_equal(stats["utilization"],
                                  sw1.utilization.numpy())
    np.testing.assert_array_equal(stats["gvt"], sw1.gvt.numpy())
    np.testing.assert_allclose(stats["w2"], sw1.w2.numpy(), rtol=RTOL,
                               atol=1e-5)
    for f in ("mean_tau", "max_dev", "min_dev"):
        np.testing.assert_allclose(stats[f], getattr(sw1, f).numpy(),
                                   rtol=RTOL, atol=1e-5, err_msg=f)
    assert np.isnan(stats["wa"]).all()


@pytest.mark.parametrize("name", ["records", "stale", "ragged", "grid"])
def test_sweep_records_match_single_device(ranks, name):
    _records_match(ranks[0]["sweeps"][name], _single(SPECS[name]))


def test_serial_sharded_baseline_matches(ranks):
    out = ranks[0]
    a = SweepResult.from_dict(out["sweeps"]["serial"]).records
    b = SweepResult.from_dict(out["serial"]).records
    for x, y in zip(a, b):
        assert x.u == y.u and x.rate == y.rate
        assert np.isclose(x.w2, y.w2, rtol=RTOL, atol=1e-6)


def test_sharded_service_bit_identity(ranks):
    out = ranks[0]
    assert set(out["service"]) == set(REQUESTS)
    for who, (served, direct) in out["service"].items():
        assert json.dumps(served) == json.dumps(direct), who
    assert out["one_pass"]
    # 17 rows + 1 pad measured 32 steps, burned 16 steps
    assert out["pass_rows"] == [17, 18 * 32 + 18 * 16]
    served, direct = out["follow"]
    assert json.dumps(served) == json.dumps(direct)
    assert out["cache_rows"] > 0


def test_sharded_refine_matches_single_device(ranks):
    ref = opt.refine_optimal_window(
        dataclasses.replace(COARSE, backend="reference"), rounds=2,
        device="cpu")
    got = ranks[0]["refine"]
    assert [d for d, _ in got["evaluations"]] == \
        [d for d, _ in ref.evaluations]
    np.testing.assert_allclose([e for _, e in got["evaluations"]],
                               [e for _, e in ref.evaluations], rtol=1e-4)
    assert got["delta_star"] == pytest.approx(ref.delta_star, rel=1e-6)
    assert got["u_star"] == ref.u_star


def test_sharded_steady_state(ranks):
    """``ensemble.steady_state`` on the sharded engine: its time average
    is a mean over the recorded steps, the reference backend's a sum of
    chunk sums, so the two agree to rounding."""
    ref = ensemble.steady_state(
        PDESConfig(L=16, n_v=2, delta=2.0), n_trials=4, burn_in_steps=8,
        measure_steps=16, backend="reference", engine_opts={"k_fuse": 4},
        device="cpu")
    got = ranks[0]["steady_state"]
    assert got["rate"] == ref.rate
    for f in ("utilization", "utilization_err", "w", "w2"):
        assert math.isclose(got[f], getattr(ref, f), rel_tol=1e-5), f
    assert math.isnan(got["wa"])


def test_sharded_steady_state_sweep(ranks):
    ref = ensemble.steady_state_sweep(
        PDESConfig(L=16, n_v=2), (1.0, math.inf), n_trials=2,
        burn_in_steps=8, measure_steps=16, backend="reference",
        engine_opts={"k_fuse": 4}, device="cpu")
    for got, want in zip(ranks[0]["steady"], ref):
        assert got["utilization"] == want.utilization
        assert got["rate"] == want.rate
        assert math.isclose(got["w2"], want.w2, rel_tol=1e-4)
        assert math.isnan(got["wa"])


# ---------------------------------------------------------------------------
# in-process: the grid scheduler on an abstract mesh, against repro's
# ---------------------------------------------------------------------------


def _jax_abstract_mesh(ens=2, ring=4):
    from jax.sharding import AbstractMesh
    try:
        return AbstractMesh((("data", ens), ("model", ring)))
    except TypeError:
        return AbstractMesh((ens, ring), ("data", "model"))


def _plans_of_both(spec, **kw):
    from repro.experiments.sweep import WindowSweep as JSweep
    from repro.experiments.sweep import plan_mesh_sweep as jplan
    jspec = JSweep(**dataclasses.asdict(spec))
    port = plan_mesh_sweep(spec, ProcessMesh.abstract((2, 4),
                                                      ("data", "model")), **kw)
    ref = jplan(jspec, _jax_abstract_mesh(), **kw)
    return port, ref


def test_plan_mesh_sweep_shapes():
    spec = WindowSweep(Ls=(16, 32), n_vs=(1, 2), deltas=(1.0, math.inf),
                       replicas=3, n_steps=16, burn_in=10, backend="sharded",
                       k_fuse=4)
    port, ref = _plans_of_both(spec)
    assert [dataclasses.astuple(p) for p in port] == \
        [dataclasses.astuple(p) for p in ref]
    assert [p.trial_base for p in port] == [0, 6, 12, 18]
    for p in port:
        assert p.n_rows == 6 and p.n_pad == 0
        assert p.ens_extent == 2 and p.ring_extent == 4
        assert p.burn_in == 12          # 10 rounded up to whole 4-chunks


def test_plan_mesh_sweep_ragged_and_errors():
    from repro.core.distributed import DistConfig as JDist
    from repro_torch.core.distributed import DistConfig
    spec = WindowSweep(Ls=(16,), n_vs=(1,), deltas=(1.0, 2.0, math.inf),
                       replicas=1, n_steps=8, burn_in=8, backend="sharded",
                       k_fuse=4)
    (p,), (q,) = _plans_of_both(spec)
    assert (p.n_rows, p.n_pad, p.n_padded) == (3, 1, 4)
    assert dataclasses.astuple(p) == dataclasses.astuple(q)
    mesh = ProcessMesh.abstract((2, 4), ("data", "model"))
    for bad, match in ((dict(Ls=(30,)), "divide L"),
                       (dict(n_steps=10), "whole chunks")):
        with pytest.raises(ValueError, match=match):
            plan_mesh_sweep(dataclasses.replace(spec, **bad), mesh)
        with pytest.raises(ValueError, match=match):
            _plans_of_both(dataclasses.replace(spec, **bad))
    with pytest.raises(ValueError, match="axes"):
        plan_mesh_sweep(spec, mesh, DistConfig(ens_axes=("pod",)))
    from repro.experiments.sweep import WindowSweep as JSweep
    from repro.experiments.sweep import plan_mesh_sweep as jplan
    with pytest.raises(ValueError, match="axes"):
        jplan(JSweep(**dataclasses.asdict(spec)), _jax_abstract_mesh(),
              JDist(ens_axes=("pod",)))


def test_run_window_sweep_mesh_arg_validation():
    mesh = ProcessMesh.abstract((2, 4), ("data", "model"))
    sharded = WindowSweep(backend="sharded", n_steps=16, burn_in=0, k_fuse=4)
    with pytest.raises(ValueError, match="mesh"):
        run_window_sweep(sharded, device="cpu")
    single = WindowSweep(backend="reference", n_steps=16, burn_in=0)
    with pytest.raises(ValueError, match="sharded"):
        run_window_sweep(single, mesh=mesh)
    with pytest.raises(ValueError, match="sharded"):
        serial_window_sweep(single, mesh=mesh)
    with pytest.raises(ValueError, match="multiple of the ensemble extent"):
        serial_window_sweep(dataclasses.replace(sharded, replicas=3),
                            mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="service mesh"):
        SweepService(device="cpu").submit(sharded)
    with pytest.raises(ValueError, match="process groups"):
        run_window_sweep(sharded, mesh=mesh, device="cpu")


def test_steady_state_sweep_rejects_unknown_opts():
    cfg = PDESConfig(L=16, n_v=1, delta=math.inf)
    with pytest.raises(ValueError, match="engine_opts"):
        ensemble.steady_state_sweep(cfg, (1.0,), n_trials=2,
                                    burn_in_steps=2, measure_steps=4,
                                    device="cpu",
                                    engine_opts={"interpret": False})


def test_abstract_mesh():
    mesh = ProcessMesh.abstract((2, 2, 2), ("pod", "data", "model"))
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.size == 8 and mesh.is_abstract
    assert [mesh.rank_of(mesh.coords_of(r)) for r in range(8)] == \
        list(range(8))
    assert mesh.coords_of(5) == {"pod": 1, "data": 0, "model": 1}
    with pytest.raises(ValueError, match="duplicate"):
        ProcessMesh.abstract((2, 2), ("data", "data"))
    with pytest.raises(ValueError, match="process groups"):
        mesh.group("model")
