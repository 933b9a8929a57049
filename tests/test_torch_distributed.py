"""The port's sharded runtime on 8 gloo ranks against ``repro``'s on 8 devices.

One module-scoped fixture runs the cases of ``tests/test_distributed_pdes.py``
(L = 32, 6 trials, 24 steps, seed 7, exact and commavoid; the multipod
ensemble axes) and a few more (rings of one and two ranks, a sweep's Δ
column with per-row trial indices) twice, at the same time:

* through the port's ``run_sharded_state`` on a 2 x 4 (and 2 x 2 x 2,
  8 x 1, 4 x 2) process mesh of 8 gloo ranks, JAX's η injected into each
  rank from one ``.npy`` the parent writes;
* through ``repro``'s ``run_sharded_state`` in one subprocess with 8 fake
  CPU devices, as ``tests/test_distributed_pdes.py`` runs it.

τ, the Kahan pair, ``u`` and ``gvt`` agree bit for bit; the other stats to
``RTOL``.  Every rank holds the same global result.
"""
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from repro_torch.core import distributed as D
from repro_torch.core.horizon import PDESConfig

from torch_parity import RTOL, SRC, jax_eta_table, run_ranks

pytestmark = pytest.mark.distributed

WORLD = 8
_MESH = {"2x4": ((2, 4), ("data", "model"), ("data",)),
         "multipod": ((2, 2, 2), ("pod", "data", "model"), ("pod", "data")),
         "ring1": ((8, 1), ("data", "model"), ("data",)),
         "ring2": ((4, 2), ("data", "model"), ("data",))}


def _case(mesh, L, n_v, delta, mode, K, trials, steps, seed, **extra):
    shape, axes, ens = _MESH[mesh]
    return dict(shape=shape, axes=axes, ens=ens, L=L, n_v=n_v, delta=delta,
                mode=mode, K=K, trials=trials, steps=steps, seed=seed,
                **extra)


CASES = {
    # tests/test_distributed_pdes.py's four cases and its multipod axes
    "exact_5.0_1_8": _case("2x4", 32, 1, 5.0, "exact", 8, 6, 24, 7),
    "exact_inf_1_8": _case("2x4", 32, 1, math.inf, "exact", 8, 6, 24, 7),
    "commavoid_5.0_10_4": _case("2x4", 32, 10, 5.0, "commavoid", 4, 6, 24, 7),
    "commavoid_10.0_3_8": _case("2x4", 32, 3, 10.0, "commavoid", 8, 6, 24,
                                7),
    "multipod": _case("multipod", 16, 2, 3.0, "exact", 4, 8, 12, 2),
    # a ring of one rank (the halo is the shard's own wrap) and of two
    # (both neighbours one rank)
    "ring1_exact": _case("ring1", 32, 3, 4.0, "exact", 8, 8, 24, 3),
    "ring1_commavoid": _case("ring1", 32, 3, 4.0, "commavoid", 8, 8, 24, 3),
    "ring2_exact": _case("ring2", 32, 3, 4.0, "exact", 8, 8, 24, 5),
    "ring2_commavoid": _case("ring2", 32, 3, 4.0, "commavoid", 8, 8, 24, 5),
    # a sweep: per-row Δ column with inf rows, per-row trials (negative
    # ones wrap mod 2**32), a nonzero step base
    "sweep_exact": _case("2x4", 32, 4, math.inf, "exact", 4, 8, 16, 9,
                         deltas=[1.0, 2.0, 4.0, math.inf] * 2,
                         trial_base=[0, 1, 2, 3, -1, -2, 70000, 5],
                         step_base=2**31 - 8),
    "sweep_commavoid": _case("2x4", 32, 4, math.inf, "commavoid", 4, 8, 16,
                             9, deltas=[1.0, 2.0, 4.0, math.inf] * 2,
                             trial_base=11),
}

PORT_SCRIPT = textwrap.dedent("""
    import datetime, json, os
    import numpy as np, torch, torch.distributed as dist
    from repro_torch.core import distributed as D, horizon
    from repro_torch.core.horizon import PDESConfig
    from repro_torch.core.mesh import make_mesh

    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group(
        "gloo", init_method="file://" + os.environ["STORE"], rank=rank,
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=datetime.timedelta(seconds=60))
    meshes, out = {}, {}
    with horizon.eta_override(np.load(os.environ["ETA"], mmap_mode="c")):
        for name, c in json.loads(os.environ["CASES"]).items():
            key = (tuple(c["shape"]), tuple(c["axes"]))
            if key not in meshes:
                meshes[key] = make_mesh(*key, device="cpu")
            cfg = PDESConfig(L=c["L"], n_v=c["n_v"], delta=c["delta"])
            dc = D.DistConfig(ens_axes=tuple(c["ens"]), mode=c["mode"],
                              k_chunk=c["K"])
            B = c["trials"]
            tb = c.get("trial_base", 0)
            tau, off, comp, st = D.run_sharded_state(
                cfg, meshes[key], n_steps=c["steps"], seed=c["seed"],
                dist=dc, tau0=torch.zeros(B, c["L"]), off0=torch.zeros(B),
                comp0=torch.zeros(B), step_base=c.get("step_base", 0),
                deltas=None if "deltas" not in c else torch.tensor(
                    c["deltas"]),
                trial_base=torch.tensor(tb) if isinstance(tb, list) else tb)
            out.update({f"{name}/tau": tau, f"{name}/off": off,
                        f"{name}/comp": comp})
            out.update({f"{name}/{k}": v for k, v in st.items()})
        # commavoid needs k_chunk <= L per shard: 32 / 4 = 8 < 16
        try:
            D.run_sharded(PDESConfig(L=32, n_v=1, delta=4.0),
                          meshes[((2, 4), ("data", "model"))], n_trials=2,
                          n_steps=16, dist=D.DistConfig(mode="commavoid",
                                                        k_chunk=16))
            out["long_k_error"] = np.array("")
        except ValueError as e:
            out["long_k_error"] = np.array(str(e))
    np.savez(os.path.join(os.environ["OUT"], f"port{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()
""")

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import json
    import numpy as np, jax.numpy as jnp
    from repro.compat import make_mesh
    from repro.core import distributed as D
    from repro.core.horizon import PDESConfig

    out = {}
    for name, c in json.loads(os.environ["CASES"]).items():
        mesh = make_mesh(tuple(c["shape"]), tuple(c["axes"]))
        cfg = PDESConfig(L=c["L"], n_v=c["n_v"], delta=c["delta"])
        dc = D.DistConfig(ens_axes=tuple(c["ens"]), mode=c["mode"],
                          k_chunk=c["K"])
        B = c["trials"]
        z = jnp.zeros((B,), jnp.float32)
        tau, off, comp, st = D.run_sharded_state(
            cfg, mesh, n_steps=c["steps"], seed=c["seed"], dist=dc,
            tau0=jnp.zeros((B, c["L"]), jnp.float32), off0=z, comp0=z,
            step_base=c.get("step_base", 0), deltas=c.get("deltas"),
            trial_base=jnp.asarray(c.get("trial_base", 0), jnp.int32))
        out.update({f"{name}/tau": tau, f"{name}/off": off,
                    f"{name}/comp": comp})
        out.update({f"{name}/{k}": v for k, v in st.items()})
    np.savez(os.path.join(os.environ["OUT"], "jax.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
""")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """(port's result on every rank, repro's result), run side by side."""
    work = tmp_path_factory.mktemp("sharded")
    eta = work / "eta.npy"
    np.save(eta, jax_eta_table())
    env = {"CASES": json.dumps(CASES), "OUT": str(work), "ETA": str(eta)}
    jax_env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu",
                   **env)
    jax_proc = subprocess.Popen([sys.executable, "-c", JAX_SCRIPT],
                                env=jax_env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
    try:
        run_ranks(PORT_SCRIPT, WORLD, work, env=env)
        _, err = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, err[-3000:]
    ports = [dict(np.load(work / f"port{r}.npz")) for r in range(WORLD)]
    return ports, dict(np.load(work / "jax.npz"))


EXACT = ("tau", "off", "comp", "u", "gvt")
CLOSE = ("mean_tau", "max_dev", "min_dev")
#: ``w2 = sumsq / L - mean**2`` cancels: its operands are up to a few 10**2
#: here (times of up to ~20 squared), where an fp32 ulp is 1.5e-5 to 3e-5,
#: and the sums run in another order in the two packages.  1e-4 is a few
#: ulps of the operands.
W2_ATOL = 1e-4


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_matches_repro(results, name):
    ports, ref = results
    port = ports[0]
    for k in EXACT:
        np.testing.assert_array_equal(port[f"{name}/{k}"], ref[f"{name}/{k}"],
                                      err_msg=f"{name}/{k}")
    for k in CLOSE:
        np.testing.assert_allclose(port[f"{name}/{k}"], ref[f"{name}/{k}"],
                                   rtol=RTOL, atol=1e-5,
                                   err_msg=f"{name}/{k}")
    np.testing.assert_allclose(port[f"{name}/w2"], ref[f"{name}/w2"],
                               rtol=RTOL, atol=W2_ATOL, err_msg=f"{name}/w2")
    assert port[f"{name}/u"].shape == (CASES[name]["steps"],
                                       CASES[name]["trials"])


def test_every_rank_holds_the_global_result(results):
    ports, _ = results
    for r, port in enumerate(ports[1:], 1):
        assert port.keys() == ports[0].keys()
        for k, v in port.items():
            np.testing.assert_array_equal(v, ports[0][k],
                                          err_msg=f"rank {r}: {k}")


def test_long_chunk_in_commavoid_raises(results):
    ports, _ = results
    for port in ports:
        assert "k_chunk <= L per shard" in str(port["long_k_error"])


def test_stale_gvt_is_conservative():
    """``tests/test_distributed_pdes.py``'s check on the port's reference:
    the stale window may only lower utilization, and the spread stays
    within the window plus the largest increments."""
    cfg = PDESConfig(L=64, n_v=1, delta=4.0)
    tau_e, st_e = D.run_reference(cfg, n_trials=16, n_steps=300, seed=1,
                                  device="cpu")
    tau_c, st_c = D.run_reference(cfg, n_trials=16, n_steps=300, seed=1,
                                  stale_every=8, device="cpu")
    u_e = float(st_e["u"][100:].mean())
    u_c = float(st_c["u"][100:].mean())
    assert u_c <= u_e + 0.01
    spread = tau_c.amax(-1) - tau_c.amin(-1)
    assert bool((spread <= cfg.delta + 14.0).all())


def test_reference_matches_repro():
    """The port's ``run_reference`` against ``repro``'s, JAX's η injected:
    τ, ``u`` and ``gvt`` bitwise in both modes, with a Δ column."""
    import jax.numpy as jnp
    from repro.core import distributed as JD
    from repro.core.horizon import PDESConfig as JConfig
    from repro_torch.core import horizon
    deltas = [1.0, 3.0, math.inf, 6.0]
    for stale in (None, 4):
        with horizon.eta_override(jax_eta_table()):
            tau, st = D.run_reference(
                PDESConfig(L=24, n_v=3), n_trials=4, n_steps=20, seed=4,
                stale_every=stale, deltas=deltas, trial_base=5,
                device="cpu")
        j_tau, j_st = JD.run_reference(
            JConfig(L=24, n_v=3), n_trials=4, n_steps=20, seed=4,
            stale_every=stale, deltas=jnp.asarray(deltas), trial_base=5)
        np.testing.assert_array_equal(tau.numpy(), np.asarray(j_tau))
        for k in D.STAT_KEYS:
            a, b = st[k].numpy(), np.asarray(j_st[k])
            if k in ("u", "gvt"):
                np.testing.assert_array_equal(a, b, err_msg=k)
            else:
                np.testing.assert_allclose(
                    a, b, rtol=RTOL, atol=W2_ATOL if k == "w2" else 1e-5,
                    err_msg=k)


def test_dist_config_validates():
    with pytest.raises(ValueError):
        D.DistConfig(mode="sometimes")
    with pytest.raises(ValueError, match="k_chunk"):
        D.DistConfig(k_chunk=0)
    assert D.STAT_KEYS == ("u", "w2", "gvt", "mean_tau", "max_dev",
                           "min_dev")
