"""The port's ``PDESEngine`` against ``repro``'s, and its own run semantics.

With JAX's η injected, the port's ``pallas_multistep`` (its plain version
on the CPU) and ``reference`` backends reproduce ``repro``'s
``pallas_multistep`` (interpret mode): τ, the Kahan offsets, utilization
and GVT bit for bit, the sums' statistics to ``RTOL``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PDESConfig as JConfig
from repro.core.engine import PDESEngine as JEngine
from repro_torch import bridge
from repro_torch.core import horizon as th
from repro_torch.core.engine import BACKENDS, EngineConfig, PDESEngine
from repro_torch.core.horizon import PDESConfig

from torch_parity import (RTOL, assert_stats, explicit_rebase_run,
                          jax_eta_table, np_of)

L, N_V = 48, 3
DELTAS = np.array([0.5, 2.0, math.inf, 4.0, math.inf, 1.0], np.float32)
TRIALS = np.array([0, 1, 2, 40, -1, -2], np.int32)   # pad-style negatives


def _jax_run(mode="run", n_steps=37, k_fuse=8):
    eng = JEngine(JConfig(L=L, n_v=N_V), backend="pallas_multistep",
                  k_fuse=k_fuse)
    st = eng.init(len(DELTAS))
    fn = getattr(eng, mode)
    return fn(st, 11, n_steps, deltas=jnp.asarray(DELTAS),
              trial_base=jnp.asarray(TRIALS))


def _port_run(backend, mode="run", n_steps=37, k_fuse=8):
    eng = PDESEngine(PDESConfig(L=L, n_v=N_V), backend=backend,
                     k_fuse=k_fuse, device="cpu")
    st = eng.init(len(DELTAS))
    with th.eta_override(jax_eta_table()):
        return getattr(eng, mode)(st, 11, n_steps,
                                  deltas=torch.as_tensor(DELTAS),
                                  trial_base=torch.as_tensor(TRIALS))


def _assert_state(port, ref):
    for f in ("tau", "offset", "offset_comp"):
        np.testing.assert_array_equal(np_of(getattr(port, f)),
                                      np_of(getattr(ref, f)), err_msg=f)
    assert port.step == int(ref.step)


@pytest.mark.parametrize("backend", ["pallas_multistep", "reference"])
def test_engine_run_matches_repro(backend):
    """37 steps at k_fuse=8: four chunks and a remainder chunk of 5."""
    (js, jstats), (ts, tstats) = _jax_run(), _port_run(backend)
    _assert_state(ts, js)
    assert_stats(tstats, jstats)
    assert tstats.gvt.shape == (37, len(DELTAS))


def test_engine_burn_and_mean_match_repro():
    js = _jax_run("burn_in")
    ts = _port_run("pallas_multistep", "burn_in")
    _assert_state(ts, js)
    (js, jmean), (ts, tmean) = _jax_run("run_mean"), \
        _port_run("pallas_multistep", "run_mean")
    _assert_state(ts, js)
    # the time average sums (K, B) planes in another order: RTOL only
    for f in jmean._fields:
        np.testing.assert_allclose(np_of(getattr(tmean, f)),
                                   np_of(getattr(jmean, f)), rtol=RTOL,
                                   atol=1e-5, err_msg=f)


def test_bridge_carries_a_jax_state_into_the_port():
    """A state burned by repro continues in the port as it does in repro."""
    js = _jax_run("burn_in", n_steps=16)
    state = bridge.state_from_numpy(np.asarray(js.tau), np.asarray(js.offset),
                                    np.asarray(js.offset_comp), int(js.step),
                                    device="cpu")
    back = bridge.state_to_numpy(state)
    np.testing.assert_array_equal(back[0], np.asarray(js.tau))
    assert back[3] == 16
    jeng = JEngine(JConfig(L=L, n_v=N_V), backend="pallas_multistep",
                   k_fuse=8)
    j2, jst = jeng.run(js, 11, 12, deltas=jnp.asarray(DELTAS),
                       trial_base=jnp.asarray(TRIALS))
    teng = PDESEngine(PDESConfig(L=L, n_v=N_V), backend="pallas_multistep",
                      k_fuse=8, device="cpu")
    with th.eta_override(jax_eta_table()):
        t2, tst = teng.run(state, 11, 12, deltas=torch.as_tensor(DELTAS),
                           trial_base=torch.as_tensor(TRIALS))
    _assert_state(t2, j2)
    assert_stats(tst, jst)
    with pytest.raises(ValueError):
        bridge.state_from_numpy(np.zeros((2, 4)), np.zeros(3), np.zeros(3), 0,
                                device="cpu")


def test_engine_run_matches_repro_on_the_production_ring():
    """The paper's production ring (L = 2^20, n_v = 100, Δ = 100), whose
    B1 launch on the card is split over a cooperative grid: one trial, 6
    steps (a chunk of 4 and a remainder of 2), the port's plain version
    against ``repro``'s ``pallas_multistep`` (interpret mode) at level 2."""
    Lp, deltas, trials = 1 << 20, np.array([100.0], np.float32), \
        np.array([3], np.int32)
    jeng = JEngine(JConfig(L=Lp, n_v=100, delta=100.0),
                   backend="pallas_multistep", k_fuse=4)
    js, jstats = jeng.run(jeng.init(1), 7, 6, deltas=jnp.asarray(deltas),
                          trial_base=jnp.asarray(trials))
    teng = PDESEngine(PDESConfig(L=Lp, n_v=100, delta=100.0),
                      backend="pallas_multistep", k_fuse=4, device="cpu")
    with th.eta_override(jax_eta_table()):
        ts, tstats = teng.run(teng.init(1), 7, 6,
                              deltas=torch.as_tensor(deltas),
                              trial_base=torch.as_tensor(trials))
    _assert_state(ts, js)
    assert_stats(tstats, jstats)
    assert tstats.gvt.shape == (6, 1)


def test_backends_agree_within_the_port():
    """reference == pallas_multistep bit for bit, on the port's own decode."""
    cfg = PDESConfig(L=64, n_v=4, delta=10.0)
    outs = {}
    for backend in ("reference", "pallas_multistep"):
        eng = PDESEngine(cfg, backend=backend, k_fuse=16, device="cpu")
        outs[backend] = eng.run(eng.init(8), 5, 40)
    (sa, a), (sb, b) = outs.values()
    assert torch.equal(sa.tau, sb.tau) and torch.equal(sa.offset, sb.offset)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


#: (Δ, trial_base, n_steps) of the fused loop's cases at k_fuse = 8: per-row
#: Δ with ``inf`` rows or the static Δ, per-row trials or a scalar base,
#: four chunks and a remainder of 5 or one short chunk (n_steps < k_fuse)
FUSED_CASES = {"vectors": (DELTAS, TRIALS, 37), "scalars": (None, 7, 37),
               "short": (DELTAS, -3, 5), "short_static": (None, TRIALS, 5)}


def _case(name):
    d, t, n = FUSED_CASES[name]
    return (None if d is None else torch.as_tensor(d),
            torch.as_tensor(t) if isinstance(t, np.ndarray) else t, n)


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("mode", ["run", "run_mean", "burn_in"])
def test_fused_rebase_agrees_with_the_loops_bitwise(mode, case):
    """B1 rebasing in its store (the fused path, its pass prepared once)
    against the chunk loop's own amin and subtraction (the reference
    backend): τ, offset, its compensation and every StepStats field bit
    for bit, from a resumed state; the input τ is left as it was."""
    cfg = PDESConfig(L=L, n_v=N_V, delta=3.0)
    deltas, trials, n = _case(case)
    outs = []
    for backend in ("reference", "pallas_multistep"):
        eng = PDESEngine(cfg, backend=backend, k_fuse=8, device="cpu")
        st, _ = eng.run(eng.init(len(DELTAS)), 5, 13, deltas=deltas,
                        trial_base=trials)           # a chunk and 5
        tau0 = st.tau.clone()
        out = getattr(eng, mode)(st, 5, n, deltas=deltas,
                                 trial_base=trials)
        assert torch.equal(st.tau, tau0)
        outs.append((out, None) if mode == "burn_in" else out)
    (sa, a), (sb, b) = outs
    assert sa.step == sb.step == 13 + n
    for f in ("tau", "offset", "offset_comp"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    assert float(sb.offset.min()) > 0
    if mode != "burn_in":
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.gvt.shape == ((n, len(DELTAS)) if mode == "run"
                               else (len(DELTAS),))


def test_fused_rebase_equals_the_explicit_loop():
    """The fused path's run equals the chunk loop that takes B1's output
    unrebased and subtracts its own ``amin``, bit for bit, from a resumed
    state over a remainder chunk."""
    cfg = PDESConfig(L=L, n_v=N_V, delta=2.0)
    eng = PDESEngine(cfg, backend="pallas_multistep", k_fuse=8, device="cpu")
    deltas, trials = torch.as_tensor(DELTAS), torch.as_tensor(TRIALS)
    st = eng.burn_in(eng.init(len(DELTAS)), 2, 12, deltas=deltas,
                     trial_base=trials)
    sa, a = eng.run(st, 2, 29, deltas=deltas, trial_base=trials)
    sb, b = explicit_rebase_run(eng, st, 2, 29, deltas=deltas,
                                trial_base=trials)
    assert sa.step == sb.step == 41
    for f in ("tau", "offset", "offset_comp"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("case", FUSED_CASES)
@pytest.mark.parametrize("mode", ["run", "run_mean", "burn_in"])
def test_stale_fused_equals_the_stale_loops_bitwise(mode, case):
    """The stale window on the fused path (B1's plain version, its base the
    ring minimum of each chunk's input τ) against the ``reference`` and
    ``pallas`` engines, whose loops take that base with ``amin``: τ,
    offset, its compensation and every StepStats field bit for bit, from
    a state burned over a remainder chunk; the input τ is left as it
    was."""
    cfg = PDESConfig(L=L, n_v=N_V, delta=3.0)
    deltas, trials, n = _case(case)
    outs = []
    for backend in ("pallas_multistep", "reference", "pallas"):
        eng = PDESEngine(cfg, backend=backend, window="stale", k_fuse=8,
                         device="cpu")
        st = eng.burn_in(eng.init(len(DELTAS)), 6, 13, deltas=deltas,
                         trial_base=trials)          # a chunk and 5
        tau0 = st.tau.clone()
        out = getattr(eng, mode)(st, 6, n, deltas=deltas,
                                 trial_base=trials)
        assert torch.equal(st.tau, tau0)
        outs.append((out, None) if mode == "burn_in" else out)
    (sa, a), *others = outs
    assert sa.step == 13 + n and float(sa.offset.min()) > 0
    for sb, b in others:
        for f in ("tau", "offset", "offset_comp"):
            assert torch.equal(getattr(sa, f), getattr(sb, f)), f
        if mode != "burn_in":
            for f in a._fields:
                assert torch.equal(getattr(a, f), getattr(b, f)), f
    ex = PDESEngine(cfg, backend="pallas_multistep", k_fuse=8, device="cpu")
    st = ex.burn_in(ex.init(len(DELTAS)), 6, 13, deltas=deltas,
                    trial_base=trials)
    st = ex.burn_in(st, 6, n, deltas=deltas, trial_base=trials)
    assert not torch.equal(st.tau, sa.tau)          # the windows differ


def test_remainder_chunks_and_resume():
    cfg = PDESConfig(L=64, n_v=2, delta=8.0)
    eng = PDESEngine(cfg, backend="pallas_multistep", k_fuse=8, device="cpu")
    a, _ = eng.run(eng.init(4), 3, 11)
    a, _ = eng.run(a, 3, 8)
    b, _ = eng.run(eng.init(4), 3, 19)
    ta = (a.tau + a.offset[:, None]).numpy()
    tb = (b.tau + b.offset[:, None]).numpy()
    np.testing.assert_allclose(ta, tb, rtol=1e-6, atol=1e-5)
    assert a.step == b.step == 19


def test_run_mean_matches_run_and_burn_advances():
    cfg = PDESConfig(L=64, n_v=3, delta=5.0)
    eng = PDESEngine(cfg, backend="pallas_multistep", k_fuse=8, device="cpu")
    st0 = eng.init(4)
    _, per_step = eng.run(st0, 9, 24)
    st_m, mean = eng.run_mean(st0, 9, 24)
    for f in mean._fields:
        np.testing.assert_allclose(getattr(mean, f).numpy(),
                                   getattr(per_step, f).mean(0).numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    assert st_m.step == 24
    st = PDESEngine(PDESConfig(L=32, n_v=1, delta=4.0),
                    device="cpu").burn_in(eng.init(4), 0, 50)
    assert st.step == 50 and float(st.offset.min()) > 0


def test_stale_window_is_conservative_and_delta_zero_serializes():
    cfg = PDESConfig(L=64, n_v=1, delta=4.0)
    u = {}
    for window in ("exact", "stale"):
        eng = PDESEngine(cfg, window=window, k_fuse=8, device="cpu")
        st = eng.burn_in(eng.init(16), 1, 96)
        _, mean = eng.run_mean(st, 1, 200)
        u[window] = float(mean.utilization.mean())
    assert u["stale"] <= u["exact"] + 0.01
    eng = PDESEngine(PDESConfig(L=16, n_v=1, delta=0.0),
                     backend="pallas_multistep", k_fuse=8, device="cpu")
    _, mean = eng.run_mean(eng.burn_in(eng.init(16), 2, 48), 2, 400)
    assert abs(float(mean.utilization.mean()) - 1.0 / 16) < 0.02


def test_engine_validation():
    cfg = PDESConfig(L=16, n_v=1)
    with pytest.raises(ValueError):
        PDESEngine(cfg, backend="nope", device="cpu")
    # B1 serves the stale window too
    eng = PDESEngine(cfg, backend="pallas_multistep", window="stale",
                     device="cpu")
    assert (eng.ecfg.backend, eng.ecfg.window) == ("pallas_multistep",
                                                   "stale")
    with pytest.raises(ValueError, match="requires a mesh"):
        PDESEngine(cfg, backend="sharded", device="cpu")
    from repro_torch.core.distributed import DistConfig
    from repro_torch.core.mesh import ProcessMesh
    mesh = ProcessMesh.abstract((1, 1), ("data", "model"))
    with pytest.raises(ValueError, match="conflicts"):
        PDESEngine(cfg, backend="sharded", window="stale", device="cpu",
                   mesh=mesh, dist=DistConfig(mode="exact"))
    eng = PDESEngine(cfg, backend="sharded", window="stale", k_fuse=4,
                     device="cpu", mesh=mesh)
    assert (eng.dist.mode, eng.dist.k_chunk) == ("commavoid", 4)
    with pytest.raises(ValueError, match="whole chunks"):
        eng.run(eng.init(2), 0, 6)
    eng = PDESEngine(cfg, backend="pallas_multistep", window="stale",
                     k_fuse=4, device="cpu")
    st, _ = eng.run(eng.init(2), 0, 6)     # a chunk and a remainder of 2
    assert st.step == 6 and float(st.tau.amin()) == 0.0
    PDESEngine(cfg, backend="pallas", window="stale", device="cpu")
    with pytest.raises(ValueError):
        EngineConfig(window="sorta")
    with pytest.raises(ValueError):
        EngineConfig(k_fuse=0)
    with pytest.raises(ValueError):
        PDESEngine(cfg, device="meta")
    eng = PDESEngine(cfg, device="cpu")
    st = eng.init(2)
    with pytest.raises(ValueError):
        eng.run(st, 0, 0)
    with pytest.raises(ValueError, match="deltas"):
        eng.run(st, 0, 4, deltas=torch.ones(3))
    with pytest.raises(ValueError, match="trial_base"):
        eng.run(st, 0, 4, trial_base=torch.arange(3))
    with pytest.raises(ValueError, match="trial_base"):
        eng.run(st, 0, 4, trial_base=torch.ones(2))
    assert BACKENDS == ("reference", "pallas", "pallas_multistep", "sharded")


def test_default_device_is_the_gpu(monkeypatch):
    """Without CUDA, an engine that was not asked for the CPU raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDESEngine(PDESConfig(L=16))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        PDESEngine(PDESConfig(L=16), device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bridge.state_from_numpy(np.zeros((1, 4)), np.zeros(1), np.zeros(1), 0)
