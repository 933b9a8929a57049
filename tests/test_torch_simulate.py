"""The threefry path of the port against ``repro``, with JAX's η injected.

1. B3's plain version (``kernels.pdes_multistep`` on CPU tensors) against
   ``repro.kernels.ops.pdes_multistep`` in interpret mode over
   ``tests/test_kernels.py``'s ``SWEEP[:5]`` x K in {1, 4, 6}, plus
   ``border_both``: τ, ``ucount``, ``min`` and ``max`` bitwise, the sums
   to ``RTOL`` (1e-5; another reduction order).
2. ``horizon.run`` / ``run_mean`` / ``burn_in`` against ``repro``'s: τ,
   offsets, utilization and GVT bitwise (level 2), the other StepStats to
   ``RTOL``.  ``run_mean``'s time-averaged utilization agrees to ``RTOL``
   only: XLA may fuse the reference's accumulation into an FMA (ROADMAP
   C3); its averaged GVT is bitwise.
3. ``ops.simulate`` against ``repro.kernels.ops.simulate`` at
   ``tests/test_kernels.py``'s ``(n_steps, k_fuse)`` cases, with the same
   chunking: τ, offsets, ``u`` and ``gvt`` bitwise, ``w2`` to ``RTOL``;
   and against the port's own ``horizon.run`` at that test's tolerances.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import horizon as jh
from repro.kernels import ops as jops
from repro_torch.core import horizon as th
from repro_torch.core import prng
from repro_torch.kernels import ops, pdes_multistep as pm

from torch_parity import RTOL, assert_moments, jax_eta_table, np_of

KEY = 7
#: tests/test_kernels.py's SWEEP[:5]: (L, n_v, delta, rd_mode, B)
SWEEP = [
    (8, 1, math.inf, False, 3),
    (64, 1, math.inf, False, 12),
    (32, 10, 5.0, False, 8),
    (128, 3, 1.0, False, 4),
    (256, 1, 0.0, False, 2),
]


def _burned(L, n_v, delta, rd, B, border_both=False):
    """The JAX state after 7 steps and the JAX words of the next K steps."""
    cfg = jh.PDESConfig(L=L, n_v=n_v, delta=delta, rd_mode=rd,
                        border_both=border_both)
    key = jax.random.key(KEY)
    state = jh.burn_in(jh.init_state(cfg, B), key, cfg, 7)
    return state, lambda K: jnp.stack(
        [jh.event_bits(key, state.step + i, state.tau.shape)
         for i in range(K)])


@pytest.mark.parametrize("L,n_v,delta,rd,B", SWEEP)
@pytest.mark.parametrize("K", [1, 4, 6])
def test_pdes_multistep_plain_version_matches_repro(L, n_v, delta, rd, B, K):
    state, bits_of = _burned(L, n_v, delta, rd, B)
    bits = bits_of(K)
    kw = dict(n_v=n_v, delta=delta, rd_mode=rd)
    j_tau, j_m = jops.pdes_multistep(state.tau, bits, **kw)
    words = np.array(bits)          # writable, so torch can share it
    launches = pm.bits_launches
    with th.eta_override(jax_eta_table()):
        # int64-carried words and int32 bit patterns alike
        for t_bits in (torch.as_tensor(words.astype(np.int64)),
                       torch.as_tensor(words.view(np.int32))):
            t_tau, t_m = pm.pdes_multistep(torch.as_tensor(
                np.array(state.tau)), t_bits, **kw)
            np.testing.assert_array_equal(t_tau.numpy(), np.asarray(j_tau))
            assert_moments(t_m, j_m)
    assert pm.bits_launches == launches        # the CPU runs the plain path


def test_pdes_multistep_border_both_matches_repro():
    state, bits_of = _burned(32, 10, 5.0, False, 8, border_both=True)
    bits = bits_of(4)
    kw = dict(n_v=10, delta=5.0, border_both=True)
    j_tau, j_m = jops.pdes_multistep(state.tau, bits, **kw)
    with th.eta_override(jax_eta_table()):
        t_tau, t_m = pm.pdes_multistep(
            torch.as_tensor(np.array(state.tau)),
            torch.as_tensor(np.asarray(bits).astype(np.int64)), **kw)
    np.testing.assert_array_equal(t_tau.numpy(), np.asarray(j_tau))
    assert_moments(t_m, j_m)


def test_pdes_multistep_validates_its_arguments():
    tau = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="bits must be"):
        pm.pdes_multistep(tau, torch.zeros(3, 2, 7, 2, dtype=torch.int32),
                          n_v=1, delta=1.0)
    with pytest.raises(ValueError, match="bits must be"):
        pm.pdes_multistep(tau, torch.zeros(3, 2, 8, 2), n_v=1, delta=1.0)
    with pytest.raises(ValueError, match="n_v"):
        pm.pdes_multistep(tau, torch.zeros(1, 2, 8, 2, dtype=torch.int32),
                          n_v=0, delta=1.0)


def _state_equal(port, ref):
    for f in ("tau", "offset", "offset_comp"):
        np.testing.assert_array_equal(np_of(getattr(port, f)),
                                      np_of(getattr(ref, f)), err_msg=f)
    assert int(port.step) == int(ref.step)


def _stats_close(port, ref, exact):
    for f in ref._fields:
        a, b = np_of(getattr(port, f)), np_of(getattr(ref, f))
        if f in exact:
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5,
                                       err_msg=f)


@pytest.mark.parametrize("L,n_v,delta,opts,B", [
    (64, 4, 8.0, {}, 8), (48, 1, math.inf, {}, 5),
    (33, 10, 2.0, {"border_both": True}, 3),
    (40, 3, 4.0, {"rd_mode": True}, 4)])
def test_horizon_drivers_match_repro(L, n_v, delta, opts, B):
    jcfg = jh.PDESConfig(L=L, n_v=n_v, delta=delta, **opts)
    tcfg = th.PDESConfig(L=L, n_v=n_v, delta=delta, **opts)
    jkey, tkey = jax.random.key(3), prng.key(3)
    j_st, j_stats = jh.run(jh.init_state(jcfg, B), jkey, jcfg, 37)
    j_mean_st, j_mean = jh.run_mean(j_st, jkey, jcfg, 23)
    j_burn = jh.burn_in(j_mean_st, jkey, jcfg, 11)
    with th.eta_override(jax_eta_table()):
        t_st, t_stats = th.run(th.init_state(tcfg, B, "cpu"), tkey, tcfg, 37)
        t_mean_st, t_mean = th.run_mean(t_st, tkey, tcfg, 23)
        t_burn = th.burn_in(t_mean_st, tkey, tcfg, 11)
    _state_equal(t_st, j_st)
    _stats_close(t_stats, j_stats, ("utilization", "gvt"))
    _state_equal(t_mean_st, j_mean_st)
    _stats_close(t_mean, j_mean, ("gvt",))
    _state_equal(t_burn, j_burn)


@pytest.mark.parametrize("n_steps,k_fuse", [(5, 8), (16, 8), (37, 8), (24, 6)])
def test_simulate_matches_repro(n_steps, k_fuse):
    jcfg = jh.PDESConfig(L=64, n_v=4, delta=8.0)
    tcfg = th.PDESConfig(L=64, n_v=4, delta=8.0)
    j_st, j_out = jops.simulate(jh.init_state(jcfg, 8), jax.random.key(3),
                                jcfg, n_steps, k_fuse=k_fuse)
    with th.eta_override(jax_eta_table()):
        t_st, t_out = ops.simulate(th.init_state(tcfg, 8, "cpu"),
                                   prng.key(3), tcfg, n_steps, k_fuse=k_fuse)
        r_st, r_stats = th.run(th.init_state(tcfg, 8, "cpu"), prng.key(3),
                               tcfg, n_steps)
    _state_equal(t_st, j_st)
    assert t_out.keys() == j_out.keys()
    for name in ("u", "gvt"):
        np.testing.assert_array_equal(t_out[name].numpy(),
                                      np.asarray(j_out[name]), err_msg=name)
    np.testing.assert_allclose(t_out["w2"].numpy(), np.asarray(j_out["w2"]),
                               rtol=RTOL, atol=1e-5)
    # against the port's per-step driver, at tests/test_kernels.py's bounds
    np.testing.assert_allclose(r_stats.utilization.numpy(),
                               t_out["u"].numpy(), rtol=1e-6)
    np.testing.assert_allclose(r_stats.w2.numpy(), t_out["w2"].numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        (r_st.tau + r_st.offset[:, None]).numpy(),
        (t_st.tau + t_st.offset[:, None]).numpy(), rtol=1e-5, atol=1e-4)


def test_simulate_validates_its_arguments():
    cfg = th.PDESConfig(L=8)
    st = th.init_state(cfg, 2, "cpu")
    for n_steps, k_fuse in ((0, 4), (4, 0)):
        with pytest.raises(ValueError, match="n_steps"):
            ops.simulate(st, prng.key(0), cfg, n_steps, k_fuse=k_fuse)
