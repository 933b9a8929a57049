"""The port's update core against ``repro.core.horizon``, with JAX's η injected.

τ, the update mask, GVT, ``ucount``, ``min`` and ``max`` are bitwise equal;
``sum``/``sumsq``/``sumabs`` agree to ``RTOL`` (another reduction order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import horizon as jh
from repro_torch.core import horizon as th

from torch_parity import RTOL, assert_moments, assert_stats, jax_eta_table

B, L = 6, 48


def _inputs(seed):
    """τ with ties (quantized), random event words, and per-row Δ columns."""
    rng = np.random.default_rng(seed)
    tau = (np.round(rng.exponential(3.0, (B, L)) * 4) / 4).astype(np.float32)
    w0 = rng.integers(0, 1 << 32, (B, L), dtype=np.uint64).astype(np.uint32)
    w1 = rng.integers(0, 1 << 32, (B, L), dtype=np.uint64).astype(np.uint32)
    dcol = np.array([0.0, 1.0, 2.5, np.inf, 4.0, np.inf],
                    np.float32)[:B, None]
    return tau, w0, w1, dcol


def _decoded(w0, w1, n_v):
    jl, jr, je = jh.decode_words(jnp.asarray(w0), jnp.asarray(w1), n_v,
                                 jnp.float32)
    with th.eta_override(jax_eta_table()):
        tl, tr, te = th.decode_words(torch.as_tensor(w0.astype(np.int64)),
                                     torch.as_tensor(w1.astype(np.int64)),
                                     n_v, torch.float32)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    return (jl, jr, je), (tl, tr, te)


@pytest.mark.parametrize("n_v", [1, 2, 10])
@pytest.mark.parametrize("delta", [math.inf, 2.0, "col"])
@pytest.mark.parametrize("mode", ["plain", "rd_mode", "border_both"])
def test_step_core_and_moments_match_reference(n_v, delta, mode):
    tau, w0, w1, dcol = _inputs(n_v * 7 + len(mode))
    (jl, jr, je), (tl, tr, te) = _decoded(w0, w1, n_v)
    opts = dict(rd_mode=mode == "rd_mode", border_both=mode == "border_both")
    static = math.inf if delta == "col" else delta
    jcfg = jh.PDESConfig(L=L, n_v=n_v, delta=static, **opts)
    tcfg = th.PDESConfig(L=L, n_v=n_v, delta=static, **opts)
    jd = None if delta != "col" else jnp.asarray(dcol)
    td = None if delta != "col" else torch.as_tensor(dcol)
    j_tau, j_upd, j_gvt = jh.step_core(jnp.asarray(tau), jl, jr, je, jcfg,
                                       delta_override=jd)
    t_tau, t_upd, t_gvt = th.step_core(torch.as_tensor(tau), tl, tr, te, tcfg,
                                       delta_override=td)
    np.testing.assert_array_equal(t_tau.numpy(), np.asarray(j_tau))
    np.testing.assert_array_equal(t_upd.numpy(), np.asarray(j_upd))
    np.testing.assert_array_equal(t_gvt.numpy(), np.asarray(j_gvt))
    assert_moments(th.ring_moments(t_tau, t_upd),
                   jh.ring_moments(j_tau, j_upd))
    # jnp.mean multiplies by 1/L where torch divides: measure agrees to RTOL
    off = np.linspace(0, 100, B).astype(np.float32)
    t_st = th.measure(t_tau, t_upd, torch.as_tensor(off))
    j_st = jh.measure(j_tau, j_upd, jnp.asarray(off))
    for f in j_st._fields:
        np.testing.assert_allclose(getattr(t_st, f).numpy(),
                                   np.asarray(getattr(j_st, f)), rtol=RTOL,
                                   atol=1e-5, err_msg=f)


def test_stale_gvt_and_inf_rows_match_reference():
    """``gvt_for_window`` (a stale base) and Δ rows holding inf."""
    tau, w0, w1, dcol = _inputs(3)
    (jl, jr, je), (tl, tr, te) = _decoded(w0, w1, 4)
    stale = (tau.min(axis=1, keepdims=True) - 1.5).astype(np.float32)
    j = jh.step_core(jnp.asarray(tau), jl, jr, je, jh.PDESConfig(L=L, n_v=4),
                     gvt_for_window=jnp.asarray(stale),
                     delta_override=jnp.asarray(dcol))
    t = th.step_core(torch.as_tensor(tau), tl, tr, te,
                     th.PDESConfig(L=L, n_v=4),
                     gvt_for_window=torch.as_tensor(stale),
                     delta_override=torch.as_tensor(dcol))
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_inf_column_rows_equal_static_inf():
    """A (B, 1) Δ column of inf gives the static-inf (short-circuit) result."""
    tau, w0, w1, _ = _inputs(5)
    _, (tl, tr, te) = _decoded(w0, w1, 2)
    tt = torch.as_tensor(tau)
    left, right = torch.roll(tt, 1, -1), torch.roll(tt, -1, -1)
    gvt = tt.amin(-1, keepdim=True)
    a = th.conservative_update(tt, left, right, tl, tr, te, gvt,
                               delta=math.inf)
    b = th.conservative_update(tt, left, right, tl, tr, te, gvt,
                               delta=torch.full((B, 1), math.inf))
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_stats_from_moments_and_kahan_match_reference():
    rng = np.random.default_rng(11)
    m = {k: rng.random((5, B)).astype(np.float32) * 50
         for k in th.MOMENT_KEYS}
    off = rng.random(B).astype(np.float32) * 1e4
    # compiled, as the reference's engine runs it (x / L becomes x * (1/L));
    # XLA may contract w2's multiply and subtract, so that one is to RTOL
    j = jax.jit(jh.stats_from_moments, static_argnums=2)(
        {k: jnp.asarray(v) for k, v in m.items()}, jnp.asarray(off)[None, :],
        L)
    t = th.stats_from_moments({k: torch.as_tensor(v) for k, v in m.items()},
                              torch.as_tensor(off)[None, :], L)
    assert_stats(t, j)
    total, comp = off.copy(), np.zeros(B, np.float32)
    jt, jc, tt, tc = jnp.asarray(total), jnp.asarray(comp), \
        torch.as_tensor(total), torch.as_tensor(comp)
    for _ in range(50):
        x = rng.random(B).astype(np.float32) * 3
        jt, jc = jh._kahan_add(jt, jc, jnp.asarray(x))
        tt, tc = th._kahan_add(tt, tc, torch.as_tensor(x))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_config_errors_and_init_state():
    for bad in (dict(L=1), dict(L=8, n_v=0), dict(L=8, delta=-1.0),
                dict(L=8, delta=math.nan)):
        with pytest.raises(ValueError):
            jh.PDESConfig(**bad)
        with pytest.raises(ValueError):
            th.PDESConfig(**bad)
    st = th.init_state(th.PDESConfig(L=8), 3, "cpu")
    assert st.tau.shape == (3, 8) and st.tau.dtype == torch.float32
    assert st.step == 0 and not st.offset.any() and not st.offset_comp.any()
    assert st.offset.data_ptr() != st.offset_comp.data_ptr()
    assert th.MOMENT_KEYS == jh.MOMENT_KEYS
