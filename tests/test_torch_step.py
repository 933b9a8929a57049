"""The port's one-step kernel ``pdes_step`` against the JAX kernel (interpret mode).

On CPU tensors the wrapper runs its plain PyTorch version,
``ref.pdes_step_ref``; that is what is held here against
``repro.kernels.pdes_step.pdes_step(interpret=True)`` and
``repro.kernels.ref.pdes_step_ref`` with JAX's η injected, on the same
numpy inputs.  τ′, ``ucount``, ``min`` and ``max`` are bitwise equal; the
sums agree to ``RTOL``.  The CUDA kernel itself is held against the same
plain version on the GPU (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.horizon import PDESConfig as JConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.pdes_step import pdes_step as jax_step
from repro_torch.core import horizon as th
from repro_torch.core.horizon import PDESConfig
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import pdes_step as ps

from torch_parity import assert_moments, jax_eta_table

# the shape list of tests/test_kernels.py (test_pdes_step_matches_ref)
SWEEP = [
    # (L, n_v, delta, rd_mode, B)
    (8, 1, math.inf, False, 3),
    (64, 1, math.inf, False, 12),
    (32, 10, 5.0, False, 8),
    (128, 3, 1.0, False, 4),
    (256, 1, 0.0, False, 2),
    (64, 100, 10.0, True, 8),
    (512, 7, 100.0, False, 1),
]


def _inputs(B, Lc, seed=0):
    """Haloed τ, uint32 bits and the exact window base, from numpy."""
    rng = np.random.default_rng(seed)
    tau = rng.exponential(2.0, (B, Lc)).astype(np.float32)
    tau_h = np.concatenate([tau[:, -1:], tau, tau[:, :1]], axis=1)
    bits = rng.integers(0, 2**32, size=(B, Lc, 2), dtype=np.uint32)
    gvt = tau.min(axis=1, keepdims=True)
    return tau_h, bits, gvt


def _port(tau_h, bits, gvt, **kw):
    with th.eta_override(jax_eta_table()):
        return ps.pdes_step(torch.as_tensor(tau_h),
                            torch.as_tensor(bits.astype(np.int64)),
                            torch.as_tensor(gvt), **kw)


def _jax(tau_h, bits, gvt, **kw):
    return jax_step(jnp.asarray(tau_h), jnp.asarray(bits), jnp.asarray(gvt),
                    interpret=True, **kw)


def _assert_same(port, ref_out, msg=""):
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref_out[0]),
                                  err_msg=f"{msg}tau")
    assert_moments(port[1], ref_out[1], msg)


@pytest.mark.parametrize("L,n_v,delta,rd,B", SWEEP)
def test_pdes_step_matches_jax(L, n_v, delta, rd, B):
    tau_h, bits, gvt = _inputs(B, L)
    kw = dict(n_v=n_v, delta=delta, rd_mode=rd)
    port = _port(tau_h, bits, gvt, **kw)
    _assert_same(port, _jax(tau_h, bits, gvt, **kw))
    # the plain version against repro's oracle, update mask included
    with th.eta_override(jax_eta_table()):
        t_p, u_p, m_p = ref.pdes_step_ref(
            torch.as_tensor(tau_h), torch.as_tensor(bits.astype(np.int64)),
            torch.as_tensor(gvt), **kw)
    t_j, u_j, m_j = jref.pdes_step_ref(jnp.asarray(tau_h), jnp.asarray(bits),
                                       jnp.asarray(gvt), **kw)
    np.testing.assert_array_equal(t_p.numpy(), np.asarray(t_j))
    np.testing.assert_array_equal(u_p.numpy(), np.asarray(u_j))
    assert_moments(m_p, m_j)


@pytest.mark.parametrize("border_both", [False, True])
def test_pdes_step_stale_base_and_folded_delta_match_jax(border_both):
    """A stale base below the row minimum, and a per-row Δ column (with
    ``inf`` rows) folded into the base with a static Δ of 0."""
    B, Lc = 8, 40
    tau_h, bits, gvt = _inputs(B, Lc, seed=1)
    stale = gvt - np.float32(1.5)
    dcol = np.array([0.0, 1.0, np.inf, 3.0, 8.0, np.inf, 2.0, 0.5],
                    np.float32)[:, None]
    for base, delta in ((stale, 2.0), (stale + dcol, 0.0), (gvt + dcol, 0.0)):
        kw = dict(n_v=4, delta=delta, border_both=border_both)
        _assert_same(_port(tau_h, bits, base, **kw),
                     _jax(tau_h, bits, base, **kw))


@pytest.mark.parametrize("border_both", [False, True])
def test_step_ring_matches_jax_and_the_core(border_both):
    """``ops.step_ring`` against repro's, and against ``horizon.step_core``."""
    B, L, n_v, delta = 6, 48, 5, 3.0
    _, bits, _ = _inputs(B, L, seed=3)
    tau = np.random.default_rng(4).exponential(2.0, (B, L)).astype(np.float32)
    cfg = PDESConfig(L=L, n_v=n_v, delta=delta, border_both=border_both)
    tb = torch.as_tensor(bits.astype(np.int64))
    with th.eta_override(jax_eta_table()):
        t_port, m_port = ops.step_ring(torch.as_tensor(tau), tb, cfg)
        is_l, is_r, eta = th.decode_events(tb, cfg)
        t_core, _, _ = th.step_core(torch.as_tensor(tau), is_l, is_r, eta,
                                    cfg)
    assert torch.equal(t_port, t_core)
    if not border_both:          # repro's step_ring ignores border_both
        t_j, m_j = jops.step_ring(jnp.asarray(tau), jnp.asarray(bits),
                                  JConfig(L=L, n_v=n_v, delta=delta))
        _assert_same((t_port, m_port), (t_j, m_j))
    h = ops.ring_halo(torch.as_tensor(tau))
    np.testing.assert_array_equal(h.numpy(),
                                  np.asarray(jops.ring_halo(jnp.asarray(tau))))


def test_wrapper_checks_and_cpu_path():
    """Moments come as six (B,) rows; the CPU path launches nothing."""
    B, Lc = 4, 16
    tau_h = torch.zeros(B, Lc + 2)
    bits = torch.zeros(B, Lc, 2, dtype=torch.int64)
    gvt = torch.zeros(B, 1)
    before = ps.launches
    tau, m = ps.pdes_step(tau_h, bits, gvt, n_v=2, delta=1.0)
    assert ps.launches == before
    assert tau.shape == (B, Lc) and list(m) == list(th.MOMENT_KEYS)
    assert all(v.shape == (B,) for v in m.values())
    np.testing.assert_array_equal(m["ucount"].numpy(), Lc)   # synchronized
    bad = [
        (torch.zeros(B, Lc + 2, dtype=torch.float64), bits, gvt),
        (torch.zeros(B, 2), torch.zeros(B, 0, 2, dtype=torch.int64), gvt),
        (tau_h, torch.zeros(B, Lc + 1, 2, dtype=torch.int64), gvt),
        (tau_h, bits.float(), gvt),
        (tau_h, bits.to(torch.int32), gvt),
        (tau_h, bits, torch.zeros(B)),
        (tau_h, bits, torch.zeros(B, 1, dtype=torch.float64)),
    ]
    for args in bad:
        with pytest.raises(ValueError):
            ps.pdes_step(*args, n_v=1, delta=1.0)
    with pytest.raises(ValueError, match="n_v"):
        ps.pdes_step(tau_h, bits, gvt, n_v=0, delta=1.0)
    with pytest.raises(ValueError, match="device"):
        ps.pdes_step(tau_h.to("meta"), bits, gvt, n_v=1, delta=1.0)


def test_library_path_follows_included_headers(monkeypatch, tmp_path):
    """An edited header gives every source a new library; nothing else does."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "common.cuh"\n')
    (csrc / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.library_path("k")
    assert first == _build.library_path("k")
    (csrc / "common.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.name.startswith("libk-")
    (csrc / "other.txt").write_text("not a header")
    assert _build.library_path("k") == second
    (csrc / "k.cu").write_text('#include "common.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


def test_both_kernels_share_the_rules_header():
    for name in ("pdes_step", "pdes_multistep_counter"):
        src = (_build.CSRC / f"{name}.cu").read_text()
        assert '#include "pdes_common.cuh"' in src, name
        assert "eta_from_w1(uint32_t" not in src, name   # defined once
    assert "eta_from_w1(uint32_t" in (_build.CSRC /
                                      "pdes_common.cuh").read_text()


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("pdes_step")
    assert _build.library_path("pdes_step").name.startswith("libpdes_step-")
