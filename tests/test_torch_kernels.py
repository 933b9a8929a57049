"""The port's ``pdes_multistep_counter`` against the JAX kernel (interpret mode).

On CPU tensors the wrapper runs its plain PyTorch version; that is what is
held here against ``repro.kernels.pdes_multistep.pdes_multistep_counter``
with JAX's η injected.  τ, ``ucount``, ``min`` and ``max`` are bitwise
equal; the sums agree to ``RTOL``.  The CUDA kernel itself is held against
the same plain version on the GPU by ``chip_smoke.py``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import tiling as jtiling
from repro.kernels.pdes_multistep import \
    pdes_multistep_counter as jax_counter
from repro_torch.core import horizon as th
from repro_torch.kernels import _build, ref, tiling
from repro_torch.kernels import pdes_multistep as pm

from torch_parity import assert_moments, jax_eta_table

# the grid of tests/test_kernels.py::test_pdes_multistep_counter_matches_ref
SWEEP = [
    # (L, n_v, delta, rd_mode, B)
    (8, 1, math.inf, False, 3),
    (64, 1, math.inf, False, 12),
    (32, 10, 5.0, False, 8),
    (128, 3, 1.0, False, 4),
    (256, 1, 0.0, False, 2),
]


def _tau(B, L, seed=0):
    rng = np.random.default_rng(seed)
    tau = rng.exponential(2.0, (B, L)).astype(np.float32)
    return tau - tau.min(axis=1, keepdims=True)


def _port(tau, ctr, dcol=None, tcol=None, **kw):
    with th.eta_override(jax_eta_table()):
        return pm.pdes_multistep_counter(
            torch.as_tensor(tau), torch.as_tensor(ctr.astype(np.int64)),
            None if dcol is None else torch.as_tensor(dcol),
            None if tcol is None else torch.as_tensor(tcol), **kw)


def _jax(tau, ctr, dcol=None, tcol=None, **kw):
    return jax_counter(jnp.asarray(tau), jnp.asarray(ctr),
                       None if dcol is None else jnp.asarray(dcol),
                       None if tcol is None else
                       jnp.asarray(tcol).astype(jnp.uint32),
                       interpret=True, **kw)


def _assert_same(port, ref_out, msg=""):
    np.testing.assert_array_equal(port[0].numpy(), np.asarray(ref_out[0]),
                                  err_msg=f"{msg}tau")
    assert_moments(port[1], ref_out[1], msg)


@pytest.mark.parametrize("L,n_v,delta,rd,B", SWEEP)
def test_counter_kernel_matches_jax(L, n_v, delta, rd, B):
    tau = _tau(B, L)
    ctr = np.array([[3, 5, 0, 0]], np.uint32)
    kw = dict(k_steps=6, n_v=n_v, delta=delta, rd_mode=rd)
    _assert_same(_port(tau, ctr, **kw), _jax(tau, ctr, **kw))


@pytest.mark.parametrize("border_both", [False, True])
def test_counter_kernel_columns_match_jax(border_both):
    """Per-row Δ (finite and inf) and trial columns with wrapped negatives."""
    B, L = 8, 32
    tau = _tau(B, L, seed=1)
    ctr = np.array([[9, 0xFFFFFFFE, 0, 4]], np.uint32)   # step wraps
    dcol = np.array([0.0, 1.0, np.inf, 3.0, 8.0, np.inf, 2.0, 0.5],
                    np.float32)[:, None]
    tcol = np.array([5, 6, 7, 100, 101, -1, -2, -3], np.int64)[:, None]
    kw = dict(k_steps=5, n_v=4, delta=math.inf, border_both=border_both)
    _assert_same(_port(tau, ctr, dcol, tcol, **kw),
                 _jax(tau, ctr, dcol, tcol, **kw))


def test_counter_kernel_on_a_ring_past_one_block_matches_jax():
    """A ring that the card splits over 2 blocks of a cooperative grid
    (L = 65,600; the JAX kernel takes it as one (bb, L) block): the plain
    version the kernel is held to on the card against JAX's, with per-row
    Δ and trial columns."""
    B, L = 2, 65_600
    assert tiling.ring_plan(L).grid == 2
    tau = _tau(B, L, seed=5)
    ctr = np.array([[11, 0xFFFFFFFF, 0, 7]], np.uint32)   # step wraps
    dcol = np.array([[4.0], [np.inf]], np.float32)
    tcol = np.array([[3], [-9]], np.int64)
    kw = dict(k_steps=3, n_v=10, delta=math.inf)
    _assert_same(_port(tau, ctr, dcol, tcol, **kw),
                 _jax(tau, ctr, dcol, tcol, **kw))


def test_trial_col_equals_scalar_b0():
    B, L = 6, 40
    tau = torch.as_tensor(_tau(B, L, seed=2))
    kw = dict(k_steps=4, n_v=3, delta=2.0)
    a = pm.pdes_multistep_counter(tau, torch.tensor([[1, 2, 17, 0]]), **kw)
    b = pm.pdes_multistep_counter(tau, torch.tensor([[1, 2, 0, 0]]), None,
                                  (17 + torch.arange(B))[:, None], **kw)
    assert torch.equal(a[0], b[0])
    for k in th.MOMENT_KEYS:
        assert torch.equal(a[1][k], b[1][k]), k


def test_wrapper_shapes_and_cpu_path():
    """Moments come as six (K, B) planes; the CPU path launches nothing."""
    B, L, K = 5, 16, 3
    before = pm.launches
    tau, m = pm.pdes_multistep_counter(torch.zeros(B, L), torch.zeros(1, 4,
                                       dtype=torch.int64), k_steps=K, n_v=2,
                                       delta=1.0)
    assert pm.launches == before
    assert tau.shape == (B, L) and list(m) == list(th.MOMENT_KEYS)
    assert all(v.shape == (K, B) for v in m.values())
    np.testing.assert_array_equal(m["ucount"][0].numpy(), L)   # synchronized
    with pytest.raises(ValueError):
        pm.pdes_multistep_counter(torch.zeros(B, L), torch.zeros(1, 4),
                                  k_steps=1, n_v=1, delta=1.0)  # float ctr
    with pytest.raises(ValueError):
        pm.pdes_multistep_counter(torch.zeros(B, L, dtype=torch.float64),
                                  torch.zeros(1, 4, dtype=torch.int64),
                                  k_steps=1, n_v=1, delta=1.0)
    with pytest.raises(ValueError):
        pm.pdes_multistep_counter(torch.zeros(B, L),
                                  torch.zeros(1, 4, dtype=torch.int64),
                                  torch.zeros(B), k_steps=1, n_v=1, delta=1.0)
    with pytest.raises(ValueError):
        pm.pdes_multistep_counter(torch.zeros(B, L),
                                  torch.zeros(1, 4, dtype=torch.int64),
                                  k_steps=0, n_v=1, delta=1.0)


def test_plain_version_is_the_wrapper_on_cpu():
    B, L = 4, 24
    tau = torch.as_tensor(_tau(B, L, seed=3))
    ctr = torch.tensor([[0, 7, 2, 0]])
    kw = dict(k_steps=3, n_v=2, delta=4.0)
    a = pm.pdes_multistep_counter(tau, ctr, **kw)
    b = ref.pdes_multistep_counter_ref(tau, ctr, **kw)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in th.MOMENT_KEYS)


@pytest.mark.parametrize("rebase", [False, True])
def test_plain_stale_bounds_every_step_by_the_input_minimum(rebase):
    """``stale=True``: each of the K steps is ``horizon.step_core`` with the
    window based on the ring minimum of the input tau, bit for bit (the
    moments too), rebased or not; one step is the exact window's step;
    and the launch counts nothing on the CPU."""
    from repro_torch.core.events import as_u32, counter_words
    B, L, K = 6, 40, 6
    tau = torch.as_tensor(_tau(B, L, seed=11)) + 0.25   # min off zero
    dcol = torch.tensor([[0.0], [math.inf], [1.0], [0.5], [math.inf], [3.0]])
    tcol = torch.tensor([[3], [-1], [0], [7], [2**31], [5]])
    ctr = torch.tensor([[8, 2**32 - 2, 0, 0]])
    kw = dict(k_steps=K, n_v=3, delta=math.inf, rebase=rebase)
    before = pm.launches
    got = pm.pdes_multistep_counter(tau, ctr, dcol, tcol, stale=True, **kw)
    assert pm.launches == before
    cfg = th.PDESConfig(L=L, n_v=3)
    base = torch.amin(tau, dim=-1, keepdim=True)
    t, planes = tau, []
    for k in range(K):
        w0, w1 = counter_words(as_u32(8, "cpu"),
                               as_u32((2**32 - 2 + k) & 0xFFFFFFFF, "cpu"),
                               tcol & 0xFFFFFFFF, torch.arange(L)[None, :])
        is_l, is_r, eta = th.decode_words(w0, w1, 3, tau.dtype)
        t, upd, _ = th.step_core(t, is_l, is_r, eta, cfg,
                                 gvt_for_window=base, delta_override=dcol)
        planes.append(th.ring_moments(t, upd))
    if rebase:
        t = t - torch.amin(t, dim=-1, keepdim=True)
    assert torch.equal(got[0], t)
    for key in th.MOMENT_KEYS:
        assert torch.equal(got[1][key],
                           torch.stack([m[key] for m in planes])), key
    exact = pm.pdes_multistep_counter(tau, ctr, dcol, tcol, **kw)
    assert torch.equal(exact[1]["ucount"][0], got[1]["ucount"][0])
    assert not torch.equal(exact[1]["ucount"], got[1]["ucount"])


@pytest.mark.parametrize("case", ["inf_rows", "min_off_pe0"])
def test_plain_rebase_is_tau_less_its_last_minimum(case):
    """``rebase=True`` returns tau less its ring minimum bit for bit, with
    the moments of ``rebase=False``; that minimum is the last ``min``
    plane (what the engine takes its shift from), on rows of Δ = inf and
    on rings whose minimum has left PE 0."""
    B, L, K = 6, 96, 5
    tau = torch.as_tensor(_tau(B, L, seed=7))
    if case == "min_off_pe0":
        tau[:, 0] = 40.0                  # PE 0 stays far above the minimum
        dcol, delta = None, 3.0
    else:
        dcol = torch.tensor([[math.inf], [1.0], [math.inf], [4.0],
                             [math.inf], [0.0]])
        delta = math.inf
    args = (tau, torch.tensor([[4, 2**32 - 2, 9, 0]]), dcol)
    kw = dict(k_steps=K, n_v=3, delta=delta)
    before = pm.rebased_launches
    t0, m0 = pm.pdes_multistep_counter(*args, **kw)
    t1, m1 = pm.pdes_multistep_counter(*args, rebase=True, **kw)
    assert pm.rebased_launches == before     # the CPU launches nothing
    p1 = ref.pdes_multistep_counter_ref(*args, rebase=True, **kw)
    assert torch.equal(t1, p1[0])
    shift = torch.amin(t0, dim=-1)
    assert torch.equal(m0["min"][-1], shift)
    assert torch.equal(t1, t0 - shift[:, None])
    assert torch.equal(t1.amin(dim=-1), torch.zeros(B))
    for k in th.MOMENT_KEYS:
        assert torch.equal(m1[k], m0[k]), k
        assert torch.equal(p1[1][k], m0[k]), k
    if case == "min_off_pe0":
        assert bool((t0.argmin(dim=-1) != 0).all())


def test_tiling_rules():
    for B in (1, 7, 12, 448):
        for bb in (1, 2, 8, 64):
            assert tiling.pick_divisor_block(B, bb) == \
                jtiling.pick_divisor_block(B, bb)
    assert tiling.ring_smem_bytes(tiling.MAX_RING_L) + tiling.SMEM_STATIC \
        <= tiling.SMEM_PER_BLOCK
    tiling.check_ring_fits(10_000)
    tiling.check_ring_fits(tiling.MAX_RING_L + 1)
    tiling.check_ring_fits(16 * tiling.MAX_RING_SEG)
    tiling.check_ring_fits(16 * tiling.MAX_RING_SEG + 1)
    tiling.check_ring_fits(1 << 20)
    tiling.check_ring_fits(tiling.MAX_GRID_RING_L)
    tiling.check_ring_fits(tiling.MAX_GRID_RING_L + 1)      # B1's stream tier
    tiling.check_ring_fits(tiling.MAX_STREAM_RING_L)
    with pytest.raises(ValueError, match="shared memory"):
        tiling.check_ring_fits(tiling.MAX_STREAM_RING_L + 1)
    with pytest.raises(ValueError, match="shared memory"):   # B3's cap
        tiling.check_ring_fits(tiling.MAX_GRID_RING_L + 1, stream=False)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No silent fallback: a missing compiler is an error, not the CPU."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("pdes_multistep_counter")
    path = _build.library_path("pdes_multistep_counter")
    assert path.parent == tmp_path / "build"
    assert path.name.startswith("libpdes_multistep_counter-")
    assert path == _build.library_path("pdes_multistep_counter")


def test_decode_check_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        pm.decode_eta_cuda(torch.arange(4))
