"""The port's CUDA kernels on the GPU, against their plain PyTorch versions,
and the port's model, serving and training paths on the card against the
CPU.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one.  On a machine with a card (Hopper, ``sm_90a``)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.core import ensemble, horizon, prng
from repro_torch.core.engine import PDESEngine
from repro_torch.core.horizon import PDESConfig
from repro_torch.core.events import counter_bits_block
from repro_torch.kernels import _build, ops, ref, threefry, tiling
from repro_torch.kernels import pdes_multistep as pm
from repro_torch.kernels import pdes_step as ps

from torch_parity import explicit_rebase_run

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _inputs(dev, B, L, seed=0):
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(rng.exponential(3.0, (B, L)).astype(np.float32),
                          device=dev)
    dcol = torch.as_tensor(
        np.array([0.0, 2.0, np.inf, 8.0], np.float32)[np.arange(B) % 4],
        device=dev)[:, None]
    tcol = torch.arange(B, device=dev)[:, None] - B // 2   # negatives wrap
    return tau, dcol, tcol


@pytest.mark.parametrize("n_v,rd_mode,border_both,cols", [
    (1, False, False, True), (10, False, False, True),
    (10, True, False, True), (3, False, True, True), (2, False, False, False)])
@pytest.mark.parametrize("B,L", [(16, 1000), (3, 37),
                                 (2, tiling.MAX_RING_L), (2, 131_072),
                                 (1, 16 * tiling.MAX_RING_SEG),
                                 (8, 1 << 20), (1, tiling.MAX_GRID_RING_L),
                                 (1, tiling.MAX_GRID_RING_L + 32),
                                 (1, 1 << 23), (2, 1 << 23)])
def test_kernel_matches_plain_version(dev, n_v, rd_mode, border_both, cols,
                                      B, L):
    tau, dcol, tcol = _inputs(dev, B, L)
    args = (tau, torch.tensor([[5, 0xFFFFFFFD, 11, 3]]),
            dcol if cols else None, tcol if cols else None)
    kw = dict(k_steps=7, n_v=n_v, delta=math.inf if cols else 4.0,
              rd_mode=rd_mode, border_both=border_both)
    before = pm.launches
    t_k, m_k = pm.pdes_multistep_counter(*args, **kw)
    assert pm.launches == before + 1
    t_p, m_p = ref.pdes_multistep_counter_ref(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(t_k, t_p)
    for key in horizon.MOMENT_KEYS:
        if key in ("ucount", "min", "max"):
            assert torch.equal(m_k[key], m_p[key]), key
        else:
            torch.testing.assert_close(m_k[key], m_p[key], rtol=1e-5,
                                       atol=1e-2, msg=key)


def test_decode_matches_plain_rule_on_all_inputs(dev):
    w1 = torch.arange(1 << 24, device=dev, dtype=torch.int64) << 8
    assert torch.equal(pm.decode_eta_cuda(w1), horizon.decode_eta(w1))


def test_library_decode_matches_plain_rule_on_all_inputs(dev):
    """The fp64 library log of the decode check gives the table's floats."""
    w1 = torch.arange(1 << 24, device=dev, dtype=torch.int64) << 8
    assert torch.equal(pm.decode_eta_cuda(w1, table=False),
                       horizon.decode_eta(w1))


#: The ring lengths at the new loop's edges: one PE, a partial row, one
#: warp's row, a row and one PE, the paper's L, the service's L, the longest
#: one-block ring; then the shortest ring over the grid (2 blocks, the last
#: segment shorter), 2 blocks of whole rows, and the longest ring of 2
#: blocks and the shortest of 3.
EDGE_LS = (1, 31, 32, 33, 1000, 10_000, tiling.MAX_RING_L,
           tiling.MAX_RING_L + 1, 65_536, 2 * tiling.MAX_RING_SEG,
           2 * tiling.MAX_RING_SEG + 1)
#: n_v values over every shape of the site pick's multiply-high constants.
EDGE_N_VS = (1, 2, 3, 10, 1000, 2**31 + 1, 2**32 - 1)


@pytest.mark.parametrize("n_v", EDGE_N_VS)
@pytest.mark.parametrize("L", EDGE_LS)
def test_ring_kernels_at_the_loops_edges(dev, L, n_v):
    """B1 and B3 against their plain versions where rows are partial, a
    ring is one warp, and PE L-1 wraps to PE 0 across a warp's edge."""
    B, K = 3, 5
    tau, dcol, tcol = _inputs(dev, B, L, seed=L % 97)
    args = (tau, torch.tensor([[9, 2**32 - 3, 0, 5]]), dcol, tcol)
    kw = dict(k_steps=K, n_v=n_v, delta=math.inf)
    _assert_step_equal(pm.pdes_multistep_counter(*args, **kw),
                       ref.pdes_multistep_counter_ref(*args, **kw))
    bits = threefry.threefry_bits(prng.key(L, dev), 17, K, (B, L))
    kw = dict(n_v=n_v, delta=4.0)
    _assert_step_equal(pm.pdes_multistep(tau, bits, **kw),
                       ref.pdes_multistep_ref(tau, bits, **kw))


def _assert_same_ring(got, want, row):
    assert torch.equal(got[0][0], want[0][row])
    for key in horizon.MOMENT_KEYS:
        assert torch.equal(got[1][key][:, 0], want[1][key][:, row]), key


@pytest.mark.parametrize("L", (1000, 10_000, 131_072))
def test_ring_result_does_not_depend_on_its_batch(dev, L):
    """A ring's tau and all six moments, bit for bit, whatever batch it runs
    in and at whatever row: what lets a coalesced service pass answer each
    requester as a direct run would."""
    K = 7
    tau, _, _ = _inputs(dev, 448, L, seed=4)
    dcol = torch.full((448, 1), 16.0, device=dev)
    tcol = torch.arange(448, device=dev)[:, None] * 7 - 100
    bits = threefry.threefry_bits(prng.key(8, dev), 3, K, (448, L))
    ctr = torch.tensor([[3, 11, 0, 0]])
    kw1 = dict(k_steps=K, n_v=10, delta=math.inf)
    kw3 = dict(n_v=10, delta=16.0)
    full1 = pm.pdes_multistep_counter(tau, ctr, dcol, tcol, **kw1)
    full3 = pm.pdes_multistep(tau, bits, **kw3)
    for r in (0, 6, 447):
        rows = slice(r, r + 1)
        _assert_same_ring(pm.pdes_multistep_counter(
            tau[rows], ctr, dcol[rows], tcol[rows], **kw1), full1, r)
        _assert_same_ring(pm.pdes_multistep(
            tau[rows], bits[:, rows].contiguous(), **kw3), full3, r)
    seven = slice(440, 447)                  # ring 446 as row 6 of 7
    got1 = pm.pdes_multistep_counter(tau[seven], ctr, dcol[seven],
                                     tcol[seven], **kw1)
    got3 = pm.pdes_multistep(tau[seven], bits[:, seven].contiguous(), **kw3)
    for r in range(7):
        _assert_same_ring((got1[0][r:r + 1],
                           {k: v[:, r:r + 1] for k, v in got1[1].items()}),
                          full1, 440 + r)
        _assert_same_ring((got3[0][r:r + 1],
                           {k: v[:, r:r + 1] for k, v in got3[1].items()}),
                          full3, 440 + r)


@pytest.mark.parametrize("n_v", EDGE_N_VS)
def test_site_pick_matches_mod_on_the_gpu(dev, n_v):
    gen = torch.Generator(device=dev).manual_seed(n_v % 1000)
    edges = [0, 1, n_v - 1, n_v, n_v + 1, 2**32 - 1,
             (2**32 - 1) // n_v * n_v, (2**32 - 1) // n_v * n_v - 1]
    words = torch.cat([
        torch.tensor([e for e in edges if 0 <= e < 2**32], device=dev),
        torch.randint(0, 2**32, (1 << 20,), generator=gen, device=dev)])
    assert torch.equal(pm.site_pick_cuda(words, n_v), words % n_v)


def test_kernel_refuses_eta_override_and_long_rings(dev):
    tau = torch.zeros(2, 8, device=dev)
    ctr = torch.zeros(1, 4, dtype=torch.int64)
    table = np.zeros(1 << 24, np.float32)
    with horizon.eta_override(table):
        with pytest.raises(RuntimeError, match="eta_override"):
            pm.pdes_multistep_counter(tau, ctr, k_steps=1, n_v=1, delta=1.0)
    too_long = torch.zeros(1, 1, device=dev).expand(
        1, tiling.MAX_STREAM_RING_L + 1)      # a view: no 8 GiB of zeros
    with pytest.raises(ValueError, match="shared memory"):
        pm.pdes_multistep_counter(too_long, ctr, k_steps=1, n_v=1, delta=1.0)


def test_engine_backends_agree_on_the_gpu(dev):
    cfg = PDESConfig(L=512, n_v=4)
    deltas = torch.tensor([1.0, 4.0, math.inf, 16.0] * 2, device=dev)
    trials = torch.arange(8, device=dev) - 3
    outs = []
    for backend in ("reference", "pallas_multistep"):
        eng = PDESEngine(cfg, backend=backend, k_fuse=16)
        outs.append(eng.run(eng.init(8), 3, 37, deltas=deltas,
                            trial_base=trials))
    (sa, a), (sb, b) = outs
    assert torch.equal(sa.tau, sb.tau) and torch.equal(sa.offset, sb.offset)
    assert torch.equal(a.utilization, b.utilization)
    assert torch.equal(a.gvt, b.gvt)


def _step_inputs(dev, B, Lc, seed=0):
    rng = np.random.default_rng(seed)
    tau = torch.as_tensor(rng.exponential(3.0, (B, Lc)).astype(np.float32),
                          device=dev)
    bits = counter_bits_block(7, 3, torch.arange(B, device=dev) - B // 2, 0,
                              B, Lc)
    return ops.ring_halo(tau), bits, torch.amin(tau, dim=-1, keepdim=True)


def _assert_step_equal(got, want):
    assert torch.equal(got[0], want[0])
    for key in horizon.MOMENT_KEYS:
        if key in ("ucount", "min", "max"):
            assert torch.equal(got[1][key], want[1][key]), key
        else:
            torch.testing.assert_close(got[1][key], want[1][key], rtol=1e-5,
                                       atol=1e-2, msg=key)


@pytest.mark.parametrize("n_v,rd_mode,border_both,base", [
    (1, False, False, "exact"), (10, False, False, "exact"),
    (10, True, False, "stale"), (3, False, True, "stale"),
    (10, False, False, "folded")])
@pytest.mark.parametrize("B,Lc", [(16, 1000), (3, 37),
                                  (2, tiling.MAX_RING_L + 1000),
                                  (32, 65_536), (32, 16), (7, 9_999),
                                  (3, 70_001)])
def test_step_kernel_matches_plain_version(dev, n_v, rd_mode, border_both,
                                           base, B, Lc):
    """Rows longer than B1's shared-memory limit run too; at every shape
    of B2's plan: a --pdes-core shard's 8-block clusters, the commavoid
    edge strip's shared blocks, odd rows (every other one 8 bytes off a
    16-byte boundary) over a 2-block cluster, and segments walked tile
    by tile past 2^16 PEs."""
    tau_h, bits, gvt = _step_inputs(dev, B, Lc)
    delta = 4.0
    if base == "stale":
        gvt = gvt - 2.0
    elif base == "folded":
        dcol = torch.tensor([0.0, 2.0, math.inf, 8.0],
                            device=dev)[torch.arange(B, device=dev) % 4]
        gvt, delta = gvt + dcol[:, None], 0.0
    kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode, border_both=border_both)
    before = ps.launches
    got = ps.pdes_step(tau_h, bits, gvt, **kw)
    assert ps.launches == before + 1
    t_p, _, m_p = ref.pdes_step_ref(tau_h, bits, gvt, **kw)
    torch.cuda.synchronize()
    _assert_step_equal(got, (t_p, m_p))


@pytest.mark.parametrize("Lc", [16, 37, 10_000, 65_536, 70_001])
def test_step_result_does_not_depend_on_its_batch(dev, Lc):
    """The first 32 rows of a 448-row launch give the same six moments, bit
    for bit, as the same rows launched alone at B = 32 and each at B = 1
    (a coalesced pass against a direct run); τ′ too."""
    B = 448 if Lc <= 10_000 else 64
    tau_h, bits, gvt = _step_inputs(dev, B, Lc, seed=3)
    kw = dict(n_v=10, delta=4.0)
    t_all, m_all = ps.pdes_step(tau_h, bits, gvt, **kw)
    t_32, m_32 = ps.pdes_step(tau_h[:32], bits[:32], gvt[:32], **kw)
    assert torch.equal(t_all[:32], t_32)
    for key in horizon.MOMENT_KEYS:
        assert torch.equal(m_all[key][:32], m_32[key]), key
    for r in range(32):
        t_1, m_1 = ps.pdes_step(tau_h[r:r + 1], bits[r:r + 1],
                                gvt[r:r + 1], **kw)
        assert torch.equal(t_all[r:r + 1], t_1)
        for key in horizon.MOMENT_KEYS:
            assert torch.equal(m_all[key][r:r + 1], m_1[key]), (r, key)


def test_step_kernel_refused_cluster_raises(dev, monkeypatch):
    """A cluster the card does not place (16 blocks without the
    non-portable attribute) raises; nothing falls back."""
    Lc = 65_536
    p = tiling.step_plan(Lc)
    seg = 2 * -(-Lc // 32)
    wide = dataclasses.replace(
        p, cluster=16, seg=seg, tile=seg, keep=True,
        smem=4 * tiling.step_group_floats(seg, True))
    monkeypatch.setattr(ps, "step_plan", lambda L: wide)
    tau_h, bits, gvt = _step_inputs(dev, 2, Lc)
    before = ps.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        ps.pdes_step(tau_h, bits, gvt, n_v=10, delta=4.0)
    assert ps.launches == before
    monkeypatch.undo()
    got = ps.pdes_step(tau_h, bits, gvt, n_v=10, delta=4.0)
    t_p, _, m_p = ref.pdes_step_ref(tau_h, bits, gvt, n_v=10, delta=4.0)
    _assert_step_equal(got, (t_p, m_p))


def test_step_kernel_refuses_eta_override(dev):
    tau_h, bits, gvt = _step_inputs(dev, 2, 8)
    with horizon.eta_override(np.zeros(1 << 24, np.float32)):
        with pytest.raises(RuntimeError, match="eta_override"):
            ps.pdes_step(tau_h, bits, gvt, n_v=1, delta=1.0)


@pytest.mark.parametrize("window,other", [("exact", "pallas_multistep"),
                                          ("exact", "reference"),
                                          ("stale", "reference")])
def test_pallas_backend_agrees_on_the_gpu(dev, window, other):
    cfg = PDESConfig(L=512, n_v=4)
    deltas = torch.tensor([1.0, 4.0, math.inf, 16.0] * 2, device=dev)
    trials = torch.arange(8, device=dev) - 3
    outs = []
    before = ps.launches
    for backend in ("pallas", other):
        eng = PDESEngine(cfg, backend=backend, window=window, k_fuse=16)
        outs.append(eng.run(eng.init(8), 3, 37, deltas=deltas,
                            trial_base=trials))
    assert ps.launches == before + 37
    (sa, a), (sb, b) = outs
    assert torch.equal(sa.tau, sb.tau) and torch.equal(sa.offset, sb.offset)
    assert torch.equal(a.utilization, b.utilization)
    assert torch.equal(a.gvt, b.gvt)


#: JAX's own words: (step, b, l, word 0, word 1) of
#: ``repro.core.horizon.event_bits(jax.random.key(7), step, (448, 10000))``
#: (made on the CPU with jax 0.9.0; the same table is in chip_smoke.py).
JAX_WORDS = [
    (3, 0, 0, 0x3B38B794, 0x5108BA83),
    (3, 0, 1, 0xCAA8A765, 0x88E2AE98),
    (3, 223, 5000, 0x96A28762, 0xB9F3F838),
    (3, 447, 9998, 0x8DC79F7C, 0x166EC9EF),
    (3, 447, 9999, 0x60421E03, 0xCA883E06),
    (2147483647, 0, 0, 0x7BF73FCE, 0x9784C588),
    (2147483647, 223, 5000, 0x702F800B, 0xABF74FAC),
    (2147483647, 447, 9999, 0x82F29DDC, 0xB97A3D6B),
]


@pytest.mark.parametrize("B,L,K,step0", [(16, 1000, 4, 2**31 - 2),
                                         (3, 37, 5, 0), (1, 1, 1, 7)])
def test_generator_matches_plain_version(dev, B, L, K, step0):
    key = prng.key(-3, dev)
    before = threefry.launches
    got = threefry.threefry_bits(key, step0, K, (B, L))
    assert threefry.launches == before + 1
    want = threefry.threefry_bits_plain(key, step0, K, (B, L))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_generator_matches_jax_words(dev):
    key = prng.key(7, dev)
    for step in sorted({w[0] for w in JAX_WORDS}):
        words = threefry.threefry_bits(key, step, 1, (448, 10000))[0]
        words = words.to(torch.int64).cpu() & 0xFFFFFFFF
        for s, b, l, w0, w1 in JAX_WORDS:
            if s == step:
                assert (int(words[b, l, 0]), int(words[b, l, 1])) == \
                    (w0, w1), (s, b, l)


def test_event_bits_on_the_gpu_equal_the_cpu(dev):
    before = threefry.launches
    got = horizon.event_bits(prng.key(11, dev), 2**31 - 1, (5, 33))
    assert threefry.launches == before + 1
    want = horizon.event_bits(prng.key(11), 2**31 - 1, (5, 33))
    assert got.dtype == torch.int64 and torch.equal(got.cpu(), want)


@pytest.mark.parametrize("n_v,rd_mode,border_both,delta", [
    (1, False, False, 16.0), (10, False, False, 16.0),
    (10, False, False, math.inf), (10, True, False, 4.0),
    (3, False, True, 2.0)])
@pytest.mark.parametrize("B,L,K", [(16, 1000, 6), (3, 37, 5),
                                   (2, tiling.MAX_RING_L, 3),
                                   (2, 131_072, 3), (2, 1 << 20, 3)])
def test_bits_kernel_matches_plain_version(dev, n_v, rd_mode, border_both,
                                           delta, B, L, K):
    tau, _, _ = _inputs(dev, B, L)
    bits = threefry.threefry_bits(prng.key(5, dev), 2**32 - 2, K, (B, L))
    kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode, border_both=border_both)
    before = pm.bits_launches
    got = pm.pdes_multistep(tau, bits, **kw)
    assert pm.bits_launches == before + 1
    want = ref.pdes_multistep_ref(tau, bits, **kw)
    torch.cuda.synchronize()
    _assert_step_equal(got, want)


def test_bits_kernel_refuses_eta_override_and_long_rings(dev):
    tau = torch.zeros(2, 8, device=dev)
    bits = torch.zeros(1, 2, 8, 2, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="int32"):     # no int64 carrier
        pm.pdes_multistep(tau, bits.to(torch.int64), n_v=1, delta=1.0)
    with horizon.eta_override(np.zeros(1 << 24, np.float32)):
        with pytest.raises(RuntimeError, match="eta_override"):
            pm.pdes_multistep(tau, bits, n_v=1, delta=1.0)
        with pytest.raises(RuntimeError, match="eta_override"):
            ops.simulate(horizon.init_state(PDESConfig(L=8), 2, dev),
                         prng.key(0, dev), PDESConfig(L=8), 4)
    L = tiling.MAX_GRID_RING_L + 1
    with pytest.raises(ValueError, match="shared memory"):
        pm.pdes_multistep(torch.zeros(1, L, device=dev),
                          torch.zeros(1, 1, L, 2, dtype=torch.int32,
                                      device=dev), n_v=1, delta=1.0)


def test_bits_kernel_launch_failure_raises(dev, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version."""
    monkeypatch.setattr(pm, "check_ring_fits", lambda L, **kw: None)
    L = tiling.MAX_GRID_RING_L + 1_000_000   # a segment past a block's
    assert tiling.ring_plan(L, stream=False).dynamic_smem > \
        tiling.SMEM_PER_BLOCK
    before = pm.bits_launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pm.pdes_multistep(torch.zeros(1, L, device=dev),
                          torch.zeros(1, 1, L, 2, dtype=torch.int32,
                                      device=dev), n_v=1, delta=1.0)
    assert pm.bits_launches == before


def test_grid_ring_result_does_not_depend_on_its_wave(dev):
    """A ring over a cooperative grid gives the same tau and moments, bit
    for bit, in the second wave of a batch of 8 (6 rings of 22 blocks at
    once on 132 SMs), alone in a wave of 6 and as a batch of 1."""
    L, K = 1 << 20, 5
    assert pm.resident_rings(L) == pm.resident_rings(L, bits=True) >= 1
    tau, dcol, tcol = _inputs(dev, 8, L, seed=20)
    ctr = torch.tensor([[3, 2**32 - 2, 0, 0]])
    kw1 = dict(k_steps=K, n_v=100, delta=math.inf)
    bits = threefry.threefry_bits(prng.key(20, dev), 0, K, (8, L))
    kw3 = dict(n_v=100, delta=100.0)
    full1 = pm.pdes_multistep_counter(tau, ctr, dcol, tcol, **kw1)
    full3 = pm.pdes_multistep(tau, bits, **kw3)
    for rows in (slice(0, 6), slice(2, 8), slice(7, 8), slice(0, 1)):
        got1 = pm.pdes_multistep_counter(tau[rows], ctr, dcol[rows],
                                         tcol[rows], **kw1)
        got3 = pm.pdes_multistep(tau[rows], bits[:, rows].contiguous(),
                                 **kw3)
        for r in range(rows.stop - rows.start):
            for got, full in ((got1, full1), (got3, full3)):
                _assert_same_ring(
                    (got[0][r:r + 1],
                     {k: v[:, r:r + 1] for k, v in got[1].items()}),
                    full, rows.start + r)


#: One ring length for each block count from 2 to 16: n full segments, at
#: n = 10 the cell exact_mix.ring512k's 2^19.
SPLIT_LS = tuple(524_288 if n == 10 else n * tiling.MAX_RING_SEG
                 for n in range(2, 17))


@pytest.mark.parametrize("L", SPLIT_LS)
def test_split_rings_match_plain_over_two_waves(dev, L):
    """A ring of 2 to 16 blocks at the least runs over the cooperative
    grid, in the most blocks that keep as many rings at once (16 for 15):
    B1 and B3 against their plain versions over two waves (one ring more
    than the card holds at once)."""
    n = tiling.ring_blocks(L)
    assert tiling.ring_plan(L).tier == "grid" and tiling.ring_plan(L).grid \
        == 132 // (132 // n) == tiling.ring_plan(L, stream=False).grid
    B = 1 + max(pm.rings_at_once(L), pm.rings_at_once(L, bits=True))
    K = 3
    tau, dcol, tcol = _inputs(dev, B, L, seed=n)
    args = (tau, torch.tensor([[5, 2**32 - 2, 0, 0]]), dcol, tcol)
    kw1 = dict(k_steps=K, n_v=100, delta=math.inf)
    bits = threefry.threefry_bits(prng.key(n, dev), 0, K, (B, L))
    kw3 = dict(n_v=100, delta=100.0)
    _assert_step_equal(pm.pdes_multistep_counter(*args, **kw1),
                       ref.pdes_multistep_counter_ref(*args, **kw1))
    _assert_step_equal(pm.pdes_multistep(tau, bits, **kw3),
                       ref.pdes_multistep_ref(tau, bits, **kw3))


@pytest.mark.parametrize("rebase", [False, True])
@pytest.mark.parametrize("stale", [False, True])
def test_filled_grid_plan_matches_plain_and_the_least_plan(dev, stale,
                                                           rebase,
                                                           monkeypatch):
    """B1 at 28 x 2^20 on the plan that fills the card (22 blocks a ring, 6
    rings at once on 132 SMs) against its plain version, and against a
    launch of the least count's plan (19 blocks, 6 at once) through
    ``counter_launch``: τ, ``ucount``, ``min`` and ``max`` bit for bit, the
    sums, folded from 19 partials instead of 22, to rounding."""
    L, B, K = 1 << 20, 28, 16
    p = tiling.ring_plan(L)
    assert (tiling.ring_blocks(L), p.grid, p.seg) == (19, 22, 47_680)
    assert pm.resident_rings(L) == 6
    tau, dcol, tcol = _inputs(dev, B, L, seed=35)
    ctr = (8, 2**32 - 4, 0, 0)
    args = (tau, torch.tensor([ctr]), dcol, tcol)
    kw = dict(k_steps=K, n_v=100, delta=math.inf, rebase=rebase, stale=stale)
    got = pm.pdes_multistep_counter(*args, **kw)
    _assert_step_equal(got, ref.pdes_multistep_counter_ref(*args, **kw))
    seg = tiling._ring_seg(L, 19)
    least = tiling.RingPlan(19, seg, tiling.RING_SPLIT_WARPS, 4 * seg,
                            tiling.SMEM_STATIC_SPLIT)
    monkeypatch.setattr(pm, "ring_plan", lambda L, stream=True: least)
    assert pm.resident_rings(L) == 6
    out = torch.empty_like(tau)
    stats = torch.empty((6, K, B), device=dev)
    pm.counter_launch(tau, out, stats, dcol.contiguous(),
                      _build.u32_bits(tcol).contiguous(), ctr, n_v=100,
                      delta=math.inf, rd_mode=False, border_both=False,
                      rebase=rebase, stale=stale)
    _assert_step_equal(got, (out, dict(zip(horizon.MOMENT_KEYS,
                                           stats.unbind(0)))))


def test_filled_grid_plan_b3_matches_plain(dev):
    """B3 takes B1's plan at 2^20 (22 blocks a ring) and matches its plain
    version at 2 x 2^20."""
    L, K = 1 << 20, 16
    assert tiling.ring_plan(L, stream=False) == tiling.ring_plan(L)
    assert pm.launch_plan(2, L, bits=True)["ring_grid"] == 22
    assert pm.resident_rings(L, bits=True) == 6
    tau, _, _ = _inputs(dev, 2, L, seed=36)
    bits = threefry.threefry_bits(prng.key(36, dev), 2**32 - 7, K, (2, L))
    kw = dict(n_v=100, delta=100.0)
    _assert_step_equal(pm.pdes_multistep(tau, bits, **kw),
                       ref.pdes_multistep_ref(tau, bits, **kw))


def test_service_at_2_19_answers_as_a_direct_sweep(dev):
    """The sweep service at L = 2^19 (10 blocks a ring over the
    cooperative grid) answers bit for bit as a direct run of its spec, and
    its pass span counts the launches' blocks and the card's SM-steps
    they held: 3 launches of K = 16 on 4 rings of 10 blocks, one wave of
    the rings the card holds at once."""
    import json
    from repro_torch import obs as tobs
    from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
    from repro_torch.service.api import SweepService
    L = 1 << 19
    spec = WindowSweep(Ls=(L,), n_vs=(100,), deltas=(100.0, math.inf),
                       replicas=2, n_steps=32, burn_in=16,
                       backend="pallas_multistep", k_fuse=16, seed=5)
    svc = SweepService(device=dev)
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    svc.attach_telemetry(tel)
    svc.submit(spec, requester="a")
    before = pm.launches
    (resp,) = svc.drain()
    assert resp.error is None
    (args,) = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    assert args["b1_tier"] == "grid"
    assert args["b1_rebased_launches"] == pm.launches - before == 3
    assert 4 <= pm.rings_at_once(L)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    assert (args["b1_block_chunks"], args["b1_sm_chunks"]) == (
        3 * 16 * 4 * 10, 3 * 16 * 1 * sms)
    assert json.dumps(resp.result.as_dict()) == \
        json.dumps(run_window_sweep(spec, device=dev).as_dict())


def test_grid_launch_the_card_cannot_place_raises(dev, monkeypatch):
    """A ring of more blocks than the card holds at once: the cooperative
    launch is refused with a CUDA error, raised, and counted as no launch;
    nothing hangs and nothing falls back."""
    seg, g = 50_016, 140          # 196 KB a block: one an SM
    L = (g - 1) * seg + 40_000
    plan = tiling.RingPlan(g, seg, tiling.RING_SPLIT_WARPS, 4 * seg,
                           tiling.SMEM_STATIC_SPLIT)
    monkeypatch.setattr(pm, "ring_plan", lambda L, **kw: plan)
    monkeypatch.setattr(pm, "check_ring_fits", lambda L, **kw: None)
    assert pm.resident_rings(L) == 0
    tau = torch.zeros(1, L, device=dev)
    b1, b3 = pm.launches, pm.bits_launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pm.pdes_multistep_counter(tau, torch.zeros(1, 4, dtype=torch.int64),
                                  k_steps=1, n_v=1, delta=1.0)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pm.pdes_multistep(tau, torch.zeros(1, 1, L, 2, dtype=torch.int32,
                                           device=dev), n_v=1, delta=1.0)
    torch.cuda.synchronize()
    assert (pm.launches, pm.bits_launches) == (b1, b3)


def test_stream_ring_result_does_not_depend_on_its_batch_or_wave(dev):
    """A ring of the stream tier (2^23 PEs: 132 blocks, 6,592 PEs of each
    segment in device memory, one ring on the card at a time) gives the
    same tau and moments, bit for bit, as the third wave of a batch of 3,
    as the first, and alone; and each equals the plain version's."""
    L, K = 1 << 23, 5
    assert tiling.ring_plan(L).tier == "stream"
    assert pm.resident_rings(L) >= 1
    tau, dcol, tcol = _inputs(dev, 3, L, seed=23)
    ctr = torch.tensor([[7, 2**32 - 3, 0, 0]])
    kw = dict(k_steps=K, n_v=100, delta=math.inf)
    full = pm.pdes_multistep_counter(tau, ctr, dcol, tcol, **kw)
    _assert_step_equal(full, ref.pdes_multistep_counter_ref(
        tau, ctr, dcol, tcol, **kw))
    for rows in (slice(2, 3), slice(0, 1), slice(1, 3)):
        got = pm.pdes_multistep_counter(tau[rows], ctr, dcol[rows],
                                        tcol[rows], **kw)
        for r in range(rows.stop - rows.start):
            _assert_same_ring(
                (got[0][r:r + 1],
                 {k: v[:, r:r + 1] for k, v in got[1].items()}),
                full, rows.start + r)


def test_service_takes_an_exact_request_past_shared_memory(dev, monkeypatch):
    """The sweep service answers an exact request at L = 2^23 through B1's
    stream tier: as a direct run does, bit for bit; with the exact fields
    of a run whose chunks take B1's plain version; and its pass spans
    name the tier and count the launches' bytes in device memory from
    the plan."""
    import json
    from repro_torch import obs as tobs
    from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
    from repro_torch.service.api import SweepService
    L = 1 << 23
    spec = WindowSweep(Ls=(L,), n_vs=(100,), deltas=(100.0, math.inf),
                       replicas=2, n_steps=32, burn_in=16,
                       backend="pallas_multistep", k_fuse=16, seed=3)
    svc = SweepService(device=dev, state_cache_rows=8)
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    svc.attach_telemetry(tel)
    svc.submit(spec, requester="a")
    before = pm.launches
    (resp,) = svc.drain()
    assert resp.error is None and pm.launches == before + 3
    direct = run_window_sweep(spec, device=dev).as_dict()
    assert json.dumps(resp.result.as_dict()) == json.dumps(direct)
    (args,) = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    assert args["b1_tier"] == "stream"
    assert args["b1_offchip_bytes"] == 3 * pm.offchip_bytes_of(4, L, 16)
    assert args["b1_rebased_launches"] == 3
    with monkeypatch.context() as mp:
        mp.setattr(pm, "pdes_multistep_counter",
                   ref.pdes_multistep_counter_ref)
        plain = run_window_sweep(spec, device=dev).as_dict()
    for got, want in zip(direct["records"], plain["records"]):
        for f in ("u", "u_err", "rate", "rate_err"):
            assert got[f] == want[f], f


#: (B, L) of each of B1's tiers: one block; a cooperative grid of 2 and of
#: 22 blocks a ring; the stream tier's shortest ring.
REBASE_SHAPES = ((448, 10_000), (2, 65_600), (8, 1 << 20),
                 (1, tiling.MAX_GRID_RING_L + 32))


@pytest.mark.parametrize("B,L", REBASE_SHAPES)
def test_rebased_store_is_the_plain_store_less_the_last_min(dev, B, L):
    """B1 with ``rebase`` writes, bit for bit, its unrebased tau less the
    last ``min`` plane, which equals the ring minimum of that tau; the
    moments do not move; the launch is counted as rebased."""
    tau, dcol, tcol = _inputs(dev, B, L, seed=33)
    args = (tau, torch.tensor([[9, 2**32 - 3, 0, 0]]), dcol, tcol)
    kw = dict(k_steps=16, n_v=10 if L == 10_000 else 100, delta=math.inf)
    launches, rebased = pm.launches, pm.rebased_launches
    t0, m0 = pm.pdes_multistep_counter(*args, **kw)
    assert pm.rebased_launches == rebased
    t1, m1 = pm.pdes_multistep_counter(*args, rebase=True, **kw)
    assert (pm.launches, pm.rebased_launches) == (launches + 2, rebased + 1)
    torch.cuda.synchronize()
    shift = m0["min"][-1]
    assert torch.equal(shift, torch.amin(t0, dim=-1))
    assert torch.equal(t1, t0 - shift[:, None])
    for key in horizon.MOMENT_KEYS:
        assert torch.equal(m1[key], m0[key]), key


@pytest.mark.parametrize("B,L,n_steps", [(64, 10_000, 37), (2, 1 << 20, 21),
                                         (1, tiling.MAX_GRID_RING_L + 32,
                                          20)])
def test_fused_rebase_equals_the_explicit_loop_on_the_gpu(dev, B, L,
                                                         n_steps):
    """The engine's fused path (B1 rebasing in its store) against the chunk
    loop's own amin and subtraction after an unrebased B1: τ, offset,
    compensation and every StepStats field bit for bit, from a burned
    state, over a remainder chunk, on each tier."""
    cfg = PDESConfig(L=L, n_v=100, delta=100.0)
    eng = PDESEngine(cfg, backend="pallas_multistep", k_fuse=16, device=dev)
    deltas = torch.tensor([100.0, math.inf, 10.0, 300.0],
                          device=dev).repeat(16)[:B]
    trials = torch.arange(B, device=dev) - 1
    st = eng.burn_in(eng.init(B), 4, 16, deltas=deltas, trial_base=trials)
    sa, a = eng.run(st, 4, n_steps, deltas=deltas, trial_base=trials)
    sb, b = explicit_rebase_run(eng, st, 4, n_steps, deltas=deltas,
                                trial_base=trials)
    for f in ("tau", "offset", "offset_comp"):
        assert torch.equal(getattr(sa, f), getattr(sb, f)), f
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


#: (B, L) of each of B1's tiers in the stale window: one block, the grid
#: at the production ring (22 blocks, 6 rings at once: two waves), the
#: stream tier's shortest ring.
STALE_SHAPES = ((64, 10_000), (8, 1 << 20), (1, tiling.MAX_GRID_RING_L + 32))


@pytest.mark.parametrize("rebase", [False, True])
@pytest.mark.parametrize("B,L", STALE_SHAPES)
def test_stale_kernel_matches_plain_version(dev, B, L, rebase):
    """B1's stale kernel of each tier against its plain version: τ, rebased
    or not, and ``ucount``, ``min``, ``max`` bit for bit, the sums to
    rounding; the launch is counted; and it is not the exact window."""
    tau, dcol, tcol = _inputs(dev, B, L, seed=34)
    args = (tau, torch.tensor([[6, 2**32 - 5, 0, 0]]), dcol, tcol)
    kw = dict(k_steps=16, n_v=10 if L == 10_000 else 100, delta=math.inf,
              rebase=rebase)
    launches = pm.launches
    got = pm.pdes_multistep_counter(*args, stale=True, **kw)
    assert pm.launches == launches + 1
    _assert_step_equal(got, ref.pdes_multistep_counter_ref(*args, stale=True,
                                                           **kw))
    exact = pm.pdes_multistep_counter(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(exact[1]["ucount"][0], got[1]["ucount"][0])
    assert not torch.equal(exact[1]["ucount"], got[1]["ucount"])


@pytest.mark.parametrize("B,L", STALE_SHAPES)
def test_stale_fused_engine_equals_the_stale_loops_on_the_gpu(dev, B, L):
    """The stale window through ``PDESEngine`` on B1 (``pallas_multistep``)
    against the ``pallas`` (B2, a launch a step) and ``reference`` engines
    on the card: τ, offset and compensation, utilization and GVT bit for
    bit, the sums' statistics to rounding; from a state burned over a
    remainder chunk, two chunks and a remainder of 5."""
    cfg = PDESConfig(L=L, n_v=100, delta=100.0)
    deltas = torch.tensor([100.0, math.inf, 10.0, 300.0],
                          device=dev).repeat(16)[:B]
    trials = torch.arange(B, device=dev) - 1
    outs = []
    for backend in ("pallas_multistep", "pallas", "reference"):
        eng = PDESEngine(cfg, backend=backend, window="stale", k_fuse=16,
                         device=dev)
        st = eng.burn_in(eng.init(B), 4, 24, deltas=deltas,
                         trial_base=trials)
        outs.append(eng.run(st, 4, 37, deltas=deltas, trial_base=trials))
    (sa, a), *others = outs
    for sb, b in others:
        for f in ("tau", "offset", "offset_comp"):
            assert torch.equal(getattr(sa, f), getattr(sb, f)), f
        assert torch.equal(a.utilization, b.utilization)
        assert torch.equal(a.gvt, b.gvt)
        torch.testing.assert_close(a.mean_tau, b.mean_tau, rtol=1e-5,
                                   atol=1e-3)


def test_stale_service_at_the_production_ring(dev):
    """A stale sweep at L = 2^20 through the service on B1's grid tier: a
    duplicate, and an extension from the burned state over a burn-in of
    a chunk and a remainder, each as a direct run, bit for bit; each pass
    names the stale window and counts its B1 launches."""
    import json
    from repro_torch import obs as tobs
    from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
    from repro_torch.service.api import SweepService
    L = 1 << 20
    spec = WindowSweep(Ls=(L,), n_vs=(100,), deltas=(10.0, 100.0, math.inf),
                       replicas=2, n_steps=32, burn_in=24,
                       backend="pallas_multistep", window="stale", k_fuse=16,
                       seed=9)
    svc = SweepService(device=dev)
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    svc.attach_telemetry(tel)
    svc.submit(spec, requester="alice")
    svc.submit(spec, requester="carol")
    before = pm.launches
    responses = svc.drain()
    longer = dataclasses.replace(spec, n_steps=64)
    svc.submit(longer, requester="dave")
    responses += svc.drain()
    assert pm.launches - before == 2 + 2 + 4
    assert svc.stats.rows_from_state_cache == spec.n_trajectories
    assert responses[1].cached
    args = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    assert [(a["b1_tier"], a["window"], a["b1_rebased_launches"])
            for a in args] == [("grid", "stale", 4), ("grid", "stale", 4)]
    for resp in responses:
        assert resp.error is None
        assert json.dumps(resp.result.as_dict()) == json.dumps(
            run_window_sweep(resp.spec, device=dev).as_dict())


def test_engine_service_and_simulate_take_the_production_ring(dev):
    """The engine's fused path, the sweep service and simulate run a ring
    of the paper's production length through B1 and B3 on the card."""
    from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
    from repro_torch.service.api import SweepService
    L = 1 << 20
    spec = WindowSweep(Ls=(L,), n_vs=(100,), deltas=(100.0, math.inf),
                       replicas=2, n_steps=16, burn_in=16,
                       backend="pallas_multistep", k_fuse=16, seed=0)
    svc = SweepService(device=dev)
    svc.submit(spec, requester="a")
    before = pm.launches
    (resp,) = svc.drain()
    assert resp.error is None and pm.launches > before
    assert resp.result.as_dict() == run_window_sweep(spec,
                                                     device=dev).as_dict()
    cfg = PDESConfig(L=L, n_v=100, delta=100.0)
    st0 = horizon.init_state(cfg, 2, dev)
    key = prng.key(1, dev)
    b3 = pm.bits_launches
    sk, ok = ops.simulate(st0, key, cfg, 21, k_fuse=16)
    assert pm.bits_launches == b3 + 2
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ops, "pdes_multistep", ref.pdes_multistep_ref)
        sp, op = ops.simulate(st0, key, cfg, 21, k_fuse=16)
    for f in ("tau", "offset", "offset_comp"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    assert torch.equal(ok["u"], op["u"]) and torch.equal(ok["gvt"], op["gvt"])


def test_service_extension_keeps_the_state_cache_on_the_card(dev):
    """A round of the exact mix and its extension at a small L: the burned
    rows stay on the card (no byte crosses to the host or back), the
    extension is gathered from the cache's device tier, and every response
    equals a direct run bit for bit."""
    import json
    from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
    from repro_torch.service.api import SweepService
    common = dict(Ls=(1000,), n_vs=(10,), replicas=4, n_steps=64,
                  burn_in=64, backend="pallas_multistep", k_fuse=16, seed=5)
    alice = WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common)
    bob = WindowSweep(deltas=(4.0, 16.0, math.inf), **common)
    dave = dataclasses.replace(alice, n_steps=128)
    svc = SweepService(device=dev)
    for who, spec in (("alice", alice), ("bob", bob), ("carol", alice)):
        svc.submit(spec, requester=who)
    responses = svc.drain()
    svc.submit(dave, requester="dave")
    responses += svc.drain()
    assert svc.stats.rows_burned == 28 and svc.stats.n_passes == 2
    assert svc.stats.rows_from_state_cache == dave.n_trajectories
    assert svc.state_cache.device_hits == dave.n_trajectories
    assert svc.state_bytes_to_host == svc.state_bytes_to_device == 0
    for resp in responses:
        assert resp.error is None
        assert json.dumps(resp.result.as_dict()) == json.dumps(
            run_window_sweep(resp.spec, device=dev).as_dict()), resp.requester


def test_simulate_kernels_equal_plain_version(dev, monkeypatch):
    cfg = PDESConfig(L=512, n_v=4, delta=16.0)
    st0 = horizon.init_state(cfg, 8, dev)
    key = prng.key(3, dev)
    b3, gen = pm.bits_launches, threefry.launches
    sk, ok = ops.simulate(st0, key, cfg, 37, k_fuse=8)
    assert (pm.bits_launches - b3, threefry.launches - gen) == (5, 5)
    monkeypatch.setattr(ops, "pdes_multistep", ref.pdes_multistep_ref)
    monkeypatch.setattr(ops, "threefry_bits", threefry.threefry_bits_plain)
    sp, op = ops.simulate(st0, key, cfg, 37, k_fuse=8)
    assert (pm.bits_launches - b3, threefry.launches - gen) == (5, 5)
    for f in ("tau", "offset", "offset_comp"):
        assert torch.equal(getattr(sk, f), getattr(sp, f)), f
    assert torch.equal(ok["u"], op["u"]) and torch.equal(ok["gvt"], op["gvt"])
    torch.testing.assert_close(ok["w2"], op["w2"], rtol=1e-5, atol=1e-4)


def test_threefry_drivers_agree_across_devices(dev):
    """The GPU path (generator kernel + plain decode on the card) meets the
    same events as the CPU: update counts and GVT are equal."""
    cfg = PDESConfig(L=64, n_v=3, delta=4.0)
    before = threefry.launches
    gpu = ensemble.width_evolution(cfg, n_steps=30, n_trials=6, seed=2,
                                   device=dev)
    assert threefry.launches == before + 30
    cpu = ensemble.width_evolution(cfg, n_steps=30, n_trials=6, seed=2,
                                   device="cpu")
    for k in ("t", "u", "gvt"):
        np.testing.assert_array_equal(gpu[k], cpu[k], err_msg=k)
    for k in gpu.keys() - {"t", "u", "gvt"}:
        np.testing.assert_allclose(gpu[k], cpu[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# the sharded backend on the card: one rank of an NCCL process group
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1) process mesh over NCCL in this process (world size 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    import datetime
    import torch.distributed as dist
    from repro_torch.core.mesh import make_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh((1, 1), ("data", "model"))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode,window,backend", [
    ("exact", "exact", "pallas_multistep"), ("commavoid", "stale", "pallas")])
def test_sharded_on_nccl_matches_engine(nccl_mesh, mode, window, backend):
    """Each shard's step through B2: τ, the offsets, u and gvt bitwise
    equal to the engine with the same rebase schedule."""
    from repro_torch.core import distributed as D
    dev = nccl_mesh.device
    B, n_steps, K = 16, 64, 16
    cfg = PDESConfig(L=1000, n_v=10)
    deltas = torch.tensor([1.0, 4.0, math.inf, 16.0] * 4, device=dev)
    trials = torch.arange(B, device=dev) - 3          # negatives wrap
    z = torch.zeros(B, device=dev)
    before = ps.launches
    tau, off, comp, st = D.run_sharded_state(
        cfg, nccl_mesh, n_steps=n_steps, seed=3,
        dist=D.DistConfig(mode=mode, k_chunk=K),
        tau0=torch.zeros((B, cfg.L), device=dev), off0=z, comp0=z,
        step_base=5, deltas=deltas, trial_base=trials)
    per_step = 1 if mode == "exact" else 3
    assert ps.launches == before + per_step * n_steps
    eng = PDESEngine(cfg, backend=backend, window=window, k_fuse=K,
                     device=dev)
    st0 = eng.init(B)
    s_e, st_e = eng.run(st0._replace(step=5), 3, n_steps, deltas=deltas,
                        trial_base=trials)
    for a, b in ((tau, s_e.tau), (off, s_e.offset), (comp, s_e.offset_comp),
                 (st["u"], st_e.utilization), (st["gvt"], st_e.gvt)):
        assert torch.equal(a, b)
    for k in ("w2", "mean_tau", "max_dev", "min_dev"):
        torch.testing.assert_close(st[k], getattr(st_e, k), rtol=1e-5,
                                   atol=1e-2)


@pytest.mark.parametrize("delta,n_v,mode,k", [
    (5.0, 1, "exact", 8), (math.inf, 1, "exact", 8),
    (5.0, 10, "commavoid", 4), (10.0, 3, "commavoid", 8)])
def test_sharded_on_nccl_matches_run_reference(nccl_mesh, delta, n_v, mode,
                                               k):
    """``tests/test_distributed_pdes.py``'s cases and bounds on the card."""
    from repro_torch.core import distributed as D
    cfg = PDESConfig(L=32, n_v=n_v, delta=delta)
    tau_s, st_s = D.run_sharded(cfg, nccl_mesh, n_trials=6, n_steps=24,
                                seed=7, dist=D.DistConfig(mode=mode,
                                                          k_chunk=k))
    tau_r, st_r = D.run_reference(cfg, n_trials=6, n_steps=24, seed=7,
                                  stale_every=None if mode == "exact" else k,
                                  device=nccl_mesh.device)
    assert float((tau_s - tau_r).abs().max()) < 1e-4
    assert float((st_s["u"] - st_r["u"]).abs().max()) < 1e-6


def test_sharded_service_on_nccl(nccl_mesh):
    """A sharded service pass on the card equals direct mesh sweeps."""
    import json
    from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
    from repro_torch.service import SweepService
    common = dict(Ls=(256,), n_vs=(4,), replicas=3, n_steps=32, burn_in=16,
                  backend="sharded", k_fuse=16)
    specs = [WindowSweep(deltas=(2.0, 4.0, math.inf), **common),
             WindowSweep(deltas=(4.0, 8.0), **common)]
    svc = SweepService(mesh=nccl_mesh)
    for i, spec in enumerate(specs):
        svc.submit(spec, requester=f"r{i}")
    for resp in svc.drain():
        direct = run_window_sweep(resp.spec, mesh=nccl_mesh)
        assert json.dumps(resp.result.as_dict()) == \
            json.dumps(direct.as_dict())
    assert svc.stats.n_passes == 1


# ---------------------------------------------------------------------------
# the language-model serve path (no kernel of its own: the card against the
# CPU on one parameter set, in fp32 with TF32 off)
# ---------------------------------------------------------------------------


@pytest.fixture
def fp32_matmul(dev):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield dev
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _lm_on_both(arch, dev):
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    on_cpu = build_model(cfg, device="cpu", seed=0)
    on_card = build_model(cfg, device=dev, seed=1)
    bridge.lm_params_from_numpy(on_card, bridge.lm_params_to_numpy(on_cpu))
    return cfg, on_cpu, on_card


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b", "mixtral-8x7b"])
def test_lm_prefill_and_decode_card_equals_cpu(fp32_matmul, arch):
    cfg, on_cpu, on_card = _lm_on_both(arch, fp32_matmul)
    toks = torch.as_tensor(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 64)))
    lc, cc = on_cpu.prefill({"tokens": toks})
    lg, cg = on_card.prefill({"tokens": toks.to(fp32_matmul)})
    for step in range(4):
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-5)
        for k in cc:
            torch.testing.assert_close(cg[k].cpu(), cc[k], rtol=1e-4,
                                       atol=1e-5)
        tok = torch.argmax(lc, -1)[:, None]
        lc, cc = on_cpu.decode_step(cc, tok, 64 + step)
        lg, cg = on_card.decode_step(cg, tok.to(fp32_matmul), 64 + step)


def test_lm_serve_engine_card_equals_cpu(fp32_matmul):
    from repro_torch.serve import Request, ServeEngine
    cfg, on_cpu, on_card = _lm_on_both("llama3.2-1b", fp32_matmul)
    rng = np.random.default_rng(5)
    reqs = [(u, rng.integers(0, cfg.vocab_size, int(rng.integers(4, 25))),
             int(rng.integers(8, 30))) for u in range(5)]
    out = []
    for model, device in ((on_cpu, "cpu"), (on_card, fp32_matmul)):
        eng = ServeEngine(model, batch_lanes=2, max_len=96, delta=8.0,
                          device=device)
        for u, p, n in reqs:
            eng.submit(Request(u, p, n))
        out.append({u: r.tokens for u, r in eng.run().items()})
    assert out[0] == out[1]


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "whisper-base"])
def test_ssm_hybrid_encdec_card_equals_cpu(fp32_matmul, arch):
    """Prefill logits, every cache leaf and 8 decode steps of the reduced
    ssm, hybrid and encdec archs: the card against the CPU."""
    from torch_parity import flat_cache
    cfg, on_cpu, on_card = _lm_on_both(arch, fp32_matmul)
    rng = np.random.default_rng(0)
    if cfg.family == "encdec":
        batch = {"enc_embeddings": torch.as_tensor(
            (rng.standard_normal((2, 64, cfg.d_model)) * 0.1).astype(
                np.float32))}
        kw, pos0 = {"max_decode_len": 16}, 0
    else:
        batch = {"tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (2, 64)))}
        kw, pos0 = {}, 64
    lc, cc = on_cpu.prefill(batch, **kw)
    lg, cg = on_card.prefill({k: v.to(fp32_matmul) for k, v in batch.items()},
                             **kw)
    for step in range(9):
        torch.testing.assert_close(lg.cpu(), lc, rtol=1e-4, atol=1e-5)
        got = flat_cache(cg)
        for k, want in flat_cache(cc).items():
            torch.testing.assert_close(got[k].cpu(), want, rtol=1e-4,
                                       atol=1e-5, msg=f"step {step} cache {k}")
        tok = torch.argmax(lc, -1)[:, None]
        lc, cc = on_cpu.decode_step(cc, tok, pos0 + step)
        lg, cg = on_card.decode_step(cg, tok.to(fp32_matmul), pos0 + step)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "whisper-base"])
def test_model_without_cuda_raises(dev, arch, monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config(arch).reduced())



@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b", "mixtral-8x7b",
                                  "mamba2-130m", "zamba2-2.7b",
                                  "whisper-base"])
def test_loss_and_grads_card_equal_cpu(fp32_matmul, arch):
    """The training loss and every gradient leaf of the reduced archs in
    fp32: the card against the CPU (rtol 1e-5 on the loss, 1e-4 of each
    leaf's largest entry plus 1e-5 on the gradients)."""
    from torch_parity import lm_train_batch, port_loss_and_grads
    cfg, on_cpu, on_card = _lm_on_both(arch, fp32_matmul)
    batch = lm_train_batch(cfg, B=2, S=64)
    lc, _, gc = port_loss_and_grads(on_cpu, batch)
    lg, _, gg = port_loss_and_grads(on_card, batch)
    torch.testing.assert_close(lg.cpu(), lc, rtol=1e-5, atol=0)
    for k, want in gc.items():
        err = float((gg[k].cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()) + 1e-5, k


def test_train_steps_and_checkpoint_across_devices(dev, tmp_path):
    """Three train steps of reduced llama on the card; the state saved
    there restores on the CPU and back into the card's own tensors, bit
    for bit; the recovered controller's run equals the uninterrupted one."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.train import checkpoint
    from repro_torch.train.fault import (FaultInjector, RecoveryConfig,
                                         TrainController)
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    cfg = get_config("llama3.2-1b").reduced()
    dc = DataConfig(cfg.vocab_size, 64, 4)
    runs = []
    for name, fails in (("a", None), ("b", (2, 5))):
        model, step = make_train_step(cfg, device=dev)
        ctl = TrainController(step, init_train_state(model),
                              lambda i: make_batch(dc, i, dev),
                              RecoveryConfig(str(tmp_path / name), 2),
                              injector=FaultInjector(fails) if fails else None)
        runs.append((ctl, ctl.run(7)))
    (a, log_a), (b, log_b) = runs
    assert b.restarts == 2
    assert math.isclose(log_a[-1]["loss"], log_b[-1]["loss"], rel_tol=1e-5)
    checkpoint.save(a.state, tmp_path / "card", step=7)
    host = checkpoint.restore(tmp_path / "card", b.state, device="cpu")
    for x, y in zip(tree_leaves(a.state), tree_leaves(host)):
        assert y.device.type == "cpu" and torch.equal(x.cpu(), y)
    checkpoint.save(host, tmp_path / "host", step=7)
    back = checkpoint.restore(tmp_path / "host", b.state)
    for x, y in zip(tree_leaves(a.state), tree_leaves(back)):
        assert torch.equal(x, y)
    assert back["params"]["embed"]["table"] is b.state["params"]["embed"][
        "table"]


# ---------------------------------------------------------------------------
# sharded training (DTensor on a (1, 1) device mesh over NCCL)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b"])
def test_sharded_train_steps_bitwise_on_one_card(nccl_mesh, arch):
    """``chip_smoke.py`` phase 15(a) on a reduced arch: two steps with
    ``par`` on a ``(1, 1)`` device mesh over the module's NCCL group equal
    the ``par=None`` steps bit for bit, loss and every parameter."""
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.sharding import Parallelism
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves
    dev = nccl_mesh.device
    cfg = get_config(arch).reduced()
    batches = [make_batch(DataConfig(cfg.vocab_size, 64, 4), i, dev)
               for i in range(2)]

    def run(par):
        model, step = make_train_step(cfg, par, device=dev, seed=3)
        state, losses = init_train_state(model), []
        for b in batches:
            state, met = step(state, b)
            losses.append(met["loss"].item())
        return losses, [(t.full_tensor() if isinstance(t, DTensor) else t)
                        .detach() for t in tree_leaves(state["params"])]

    plain = run(None)
    sharded = run(Parallelism(make_host_mesh((1, 1), device_type="cuda")))
    assert plain[0] == sharded[0]
    assert all(torch.equal(a, b) for a, b in zip(plain[1], sharded[1]))
