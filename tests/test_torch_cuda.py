"""The port's CUDA kernels on the GPU, against their plain PyTorch versions.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one.  On a machine with a card (Hopper, ``sm_90a``)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import ensemble, horizon, prng
from repro_torch.core.engine import PDESEngine
from repro_torch.core.horizon import PDESConfig
from repro_torch.core.events import counter_bits_block
from repro_torch.kernels import ops, ref, threefry, tiling
from repro_torch.kernels import pdes_multistep as pm
from repro_torch.kernels import pdes_step as ps

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
                                 (2, tiling.MAX_RING_L)])
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
    """B2's decode (the fp64 library log) gives the table decode's floats."""
    w1 = torch.arange(1 << 24, device=dev, dtype=torch.int64) << 8
    assert torch.equal(pm.decode_eta_cuda(w1, table=False),
                       horizon.decode_eta(w1))


#: The ring lengths at the new loop's edges: one PE, a partial row, one
#: warp's row, a row and one PE, the paper's L, the service's L, the longest.
EDGE_LS = (1, 31, 32, 33, 1000, 10_000, tiling.MAX_RING_L)
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


@pytest.mark.parametrize("L", (1000, 10_000))
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
    with pytest.raises(ValueError, match="shared memory"):
        pm.pdes_multistep_counter(
            torch.zeros(1, tiling.MAX_RING_L + 1, device=dev), ctr,
            k_steps=1, n_v=1, delta=1.0)


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
                                  (2, tiling.MAX_RING_L + 1000)])
def test_step_kernel_matches_plain_version(dev, n_v, rd_mode, border_both,
                                           base, B, Lc):
    """Rows longer than B1's shared-memory limit run too."""
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
                                   (2, tiling.MAX_RING_L, 3)])
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
    L = tiling.MAX_RING_L + 1
    with pytest.raises(ValueError, match="shared memory"):
        pm.pdes_multistep(torch.zeros(1, L, device=dev),
                          torch.zeros(1, 1, L, 2, dtype=torch.int32,
                                      device=dev), n_v=1, delta=1.0)


def test_bits_kernel_launch_failure_raises(dev, monkeypatch):
    """A refused launch raises; nothing falls back to the plain version."""
    monkeypatch.setattr(pm, "check_ring_fits", lambda L: None)
    L = tiling.MAX_RING_L + 1000          # more shared memory than a block has
    assert tiling.ring_smem_bytes(L) > tiling.SMEM_PER_BLOCK
    before = pm.bits_launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        pm.pdes_multistep(torch.zeros(1, L, device=dev),
                          torch.zeros(1, 1, L, 2, dtype=torch.int32,
                                      device=dev), n_v=1, delta=1.0)
    assert pm.bits_launches == before


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
