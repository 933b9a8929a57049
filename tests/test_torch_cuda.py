"""The port's CUDA kernel on the GPU, against its plain PyTorch version.

A CUDA kernel has no CPU mode, so every test here needs an NVIDIA GPU and
skips without one.  On a machine with a card (Hopper, ``sm_90a``)::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.core import horizon
from repro_torch.core.engine import PDESEngine
from repro_torch.core.horizon import PDESConfig
from repro_torch.kernels import pdes_multistep as pm
from repro_torch.kernels import ref, tiling

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
