"""The port's Δ-window scheduler against ``repro.distributed.delta_sync``.

``tests/test_delta_sync.py``'s seven cases, each run on the port's
scheduler and on ``repro``'s from the same seeds: the same invariants hold
on the port, and the two agree exactly (both are numpy float64).
"""
import numpy as np

from repro.distributed import delta_sync as jds
from repro_torch.distributed import delta_sync as tds


def _pair(**cfg):
    return (tds.DeltaScheduler(tds.DeltaSyncConfig(**cfg)),
            jds.DeltaScheduler(jds.DeltaSyncConfig(**cfg)))


def _same(port, ref):
    np.testing.assert_array_equal(port.tau, ref.tau)
    assert (port.rounds, port.committed, port.attempted) == \
        (ref.rounds, ref.committed, ref.attempted)


def test_utilization_matches_paper_rd_fit():
    from repro_torch.core.scaling import rational_extrapolate
    delta = 10.0
    us, Ls = [], [64, 128, 256, 512]
    for L in Ls:
        port, ref = _pair(n_workers=L, delta=delta, seed=3)
        for sch in (port, ref):
            for _ in range(400):
                sch.offer()
            sch.committed = sch.attempted = 0
            for _ in range(800):
                sch.offer()
        _same(port, ref)
        us.append(port.utilization)
    assert all(a > b for a, b in zip(us, us[1:])), us
    ex = rational_extrapolate(Ls, us)
    pred = tds.predicted_utilization(delta)
    assert pred == jds.predicted_utilization(delta)
    assert abs(ex.u_inf - pred) < 0.1, (ex.u_inf, pred)


def test_bounded_staleness_invariant():
    rng = np.random.default_rng(0)
    port, ref = _pair(n_workers=64, delta=5.0)
    for _ in range(400):
        durations = rng.exponential(1.0, 64)
        before = port.tau.copy()
        allowed = port.offer(durations)
        np.testing.assert_array_equal(allowed, ref.offer(durations))
        assert not (allowed & (before > 5.0 + before.min())).any()
    assert port.spread <= 5.0 + 15.0
    _same(port, ref)


def test_gvt_monotone_nondecreasing():
    port, ref = _pair(n_workers=32, delta=3.0)
    g = port.gvt
    for _ in range(200):
        port.offer()
        ref.offer()
        assert port.gvt >= g - 1e-12
        g = port.gvt
    assert port.gvt == ref.gvt
    _same(port, ref)


def test_delta_zero_serializes():
    port, ref = _pair(n_workers=16, delta=0.0)
    port.offer()
    ref.offer()
    for _ in range(100):
        allowed = port.offer()
        np.testing.assert_array_equal(allowed, ref.offer())
        assert allowed.sum() <= 2
    assert port.utilization < 0.3
    _same(port, ref)


def test_delta_inf_never_blocks():
    port, ref = _pair(n_workers=16, delta=np.inf)
    for _ in range(50):
        assert port.offer().all()
        ref.offer()
    _same(port, ref)


def test_gated_weights_unbiased():
    port, ref = _pair(n_workers=8, delta=4.0)
    for _ in range(100):
        w, mask = tds.gated_microbatch_weights(port)
        jw, jmask = jds.gated_microbatch_weights(ref)
        np.testing.assert_array_equal(w, jw)
        np.testing.assert_array_equal(mask, jmask)
        if mask.any():
            np.testing.assert_allclose(w.sum(), 8.0)
        assert (w[~mask] == 0).all()


def test_checkpoint_frontier():
    port, ref = _pair(n_workers=8, delta=2.0)
    last = 0.0
    fired = 0
    for _ in range(300):
        port.offer()
        ref.offer()
        due = port.checkpoint_due(last, interval=5.0)
        assert due == ref.checkpoint_due(last, interval=5.0)
        if due:
            assert (port.tau >= port.gvt - 1e-12).all()
            np.testing.assert_array_equal(port.staleness(), ref.staleness())
            last = port.gvt
            fired += 1
    assert fired >= 3
