"""The port's ``pallas`` backend against ``repro``'s, in both window modes.

With JAX's η injected, ``PDESEngine(backend="pallas")`` (the one-step
kernel's plain version on the CPU) reproduces ``repro``'s ``pallas``
backend (Pallas in interpret mode) for ``run``, ``run_mean`` and
``burn_in``: τ, the Kahan offsets, utilization and GVT bit for bit, the
sums' statistics to ``RTOL``.  The run is 37 steps at ``k_fuse=8`` (four
chunks and a remainder of 5) with a per-row Δ column, ``inf`` rows and
negative trial indices.  Within the port, ``pallas`` equals ``reference``
in both windows and ``pallas_multistep`` in the exact one, bit for bit.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PDESConfig as JConfig
from repro.core.engine import PDESEngine as JEngine
from repro_torch.core import horizon as th
from repro_torch.core.engine import PDESEngine
from repro_torch.core.horizon import PDESConfig

from torch_parity import RTOL, assert_stats, jax_eta_table, np_of

L, N_V = 48, 3
DELTAS = np.array([0.5, 2.0, math.inf, 4.0, math.inf, 1.0], np.float32)
TRIALS = np.array([0, 1, 2, 40, -1, -2], np.int32)   # pad-style negatives
SEED, STEPS, K = 11, 37, 8


def _jax(window, mode):
    eng = JEngine(JConfig(L=L, n_v=N_V), backend="pallas", window=window,
                  k_fuse=K)
    return getattr(eng, mode)(eng.init(len(DELTAS)), SEED, STEPS,
                              deltas=jnp.asarray(DELTAS),
                              trial_base=jnp.asarray(TRIALS))


def _port(backend, window, mode, eta=True):
    eng = PDESEngine(PDESConfig(L=L, n_v=N_V), backend=backend,
                     window=window, k_fuse=K, device="cpu")
    args = (eng.init(len(DELTAS)), SEED, STEPS)
    kw = dict(deltas=torch.as_tensor(DELTAS),
              trial_base=torch.as_tensor(TRIALS))
    if not eta:
        return getattr(eng, mode)(*args, **kw)
    with th.eta_override(jax_eta_table()):
        return getattr(eng, mode)(*args, **kw)


def _assert_state(port, ref):
    for f in ("tau", "offset", "offset_comp"):
        np.testing.assert_array_equal(np_of(getattr(port, f)),
                                      np_of(getattr(ref, f)), err_msg=f)
    assert port.step == int(ref.step)


@pytest.mark.parametrize("window", ["exact", "stale"])
def test_pallas_run_matches_repro(window):
    (js, jstats), (ts, tstats) = _jax(window, "run"), \
        _port("pallas", window, "run")
    _assert_state(ts, js)
    assert_stats(tstats, jstats)
    assert tstats.gvt.shape == (STEPS, len(DELTAS))


@pytest.mark.parametrize("window", ["exact", "stale"])
def test_pallas_burn_and_mean_match_repro(window):
    _assert_state(_port("pallas", window, "burn_in"),
                  _jax(window, "burn_in"))
    (js, jmean), (ts, tmean) = _jax(window, "run_mean"), \
        _port("pallas", window, "run_mean")
    _assert_state(ts, js)
    # the time average sums (K, B) planes in another order: RTOL only
    for f in jmean._fields:
        np.testing.assert_allclose(np_of(getattr(tmean, f)),
                                   np_of(getattr(jmean, f)), rtol=RTOL,
                                   atol=1e-5, err_msg=f)


@pytest.mark.parametrize("window", ["exact", "stale"])
def test_pallas_equals_reference_within_the_port(window):
    """On the port's own decode, no η injected."""
    (sa, a), (sb, b) = (_port(backend, window, "run", eta=False)
                        for backend in ("pallas", "reference"))
    assert torch.equal(sa.tau, sb.tau) and torch.equal(sa.offset, sb.offset)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pallas_equals_multistep_in_the_exact_window():
    (sa, a), (sb, b) = (_port(backend, "exact", "run", eta=False)
                        for backend in ("pallas", "pallas_multistep"))
    assert torch.equal(sa.tau, sb.tau) and torch.equal(sa.offset, sb.offset)
    assert torch.equal(sa.offset_comp, sb.offset_comp)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_stale_window_is_stricter_than_exact():
    """A stale base is at most the exact GVT: never more updates."""
    outs = {w: _port("pallas", w, "run", eta=False)[1].utilization
            for w in ("exact", "stale")}
    assert float(outs["stale"].mean()) <= float(outs["exact"].mean())
    # the first step of a chunk sees the same base in both windows
    assert torch.equal(outs["stale"][0], outs["exact"][0])
