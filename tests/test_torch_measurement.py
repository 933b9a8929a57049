"""``repro_torch.core.measurement`` and the sweep's spans against ``repro``."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import measurement as jm
from repro.core.horizon import StepStats as JStats
from repro_torch.core import measurement as tm
from repro_torch.core.horizon import StepStats as TStats
from repro_torch.experiments.sweep import WindowSweep, run_window_sweep
from repro_torch.obs import trace

from torch_parity import RTOL


def _tau(seed=0, B=5, L=40):
    rng = np.random.default_rng(seed)
    tau = rng.exponential(2.0, (B, L)).astype(np.float32)
    tau[0] = 1.5                                    # a synchronized ring
    return tau


@pytest.mark.parametrize("fn", ["width", "width_abs", "spread",
                                "extreme_fluctuations",
                                "group_decomposition"])
def test_horizon_observables_match_reference(fn):
    tau = _tau()
    port = getattr(tm, fn)(torch.as_tensor(tau))
    ref = getattr(jm, fn)(jnp.asarray(tau))
    port = port if isinstance(port, tuple) else (port,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    for a, b in zip(port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=RTOL,
                                   atol=1e-6)
    if fn == "group_decomposition":
        g = port
        np.testing.assert_allclose(tm.recombine_w2(g).numpy(),
                                   tm.width(torch.as_tensor(tau)).numpy() ** 2,
                                   rtol=1e-4, atol=1e-5)


def test_sweep_reduce_and_progress_rate_match_reference():
    rng = np.random.default_rng(4)
    T, n_w, R = 30, 3, 4
    fields = {f: rng.random((T, n_w * R)).astype(np.float32)
              for f in TStats._fields}
    fields["gvt"] = np.cumsum(fields["gvt"], axis=0).astype(np.float32)
    port = tm.sweep_reduce(TStats(**{k: torch.as_tensor(v)
                                     for k, v in fields.items()}), n_w, R)
    ref = jm.sweep_reduce(JStats(**fields), n_w, R)
    assert port.keys() == ref.keys()
    for k in ref:
        if k in ("u", "u_err", "w2", "w2_err", "w", "wa", "spread"):
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
        else:
            np.testing.assert_allclose(port[k], ref[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(tm.progress_rate(fields["gvt"], t0=5),
                               np.asarray(jm.progress_rate(
                                   jnp.asarray(fields["gvt"]), t0=5)),
                               rtol=RTOL)
    for n, f in ((10, 0.5), (1, 0.5), (7, 1.0), (100, 0.25)):
        assert tm.steady_start(n, f) == jm.steady_start(n, f)
    with pytest.raises(ValueError):
        tm.steady_start(10, 0.0)
    with pytest.raises(ValueError):
        tm.sweep_reduce(TStats(**fields), 2, R)


def test_sweep_spans_nest_and_leave_results_unchanged():
    spec = WindowSweep(Ls=(16,), n_vs=(2,), deltas=(2.0, math.inf),
                       replicas=3, n_steps=16, burn_in=8,
                       backend="pallas_multistep", k_fuse=8)
    plain = run_window_sweep(spec, device="cpu")
    rec = trace.TraceRecorder()
    prev = trace.set_tracer(rec)
    try:
        traced = run_window_sweep(spec, device="cpu")
    finally:
        trace.set_tracer(prev)
    assert traced == plain
    # the engine's spans nest inside the sweep's phases
    phases = [e for e in rec.events if not e["name"].startswith("engine.")]
    assert [e["name"] for e in phases] == ["burn", "measure", "reduce"]
    assert phases[0]["args"] == {"L": 16, "n_v": 2, "rows": 6, "steps": 8}
    runs = [e for e in rec.events if e["name"] == "engine.run"]
    assert [r["args"]["mode"] for r in runs] == ["burn", "record"]
    for r, ph in zip(runs, phases):
        assert ph["ts"] <= r["ts"] and \
            r["ts"] + r["dur"] <= ph["ts"] + ph["dur"] + 1e-3   # rounding
    assert all(e["dur"] >= 0 for e in rec.events)
