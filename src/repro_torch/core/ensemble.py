"""Ensemble orchestration (port of ``repro.core.ensemble``).

Host-side drivers: steady states over (L, N_V, Δ) and width evolutions,
what the paper calls "simulations of the simulations".  ``backend=None``
runs ``repro``'s legacy path, the step-by-step ``horizon`` drivers on
``jax.random``'s threefry stream (``core/prng.py``; on the GPU its words
come from the generator kernel); an engine backend name routes through
``PDESEngine`` on the counter stream.  Every driver takes ``device=``
(``None`` is the GPU, ``"cpu"`` the plain PyTorch path).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from ..device import resolve_device
from ..obs.trace import span as _span
from . import horizon, prng
from .horizon import PDESConfig
from .measurement import to_numpy as _np


def sync_if_traced(sp, device) -> None:
    """Wait for launched GPU work, but only inside a live span.

    Tracing wants honest phase attribution; untraced runs stay
    asynchronous.  Values are never affected either way.
    """
    if sp is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass
class SteadyState:
    """Time- and ensemble-averaged steady-state observables."""

    cfg: PDESConfig
    n_trials: int
    burn_in_steps: int
    measure_steps: int
    utilization: float
    utilization_err: float
    w: float          # <w> = <sqrt(w2)>  (ensemble avg of per-trial widths)
    w2: float         # <w^2>
    wa: float         # <w_a>
    rate: float       # GVT growth rate per parallel step


def default_burn_in(cfg: PDESConfig) -> int:
    """Heuristic burn-in long enough to pass the crossover.

    Unconstrained KPZ: t_x ~ L^{3/2}; constrained: saturation at
    t_p = O(Δ·N_V).  A safety factor over both.
    """
    if math.isinf(cfg.delta):
        t = 4.0 * (cfg.L ** 1.5)
    else:
        t = 60.0 * max(cfg.delta, 1.0) * max(1.0, math.sqrt(cfg.n_v)) + 2.0 * cfg.L
    return int(min(max(t, 200), 2_000_000))


def _engine(cfg, backend, engine_opts, device):
    from .engine import PDESEngine
    return PDESEngine(cfg, backend=backend, device=device,
                      **(engine_opts or {}))


def steady_state(cfg: PDESConfig, *, n_trials: int = 64, seed: int = 0,
                 burn_in_steps: int | None = None,
                 measure_steps: int | None = None, backend: str | None = None,
                 engine_opts: dict | None = None,
                 device=None) -> SteadyState:
    """Burn in, then time-average StepStats over ``measure_steps``.

    ``backend=None`` is the threefry path (``repro``'s trajectories, keyed
    on ``jax.random.key(seed)`` split into burn and measure keys); an
    engine backend name routes through ``PDESEngine`` on the counter
    stream, with ``engine_opts`` for its constructor (``window``,
    ``k_fuse``, and ``mesh``/``dist`` for ``backend="sharded"``).
    """
    if burn_in_steps is None:
        burn_in_steps = default_burn_in(cfg)
    if measure_steps is None:
        measure_steps = max(200, burn_in_steps // 4)
    point = {"L": cfg.L, "n_v": cfg.n_v, "rows": n_trials}
    if backend is None:
        dev = resolve_device(device)
        k_burn, k_meas = prng.split(prng.key(seed, dev))
        state = horizon.init_state(cfg, n_trials, dev)
        with _span("burn", args=dict(point, steps=burn_in_steps)) as sp:
            state = horizon.burn_in(state, k_burn, cfg, burn_in_steps)
            sync_if_traced(sp, dev)
        g0 = _np(state.offset)   # GVT at measurement start (tau rebased)
        with _span("measure", args=dict(point, steps=measure_steps)) as sp:
            state, stats = horizon.run_mean(state, k_meas, cfg,
                                            measure_steps)
            sync_if_traced(sp, dev)
    else:
        eng = _engine(cfg, backend, engine_opts, device)
        with _span("burn", args=dict(point, steps=burn_in_steps)) as sp:
            state = eng.burn_in(eng.init(n_trials), seed, burn_in_steps)
            sync_if_traced(sp, eng.device)
        g0 = _np(state.offset) + _np(state.tau).min(axis=-1)
        with _span("measure", args=dict(point, steps=measure_steps)) as sp:
            state, stats = eng.run_mean(state, seed, measure_steps)
            sync_if_traced(sp, eng.device)
    with _span("reduce", args=point):
        u = _np(stats.utilization)
        w2 = _np(stats.w2)
        g1 = _np(state.offset) + _np(state.tau).min(axis=-1)
    return SteadyState(
        cfg=cfg,
        n_trials=n_trials,
        burn_in_steps=burn_in_steps,
        measure_steps=measure_steps,
        utilization=float(u.mean()),
        utilization_err=float(u.std(ddof=1) / np.sqrt(n_trials)),
        w=float(np.sqrt(w2).mean()),
        w2=float(w2.mean()),
        wa=float(_np(stats.wa).mean()),
        rate=float((g1 - g0).mean() / measure_steps),
    )


def steady_state_sweep(cfg: PDESConfig, deltas: Sequence[float], *,
                       n_trials: int = 64, seed: int = 0,
                       burn_in_steps: int | None = None,
                       measure_steps: int | None = None,
                       backend: str = "reference",
                       engine_opts: dict | None = None,
                       device=None) -> list[SteadyState]:
    """Per-Δ steady states from one batched engine pass (window-sweep path).

    A ``SteadyState`` adapter over ``experiments.run_window_sweep``:
    ``cfg.delta`` is ignored and each result carries its row's Δ; the whole
    recorded span is averaged (``steady_frac=1.0``) and ``rate`` is the
    least-squares GVT slope.  ``engine_opts`` takes ``window``, ``k_fuse``
    and, for ``backend="sharded"``, ``mesh`` and ``dist``, which route to
    ``run_window_sweep``'s mesh path.
    """
    from ..experiments.sweep import WindowSweep, run_window_sweep
    if burn_in_steps is None:
        burn_in_steps = max(
            default_burn_in(dataclasses.replace(cfg, delta=float(d)))
            for d in deltas)
    if measure_steps is None:
        measure_steps = max(200, burn_in_steps // 4)
    opts = dict(engine_opts or {})
    mesh = opts.pop("mesh", None)
    dist = opts.pop("dist", None)
    unsupported = sorted(set(opts) - {"window", "k_fuse"})
    if unsupported:
        raise ValueError(
            f"steady_state_sweep supports engine_opts 'window', 'k_fuse', "
            f"'mesh' and 'dist' only; got {unsupported}")
    spec = WindowSweep(
        Ls=(cfg.L,), n_vs=(cfg.n_v,), deltas=tuple(float(d) for d in deltas),
        replicas=n_trials, n_steps=measure_steps, burn_in=burn_in_steps,
        backend=backend, rd_mode=cfg.rd_mode,
        border_both=cfg.border_both, steady_frac=1.0, seed=seed, **opts)
    result = run_window_sweep(spec, device=device, mesh=mesh, dist=dist)
    out = []
    for d in deltas:
        (rec,) = result.select(delta=float(d))
        out.append(SteadyState(
            cfg=dataclasses.replace(cfg, delta=float(d)),
            n_trials=n_trials,
            burn_in_steps=burn_in_steps,
            measure_steps=measure_steps,
            utilization=rec.u,
            utilization_err=rec.u_err,
            w=rec.w,
            w2=rec.w2,
            wa=rec.wa,
            rate=rec.rate,
        ))
    return out


def utilization_vs_L(Ls: Sequence[int], *, n_v: int = 1,
                     delta: float = math.inf, rd_mode: bool = False,
                     n_trials: int = 64, seed: int = 0,
                     burn_in_steps: int | None = None,
                     measure_steps: int | None = None,
                     backend: str | None = None,
                     engine_opts: dict | None = None, device=None):
    """Steady-state utilization for a range of ring sizes (Figs. 2, 5)."""
    return [steady_state(PDESConfig(L=int(L), n_v=n_v, delta=delta,
                                    rd_mode=rd_mode),
                         n_trials=n_trials, seed=seed + i,
                         burn_in_steps=burn_in_steps,
                         measure_steps=measure_steps, backend=backend,
                         engine_opts=engine_opts, device=device)
            for i, L in enumerate(Ls)]


def width_evolution(cfg: PDESConfig, *, n_steps: int, n_trials: int = 64,
                    seed: int = 0, backend: str | None = None,
                    engine_opts: dict | None = None, device=None):
    """Full <w(t)>, <w_a(t)>, <u(t)> series (Figs. 2, 4, 8).

    Returns a dict of numpy arrays with a leading time axis.  ``backend``
    is chosen as in :func:`steady_state`.
    """
    with _span("measure", args={"L": cfg.L, "n_v": cfg.n_v,
                                "rows": n_trials, "steps": n_steps}) as sp:
        if backend is None:
            dev = resolve_device(device)
            _, stats = horizon.run(horizon.init_state(cfg, n_trials, dev),
                                   prng.key(seed, dev), cfg, n_steps)
        else:
            eng = _engine(cfg, backend, engine_opts, device)
            dev = eng.device
            _, stats = eng.run(eng.init(n_trials), seed, n_steps)
        sync_if_traced(sp, dev)
    w2 = _np(stats.w2)
    return {
        "t": np.arange(1, n_steps + 1),
        "u": _np(stats.utilization).mean(axis=1),
        "w": np.sqrt(w2).mean(axis=1),
        "w2": w2.mean(axis=1),
        "wa": _np(stats.wa).mean(axis=1),
        "gvt": _np(stats.gvt).mean(axis=1),
        "max_dev": _np(stats.max_dev).mean(axis=1),
        "min_dev": _np(stats.min_dev).mean(axis=1),
    }
