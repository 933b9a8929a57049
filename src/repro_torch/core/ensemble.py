"""Ensemble helpers (port of ``repro.core.ensemble``, ``default_burn_in``).

``steady_state`` and ``width_evolution`` come with a later slice
(ROADMAP, queue A, item A6).
"""
from __future__ import annotations

import math

from .horizon import PDESConfig


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
