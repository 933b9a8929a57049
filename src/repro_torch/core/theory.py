"""Closed-form results and fits from the paper (Appendix + Eqs. 12-14).

These are the paper's *own* parameterizations of its simulation data; we use
them as validation oracles for our reproduction (EXPERIMENTS.md C6) and as
the capacity-planning formulas exposed by the framework (DESIGN.md §3.2).

Copied from ``repro.core.theory`` (numpy only): importing ``repro.core``
loads JAX, which the port does not.
"""
from __future__ import annotations


import numpy as np

#: Steady-state utilization of the unconstrained N_V = 1 scheme in the
#: infinite-L limit, Toroczkai et al / Korniss et al (paper Sec. III.A).
U_INF_KPZ_NV1 = 0.246461

#: KPZ exponents governing the unconstrained N_V = 1 horizon (Sec. III).
KPZ_ALPHA = 0.5
KPZ_BETA = 1.0 / 3.0
#: Random-deposition growth exponent (initial phase for large N_V).
RD_BETA = 0.5


def _finite_domain(d):
    """Mask the fit formulas' singular endpoints (Δ=0, Δ=inf, NaN).

    The rational fits divide by powers of Δ: at Δ=0 both ``c/d**e`` terms
    are inf and their difference is NaN (a real invalid-subtract at extreme
    Δ, not just noise), and Δ=inf needs no formula at all.  Evaluate on a
    substituted safe value and let the caller select the analytic limit.
    """
    ok = np.isfinite(d) & (d > 0)
    return ok, np.where(ok, d, 1.0)


def _masked_limits(d, ok, val):
    """Recombine: fit where valid, analytic limits at Δ=0 / Δ=+inf.

    NaN and negative Δ stay NaN — bad inputs must surface, not read as
    full utilization.
    """
    lim = np.where(d == 0, 0.0, np.where(d == np.inf, 1.0, np.nan))
    return np.where(ok, val, lim)


def u_rd(delta, four_point: bool = True):
    """Eq. (A.1): utilization of Δ-constrained random deposition, L -> inf.

    Four-point fit: ±2% over 0 <= Δ < inf; two-point: ±2.5%.
    Limits are handled explicitly (no NaN intermediates, no warnings):
    ``u_rd(0) = 0`` (window closed) and ``u_rd(inf) = 1`` (window off).
    """
    d = np.asarray(delta, dtype=np.float64)
    if four_point:
        c3, e3, c4, e4 = 15.8, 1.07, 12.3, 1.18
    else:
        c3, e3, c4, e4 = 3.47, 0.84, 0.0, 1.0
    ok, ds = _finite_domain(d)
    # clip: utilization is physical — the four-point denominator flips sign
    # below Δ ~ 1e-10, where the fit means u = 0 anyway
    val = np.clip(1.0 / (1.0 + c3 / ds**e3 - c4 / ds**e4), 0.0, 1.0)
    return _masked_limits(d, ok, val)


def u_kpz(n_v, four_point: bool = True):
    """Eq. (A.2): utilization of the unconstrained (Δ=inf) scheme, L -> inf.

    u_kpz(1) ≈ 0.2475 (cf. the exact 24.6461%); u_kpz(inf) = 1.
    """
    n = np.asarray(n_v, dtype=np.float64)
    if four_point:
        c1, e1, c2, e2 = 2.3, 0.96, 0.74, 0.4
    else:
        c1, e1, c2, e2 = 3.0, 0.715, 0.0, 1.0
    return 1.0 / (1.0 + c1 / n**e1 + c2 / n**e2)


def p_exponent(delta, n_v=None):
    """The coupling exponent p(Δ[, N_V]) of Eq. (12).

    With ``n_v=None`` returns the simple two-point formula
    ``p = 1 / (1 + 2 / Δ^{3/4})``; otherwise the piecewise four-point fit
    (A.3) with the paper's constants.
    """
    d = np.asarray(delta, dtype=np.float64)
    ok, ds = _finite_domain(d)
    if n_v is None:
        val = 1.0 / (1.0 + 2.0 / ds**0.75)
        return _masked_limits(d, ok, val)
    n = np.asarray(n_v, dtype=np.float64)
    # piecewise constants from the Appendix
    c5 = np.where(n >= 100, 528.4, np.where(n < 10, 17.43, 5.345))
    e5 = np.where(n >= 100, 1.487, np.where(n < 10, 1.406, 0.627))
    c6 = np.where(n >= 100, 515.1, np.where(n < 10, 15.3, 0.095))
    e6 = np.where(n >= 100, 1.609, np.where(n < 10, 1.687, 0.045))
    val = np.clip(1.0 / (1.0 + c5 / ds**e5 - c6 / ds**e6), 0.0, 1.0)
    return _masked_limits(d, ok, val)


def u_composite(n_v, delta, four_point: bool = True):
    """Eq. (12): u(N_V, Δ) = u_RD(Δ) · u_KPZ(N_V)^p(Δ,N_V), L -> inf.

    ±5% relative (four-point), ±10% (two-point) per the Appendix.
    """
    n = np.asarray(n_v, dtype=np.float64)
    d = np.asarray(delta, dtype=np.float64)
    if np.any(np.isinf(d)):
        # Δ = inf → window inactive → u = u_KPZ exactly by construction.
        base = u_kpz(n, four_point)
        return np.where(np.isinf(d), base,
                        _u_composite_finite(n, d, four_point))
    return _u_composite_finite(n, d, four_point)


def _u_composite_finite(n, d, four_point):
    p = p_exponent(d, n if four_point else None)
    return u_rd(d, four_point) * u_kpz(n, four_point) ** p


def u_kpz_mean_field(n_v, delta_wait, p_wait):
    """Eq. (13): mean-field utilization of the unconstrained scheme.

    1/u - 1 = (δ - 2/N_V) p_w, valid for N_V >= 3, where δ is the mean number
    of steps a PE waits given it must inquire about a neighbor and p_w the
    probability of waiting when a border site is picked.
    """
    n = np.asarray(n_v, dtype=np.float64)
    return 1.0 / (1.0 + (delta_wait - 2.0 / n) * p_wait)


def u_window_mean_field(n_v, delta_wait, p_wait, kappa, p_delta):
    """Eq. (14): mean-field utilization in the large-Δ constrained scheme."""
    n = np.asarray(n_v, dtype=np.float64)
    denom = 1.0 + (delta_wait - 2.0 / n) * p_wait \
        + (kappa - 1.0 + (2.0 / n) * p_wait) * p_delta
    return 1.0 / denom


def krug_meakin_u(L, u_inf=U_INF_KPZ_NV1, const=0.26, alpha=KPZ_ALPHA):
    """Eq. (8): finite-size utilization for generic KPZ-like processes."""
    L = np.asarray(L, dtype=np.float64)
    return u_inf + const / L ** (2.0 * (1.0 - alpha))


def kpz_crossover_time(L, z=1.5, t0=3700.0 / 100.0**1.5):
    """t_x ~ L^z; calibrated to the paper's t_x ≈ 3700 at L = 100 (Fig. 3)."""
    return t0 * np.asarray(L, dtype=np.float64) ** z
