"""Finite-size scaling analysis: extrapolations and exponent estimation.

Implements the paper's data-analysis machinery:

* Krug-Meakin extrapolation, Eq. (8):   u_L = u_inf + c / L^{2(1-alpha)}
* rational-function interpolation in 1/L, Eq. (10), with model selection
  over the numerator/denominator degrees (K_n, K_d);
* growth exponent beta from <w^2(t)> ~ t^{2 beta}  (Eq. 6);
* roughness exponent alpha from <w^2>_sat ~ L^{2 alpha}  (Eqs. 7, 9).

Pure numpy — this is host-side analysis of device-produced series.

Copied from ``repro.core.scaling`` (numpy only): importing ``repro.core``
loads JAX, which the port does not.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np


@dataclasses.dataclass
class Extrapolation:
    """Result of an L -> inf fit: the limit, fit coefficients, residual."""

    u_inf: float
    coeffs: dict
    residual: float
    model: str


def krug_meakin_extrapolate(Ls, uLs, alpha: float = 0.5) -> Extrapolation:
    """Least-squares fit of u_L = u_inf + c * L^{-2(1-alpha)} (Eq. 8)."""
    L = np.asarray(Ls, dtype=np.float64)
    u = np.asarray(uLs, dtype=np.float64)
    x = L ** (-2.0 * (1.0 - alpha))
    A = np.stack([np.ones_like(x), x], axis=1)
    sol, res, *_ = np.linalg.lstsq(A, u, rcond=None)
    resid = float(np.sqrt(np.mean((A @ sol - u) ** 2)))
    return Extrapolation(
        u_inf=float(sol[0]),
        coeffs={"const": float(sol[1]), "alpha": alpha},
        residual=resid,
        model=f"krug-meakin(alpha={alpha})",
    )


def _rational_design(x, u, kn, kd):
    """Linear system for u * (1 + sum b_k x^k) = sum_{k<=kn} a_k x^k.

    Unknowns [a_0..a_kn, b_1..b_kd]; row i:
      sum_k a_k x_i^k - u_i * sum_k b_k x_i^k = u_i.
    """
    cols = [x**k for k in range(kn + 1)]
    cols += [-u * x**k for k in range(1, kd + 1)]
    return np.stack(cols, axis=1)


def rational_extrapolate(Ls, uLs, max_kn: int = 3, max_kd: int = 3) -> Extrapolation:
    """Eq. (10): rational interpolation of u(1/L); extrapolates to a_0 = u_inf.

    Selects (K_n, K_d) by leave-one-out cross-validation as the paper's
    "best set of interpolation coefficients" criterion.
    """
    L = np.asarray(Ls, dtype=np.float64)
    u = np.asarray(uLs, dtype=np.float64)
    x = 1.0 / L
    n = len(x)
    best = None
    for kn, kd in itertools.product(range(1, max_kn + 1), range(0, max_kd + 1)):
        if kn + kd + 1 >= n:  # keep the fit over-determined
            continue
        A = _rational_design(x, u, kn, kd)
        # leave-one-out CV
        errs = []
        ok = True
        for i in range(n):
            mask = np.arange(n) != i
            try:
                sol, *_ = np.linalg.lstsq(A[mask], u[mask], rcond=None)
            except np.linalg.LinAlgError:
                ok = False
                break
            num = sum(sol[k] * x[i] ** k for k in range(kn + 1))
            den = 1.0 + sum(sol[kn + k] * x[i] ** k for k in range(1, kd + 1))
            if abs(den) < 1e-9:
                ok = False
                break
            errs.append((num / den - u[i]) ** 2)
        if not ok:
            continue
        cv = float(np.sqrt(np.mean(errs)))
        sol, *_ = np.linalg.lstsq(A, u, rcond=None)
        a0 = float(sol[0])
        if not (0.0 <= a0 <= 1.0):  # utilization must be physical
            continue
        if best is None or cv < best[0]:
            best = (cv, kn, kd, sol, a0)
    if best is None:
        # fall back to Krug-Meakin
        return krug_meakin_extrapolate(Ls, uLs)
    cv, kn, kd, sol, a0 = best
    return Extrapolation(
        u_inf=a0,
        coeffs={"a": sol[: kn + 1].tolist(), "b": sol[kn + 1 :].tolist()},
        residual=cv,
        model=f"rational(Kn={kn},Kd={kd})",
    )


def fit_power_law(t, y, t_min=None, t_max=None):
    """Log-log least-squares slope of y ~ t^slope over [t_min, t_max].

    Returns (slope, intercept, rms_residual_in_log_space).
    """
    t = np.asarray(t, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    m = (t > 0) & (y > 0)
    if t_min is not None:
        m &= t >= t_min
    if t_max is not None:
        m &= t <= t_max
    lt, ly = np.log(t[m]), np.log(y[m])
    A = np.stack([lt, np.ones_like(lt)], axis=1)
    sol, *_ = np.linalg.lstsq(A, ly, rcond=None)
    resid = float(np.sqrt(np.mean((A @ sol - ly) ** 2)))
    return float(sol[0]), float(sol[1]), resid


def growth_exponent(t, w2, fit_lo_frac=0.02, fit_hi_frac=0.25):
    """beta from <w^2(t)> ~ t^{2 beta} in the growth regime (Eq. 6).

    The fit window is a fraction of the pre-saturation range: by default
    [2%, 25%] of the series length, which sits inside the power-law regime
    for the sizes used in the paper's Fig. 4.
    """
    t = np.asarray(t, dtype=np.float64)
    n = len(t)
    lo, hi = max(2, int(n * fit_lo_frac)), max(4, int(n * fit_hi_frac))
    slope, _, resid = fit_power_law(t[lo:hi], np.asarray(w2)[lo:hi])
    return slope / 2.0, resid


def roughness_exponent(Ls, w2_sat):
    """alpha from <w^2>_sat ~ L^{2 alpha} (Eqs. 7, 9)."""
    slope, _, resid = fit_power_law(Ls, w2_sat)
    return slope / 2.0, resid


def saturation_width(w2_series, tail_frac=0.25):
    """Mean of the last ``tail_frac`` of the series (the plateau value)."""
    w2 = np.asarray(w2_series, dtype=np.float64)
    k = max(1, int(len(w2) * tail_frac))
    return float(np.mean(w2[-k:]))
