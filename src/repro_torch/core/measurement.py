"""Measurement-phase observables (port of ``repro.core.measurement``).

The slow/fast simplex decomposition of Sec. IV.B (Eqs. 15-18), widths and
extreme fluctuations on ``tau`` tensors of shape ``(B, L)``, and the per-Δ
steady-state reduction of a window sweep, which works in numpy on the
host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class GroupStats(NamedTuple):
    """Slow/fast decomposition at one step (all ``(B,)``); see ``repro``."""

    f_slow: torch.Tensor
    f_fast: torch.Tensor
    w2_slow: torch.Tensor
    w2_fast: torch.Tensor
    wa_slow: torch.Tensor
    wa_fast: torch.Tensor


def group_decomposition(tau: torch.Tensor) -> GroupStats:
    """Slow/fast group populations and widths of a horizon, Eqs. (15)-(16)."""
    L = tau.shape[-1]
    mean = tau.mean(dim=-1, keepdim=True)
    dev = tau - mean
    slow = tau <= mean
    n_slow = slow.sum(dim=-1).to(tau.dtype)
    n_fast = L - n_slow

    def _group_mean(x, mask, n):
        s = torch.where(mask, x, 0).sum(dim=-1)
        return torch.where(n > 0, s / torch.clamp(n, min=1), 0)

    return GroupStats(
        f_slow=n_slow / L,
        f_fast=n_fast / L,
        w2_slow=_group_mean(dev * dev, slow, n_slow),
        w2_fast=_group_mean(dev * dev, ~slow, n_fast),
        wa_slow=_group_mean(dev.abs(), slow, n_slow),
        wa_fast=_group_mean(dev.abs(), ~slow, n_fast),
    )


def recombine_w2(g: GroupStats) -> torch.Tensor:
    """Eq. (17): the full variance as the convex combination of group terms."""
    return g.f_slow * g.w2_slow + g.f_fast * g.w2_fast


def recombine_wa(g: GroupStats) -> torch.Tensor:
    """Eq. (18)."""
    return g.f_slow * g.wa_slow + g.f_fast * g.wa_fast


def width(tau: torch.Tensor) -> torch.Tensor:
    """w = sqrt(w2), Eq. (4), per trial."""
    dev = tau - tau.mean(dim=-1, keepdim=True)
    return (dev * dev).mean(dim=-1).sqrt()


def width_abs(tau: torch.Tensor) -> torch.Tensor:
    """w_a, Eq. (5), per trial."""
    return (tau - tau.mean(dim=-1, keepdim=True)).abs().mean(dim=-1)


def extreme_fluctuations(tau: torch.Tensor):
    """(above, below) extreme deviations from the mean, per trial."""
    dev = tau - tau.mean(dim=-1, keepdim=True)
    return dev.amax(dim=-1), -dev.amin(dim=-1)


def spread(tau: torch.Tensor) -> torch.Tensor:
    """max - min of the horizon, per trial; bounded by ~Δ + one increment."""
    return tau.amax(dim=-1) - tau.amin(dim=-1)


def to_numpy(x) -> np.ndarray:
    """A tensor or array as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def progress_rate(gvt_series, t0: int = 0) -> np.ndarray:
    """Least-squares slope d(GVT)/dt of a (T, B) series over [t0, T), in fp32.

    Returns a (B,) numpy array (host work: the sweep reduction's input).
    """
    g = to_numpy(gvt_series)[t0:]
    T = g.shape[0]
    t = np.arange(T, dtype=g.dtype)
    t_mean = t.mean()
    g_mean = g.mean(axis=0)
    cov = ((t[:, None] - t_mean) * (g - g_mean)).mean(axis=0)
    var = ((t - t_mean) ** 2).mean()
    return cov / var


def steady_start(n_steps: int, steady_frac: float = 0.5) -> int:
    """First step of the steady-state measurement window."""
    if not 0.0 < steady_frac <= 1.0:
        raise ValueError(f"steady_frac must be in (0, 1], got {steady_frac}")
    return min(n_steps - 1, int(round(n_steps * (1.0 - steady_frac))))


def sweep_reduce(stats, n_windows: int, replicas: int, *,
                 steady_frac: float = 0.5) -> dict:
    """Reduce batched window-sweep StepStats to per-Δ steady-state estimates.

    ``stats`` fields are ``(T, n_windows * replicas)`` tensors or arrays,
    window ``w`` owning rows ``[w*replicas, (w+1)*replicas)``.  Returns a
    dict of ``(n_windows,)`` numpy arrays: ``u``/``u_err``, ``w2``/
    ``w2_err``, ``w``, ``wa``, ``spread``, ``rate``/``rate_err``.
    """
    u = to_numpy(stats.utilization)
    T = u.shape[0]
    if u.shape[1] != n_windows * replicas:
        raise ValueError(f"stats rows {u.shape[1]} != n_windows*replicas "
                         f"({n_windows}*{replicas})")
    t0 = steady_start(T, steady_frac)

    def _per_window(x):                      # (T, B) -> (n_windows, replicas)
        return to_numpy(x)[t0:].mean(axis=0).reshape(n_windows, replicas)

    def _mean_err(x):
        m = x.mean(axis=1)
        e = (x.std(axis=1, ddof=1) / np.sqrt(replicas) if replicas > 1
             else np.zeros_like(m))
        return m, e

    u_w, u_e = _mean_err(_per_window(u))
    w2_w, w2_e = _mean_err(_per_window(stats.w2))
    rate = progress_rate(stats.gvt, t0=t0)
    r_w, r_e = _mean_err(rate.reshape(n_windows, replicas))
    spread_w = _per_window(to_numpy(stats.max_dev) + to_numpy(stats.min_dev))
    return {
        "u": u_w, "u_err": u_e,
        "w2": w2_w, "w2_err": w2_e,
        "w": np.sqrt(_per_window(stats.w2)).mean(axis=1),
        "wa": _mean_err(_per_window(stats.wa))[0],
        "spread": spread_w.mean(axis=1),
        "rate": r_w, "rate_err": r_e,
    }
