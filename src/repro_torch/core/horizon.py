"""Virtual time horizon dynamics (port of ``repro.core.horizon``).

The update rules of Kolakowska, Novotny & Korniss, PRE 67, 046703: the
conservative causality rule, Eq. (1), the moving-window constraint
``tau_k <= delta + GVT``, Eq. (3), with ``GVT = min_k tau_k``, and the
random-deposition limit.  State is dense: ``tau`` is ``(B, L)`` for an
ensemble of ``B`` rings of ``L`` processing elements.

**The decode rule.**  The reference takes ``eta = -log(u + 2**-25)`` in
fp32, and fp32 ``log`` differs by an ulp between frameworks and devices.
The port fixes one rule, used by its PyTorch code and its CUDA kernel
alike::

    u   = fp32(w1 >> 8) * 2**-24           # exact
    x   = fp32(u + 2**-25)                 # one fp32 add, rounds for k >= 2**23
    eta = fp32(-log(fp64(x)))

The fp64 ``log`` is accurate enough that rounding to fp32 agrees across
libm implementations on (almost) every input; the parity tests check all
``2**24`` inputs.  :func:`eta_override` lets tests inject another η table
(the JAX reference's) into the plain decode, so trajectories can be held
against ``repro`` bit for bit.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, NamedTuple

import torch

# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PDESConfig:
    """Static parameters of one PDES ensemble (see ``repro.core.horizon``).

    Attributes:
      L: processing elements on the ring.
      n_v: lattice sites per PE (``N_V``); sites 0 and ``n_v - 1`` are the
        borders.
      delta: moving-window width, ``inf`` disables the constraint.
      rd_mode: drop the causality rule (random-deposition limit).
      border_both: a border pick checks both neighbours.
      dtype: dtype of the virtual times.
    """

    L: int
    n_v: int = 1
    delta: float = math.inf
    rd_mode: bool = False
    border_both: bool = False
    dtype: Any = torch.float32

    def __post_init__(self):
        if self.L < 2:
            raise ValueError(f"need at least 2 PEs, got L={self.L}")
        if self.n_v < 1:
            raise ValueError(f"need at least one site per PE, got n_v={self.n_v}")
        if not (self.delta >= 0):
            raise ValueError(f"delta must be >= 0 (or inf), got {self.delta}")


class StepStats(NamedTuple):
    """Per-step per-trial observables (each ``(B,)`` or ``(T, B)``)."""

    utilization: torch.Tensor
    w2: torch.Tensor
    wa: torch.Tensor
    gvt: torch.Tensor
    mean_tau: torch.Tensor
    max_dev: torch.Tensor
    min_dev: torch.Tensor


class SimState(NamedTuple):
    """Engine state: rebased ``tau`` plus the Kahan-compensated offset.

    ``step`` is a Python int: the engine's chunk loop runs on the host.
    """

    tau: torch.Tensor          # (B, L) rebased virtual times, min == 0
    offset: torch.Tensor       # (B,) accumulated rebasing offset (Kahan sum)
    offset_comp: torch.Tensor  # (B,) Kahan compensation term
    step: int                  # parallel step index t


# ---------------------------------------------------------------------------
# event decode
# ---------------------------------------------------------------------------

_ETA_TABLE: torch.Tensor | None = None


@contextlib.contextmanager
def eta_override(table):
    """Test-only: make the plain decode read η from ``table[w1 >> 8]``.

    ``table`` holds ``2**24`` float32 values (numpy or tensor).  The CUDA
    kernel wrapper refuses to launch while an override is active, since the
    kernel cannot honour it.
    """
    global _ETA_TABLE
    t = torch.as_tensor(table)
    if t.shape != (1 << 24,) or t.dtype != torch.float32:
        raise ValueError(f"eta table must be float32 of shape (2**24,), "
                         f"got {tuple(t.shape)} {t.dtype}")
    prev, _ETA_TABLE = _ETA_TABLE, t
    try:
        yield
    finally:
        _ETA_TABLE = prev


def eta_override_active() -> bool:
    """True inside :func:`eta_override`."""
    return _ETA_TABLE is not None


def decode_eta(w1: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """η ~ Exp(1) from word 1 by the port's decode rule (module docstring)."""
    k = w1 >> 8
    if _ETA_TABLE is not None:
        return _ETA_TABLE.to(k.device)[k].to(dtype)
    u = k.to(torch.float32) * 2.0**-24
    x = u + 2.0**-25
    return (-torch.log(x.to(torch.float64))).to(dtype)


def decode_words(w0: torch.Tensor, w1: torch.Tensor, n_v: int, dtype):
    """Event decode -> (is_left, is_right, eta): site = w0 mod n_v."""
    site = torch.remainder(w0, n_v)
    is_left = site == 0
    is_right = site == (n_v - 1)
    return is_left, is_right, decode_eta(w1, dtype)


def decode_events(bits: torch.Tensor, cfg: PDESConfig):
    """bits ``(..., 2)`` -> (is_left, is_right, eta)."""
    return decode_words(bits[..., 0], bits[..., 1], cfg.n_v, cfg.dtype)


# ---------------------------------------------------------------------------
# the update core
# ---------------------------------------------------------------------------


def conservative_update(tau, left, right, is_left, is_right, eta, gvt, *,
                        delta, rd_mode: bool = False,
                        border_both: bool = False):
    """Causality rule Eq. (1) + window rule Eq. (3) + update.

    ``delta`` is a static float (``inf`` short-circuits the window rule) or
    a tensor broadcastable against ``tau``, e.g. a ``(B, 1)`` column whose
    ``inf`` rows are unconstrained.  Returns ``(tau_next, update)``.
    """
    if rd_mode:
        causal_ok = torch.ones_like(tau, dtype=torch.bool)
    elif border_both:
        ok = (tau <= left) & (tau <= right)
        causal_ok = torch.where(is_left | is_right, ok, True)
    else:
        ok_left = torch.where(is_left, tau <= left, True)
        ok_right = torch.where(is_right, tau <= right, True)
        causal_ok = ok_left & ok_right
    if isinstance(delta, (int, float)) and math.isinf(delta):
        window_ok = torch.ones_like(tau, dtype=torch.bool)
    else:
        window_ok = tau <= delta + gvt
    update = causal_ok & window_ok
    return tau + torch.where(update, eta, 0.0), update


def step_core(tau, is_left, is_right, eta, cfg: PDESConfig, *,
              gvt_for_window=None, delta_override=None):
    """One update attempt on every PE of every ring.

    ``gvt_for_window`` replaces the exact minimum in the window rule (the
    stale window); ``delta_override`` is a ``(B, 1)`` per-row Δ column.
    Returns ``(tau_next, update, gvt)`` with ``gvt`` the exact minimum.
    """
    left = torch.roll(tau, 1, dims=-1)
    right = torch.roll(tau, -1, dims=-1)
    gvt = torch.amin(tau, dim=-1, keepdim=True)
    base = gvt if gvt_for_window is None else gvt_for_window
    delta = cfg.delta if delta_override is None else delta_override
    tau_next, update = conservative_update(
        tau, left, right, is_left, is_right, eta, base,
        delta=delta, rd_mode=cfg.rd_mode, border_both=cfg.border_both)
    return tau_next, update, gvt[..., 0]


def measure(tau, update, offset) -> StepStats:
    """Paper observables from one post-update state (Eqs. 4-5)."""
    mean = tau.mean(dim=-1, keepdim=True)
    dev = tau - mean
    return StepStats(
        utilization=update.to(tau.dtype).mean(dim=-1),
        w2=(dev * dev).mean(dim=-1),
        wa=dev.abs().mean(dim=-1),
        gvt=tau.amin(dim=-1) + offset,
        mean_tau=mean[..., 0] + offset,
        max_dev=dev.amax(dim=-1),
        min_dev=-dev.amin(dim=-1),
    )


#: Key order of ``ring_moments`` output, and of the kernel's moment planes.
MOMENT_KEYS = ("ucount", "min", "max", "sum", "sumsq", "sumabs")


def ring_moments(tau, update) -> dict:
    """Per-ring partial reductions of one post-update state."""
    s = tau.sum(dim=-1)
    mean = s / tau.shape[-1]
    return dict(
        ucount=update.to(tau.dtype).sum(dim=-1),
        min=tau.amin(dim=-1),
        max=tau.amax(dim=-1),
        sum=s,
        sumsq=(tau * tau).sum(dim=-1),
        sumabs=(tau - mean[..., None]).abs().sum(dim=-1),
    )


def stats_from_moments(moments: dict, offset, L: int) -> StepStats:
    """Assemble ``StepStats`` from ``ring_moments`` output.

    Divides by ``L`` as the reference does once XLA has compiled it: as a
    multiply by the fp32 reciprocal, so utilization matches bit for bit.
    """
    inv_l = 1.0 / L
    mean = moments["sum"] * inv_l
    return StepStats(
        utilization=moments["ucount"] * inv_l,
        w2=moments["sumsq"] * inv_l - mean * mean,
        wa=moments["sumabs"] * inv_l,
        gvt=moments["min"] + offset,
        mean_tau=mean + offset,
        max_dev=moments["max"] - mean,
        min_dev=mean - moments["min"],
    )


def init_state(cfg: PDESConfig, n_trials: int, device) -> SimState:
    """Fully synchronized initial condition (all local clocks equal)."""
    z = torch.zeros((n_trials,), dtype=cfg.dtype, device=device)
    return SimState(
        tau=torch.zeros((n_trials, cfg.L), dtype=cfg.dtype, device=device),
        offset=z, offset_comp=z.clone(), step=0)


def _kahan_add(total, comp, x):
    y = x - comp
    t = total + y
    comp = (t - total) - y
    return t, comp
