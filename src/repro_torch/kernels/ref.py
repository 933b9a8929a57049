"""Plain PyTorch oracles for the CUDA kernels (port of ``repro.kernels.ref``).

``pdes_step_ref`` (one step on a haloed chunk), ``pdes_multistep_ref`` (K
exact-GVT steps on bits read from memory) and
``pdes_multistep_counter_ref`` (K exact-GVT steps with the counter stream)
repeat the kernels' arithmetic with the shared update core of
``core.horizon``; the kernel wrappers run them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its oracle on the GPU.
"""
from __future__ import annotations

import math
from decimal import Decimal, localcontext

import numpy as np
import torch

from ..core.events import MASK32, as_u32, counter_words
from ..core.horizon import conservative_update, decode_words, ring_moments


def decode(bits: torch.Tensor, n_v: int, dtype=torch.float32):
    """bits ``(..., 2)`` -> (is_left, is_right, eta).  Mirrors the kernels."""
    return decode_words(bits[..., 0], bits[..., 1], n_v, dtype)


def pdes_step_ref(tau_haloed, bits, gvt, *, n_v: int, delta,
                  rd_mode: bool = False, border_both: bool = False):
    """Oracle for :func:`repro_torch.kernels.pdes_step.pdes_step`.

    Args:
      tau_haloed: (B, Lc + 2) with halo columns at ``[:, 0]`` and ``[:, -1]``.
      bits: (B, Lc, 2) event words for the interior.
      gvt: (B, 1) window base (exact or stale global virtual time).
      n_v, delta, rd_mode, border_both: PDES parameters (delta may be inf).

    Returns:
      (tau_next (B, Lc), update (B, Lc) bool, moments dict of (B,) tensors
      in ``MOMENT_KEYS`` order).
    """
    tau = tau_haloed[:, 1:-1]
    is_left, is_right, eta = decode(bits, n_v, tau_haloed.dtype)
    tau_next, update = conservative_update(
        tau, tau_haloed[:, :-2], tau_haloed[:, 2:], is_left, is_right, eta,
        gvt, delta=delta, rd_mode=rd_mode, border_both=border_both)
    return tau_next, update, ring_moments(tau_next, update)


def ctr_values(ctr) -> list[int]:
    """``[seed, step0, b0, l0]`` of a ``(1, 4)`` counter block, as uint32 ints."""
    t = torch.as_tensor(ctr)
    if t.shape != (1, 4) or t.dtype.is_floating_point:
        raise ValueError(f"ctr must be a (1, 4) integer tensor, got "
                         f"{tuple(t.shape)} {t.dtype}")
    return [v & 0xFFFFFFFF for v in t.reshape(4).to(torch.int64).tolist()]


def _multistep_body(n_v, delta, rd_mode, border_both, dtype):
    def body(tau, w0, w1):
        is_left, is_right, eta = decode_words(w0, w1, n_v, dtype)
        left = torch.roll(tau, 1, dims=-1)
        right = torch.roll(tau, -1, dims=-1)
        gvt = torch.amin(tau, dim=-1, keepdim=True)   # exact: full ring
        tau_next, update = conservative_update(
            tau, left, right, is_left, is_right, eta, gvt,
            delta=delta, rd_mode=rd_mode, border_both=border_both)
        return tau_next, ring_moments(tau_next, update)

    return body


def _stack_planes(planes: list) -> dict:
    return {key: torch.stack([m[key] for m in planes]) for key in planes[0]}


def pdes_multistep_ref(tau, bits, *, n_v: int, delta, rd_mode: bool = False,
                       border_both: bool = False):
    """Oracle for :func:`repro_torch.kernels.pdes_multistep.pdes_multistep`.

    Args:
      tau: (B, L) full rings (periodic).
      bits: (K, B, L, 2) event words of the K steps, int64-carried uint32 or
        int32 uint32 bit patterns (as ``threefry.threefry_bits`` makes them).
      n_v, delta, rd_mode, border_both: PDES parameters (static ``delta``;
        ``inf`` turns the window rule off).

    Returns:
      (tau (B, L), dict of six (K, B) moments in ``MOMENT_KEYS`` order),
      each step's moments measured after its update.
    """
    body = _multistep_body(n_v, delta, rd_mode, border_both, tau.dtype)
    planes = []
    for words in bits.unbind(0):
        words = words.to(torch.int64) & MASK32
        tau, m = body(tau, words[..., 0], words[..., 1])
        planes.append(m)
    return tau, _stack_planes(planes)


def pdes_multistep_counter_ref(tau, ctr, delta_col=None, trial_col=None, *,
                               k_steps: int, n_v: int, delta: float,
                               rd_mode: bool = False,
                               border_both: bool = False,
                               rebase: bool = False):
    """K exact-GVT steps with the counter event stream, in plain PyTorch.

    Arguments as :func:`repro_torch.kernels.pdes_multistep.
    pdes_multistep_counter`.  Returns ``(tau (B, L), moments)`` with each
    moment a ``(K, B)`` tensor, in ``MOMENT_KEYS`` order; with ``rebase``,
    tau less its ring minimum (the engine's rebase).
    """
    B, L = tau.shape
    dev = tau.device
    seed, step0, b0, l0 = (as_u32(v, dev) for v in ctr_values(ctr))
    if trial_col is None:
        bi = (b0 + torch.arange(B, device=dev))[:, None]
    else:
        bi = as_u32(trial_col.reshape(B, 1), dev)
    li = (l0 + torch.arange(L, device=dev))[None, :]
    d = delta if delta_col is None else delta_col.to(tau.dtype)
    body = _multistep_body(n_v, d, rd_mode, border_both, tau.dtype)
    planes = []
    for k in range(k_steps):
        w0, w1 = counter_words(seed, (step0 + k) & 0xFFFFFFFF, bi, li)
        tau, m = body(tau, w0, w1)
        planes.append(m)
    if rebase:
        tau = tau - torch.amin(tau, dim=-1, keepdim=True)
    return tau, _stack_planes(planes)


# --- The kernels' exact shortcuts, in Python: what the CPU tests hold
# --- against `%` and against the plain decode rule.

def site_divisor(n_v: int) -> tuple[int, int, int]:
    """``(m, sh1, sh2)``: the multiply-high reciprocal of ``n_v`` that the
    kernels compute once per block (``csrc/pdes_common.cuh::site_divisor``;
    Granlund & Montgomery 1994, Fig. 4.1), for ``1 <= n_v < 2**32``."""
    if not 1 <= n_v < 1 << 32:
        raise ValueError(f"n_v must be in [1, 2**32), got {n_v}")
    lg = (n_v - 1).bit_length()                 # ceil(log2 n_v)
    m = ((((1 << lg) - n_v) << 32) // n_v + 1) & 0xFFFFFFFF
    return m, min(lg, 1), max(lg - 1, 0)


def site_of(w0, n_v: int):
    """``w0 % n_v`` as the kernels take it, without a division.

    ``w0`` is an int or a numpy array of uint32 words; returns the same."""
    m, sh1, sh2 = site_divisor(n_v)
    w = np.asarray(w0, dtype=np.uint64)
    hi = (w * np.uint64(m)) >> np.uint64(32)
    q = (hi + ((w - hi) >> np.uint64(sh1))) >> np.uint64(sh2)
    site = (w - q * np.uint64(n_v)).astype(np.uint64)
    return int(site) if np.ndim(w0) == 0 else site


#: Buckets of the kernels' log table: the top 7 bits of a float's mantissa.
LOG_TABLE_BITS = 7


def neg_log_table() -> list[tuple[float, float]]:
    """``(c_j, -ln c_j)`` for the 128 buckets of the kernels' decode.

    Bucket ``j`` holds the mantissas ``m`` in ``[1 + j/128, 1 + (j+1)/128)``;
    the kernels reduce ``m`` to ``z = m`` (``j < 64``) or ``z = m / 2``
    (``j >= 64``, exponent + 1), so ``z`` lies in ``[0.75, 1.5)``.  ``c_j``
    is ``1 / z`` at the bucket's centre rounded to a multiple of ``2**-9``
    (so ``z * c_j`` is exact in fp64), and exactly 1 for the two buckets
    around ``z = 1``; ``-ln c_j`` is rounded once from 40 digits.
    ``csrc/pdes_common.cuh`` carries these values as literals.
    """
    n = 1 << LOG_TABLE_BITS
    out = []
    with localcontext() as ctx:
        ctx.prec = 40
        for j in range(n):
            if j in (0, n - 1):
                out.append((1.0, 0.0))
                continue
            zc = (1.0 + (j + 0.5) / n) / (2.0 if j >= n // 2 else 1.0)
            c = round(512.0 / zc) / 512.0
            out.append((c, float(-Decimal(c).ln())))
    return out


def neg_log_emulated(x):
    """``fp32(-ln(x))`` for fp32 ``x`` in ``[2**-25, 1]`` by the kernels'
    table-driven fp64 algorithm (``csrc/pdes_common.cuh::neg_log_rn``), in
    numpy.

    numpy has no fused multiply-add, so its intermediate roundings differ
    from the card's by an fp64 ulp here and there; the tests hold this to
    the plain decode rule on all ``2**24`` inputs, as ``chip_smoke.py``
    holds the card's.
    """
    x = np.asarray(x, dtype=np.float32)
    table = np.array(neg_log_table())
    bits = x.view(np.uint32)
    j = (bits >> 16) & 127
    # 2**e' with e' = e, or e + 1 where the mantissa's top bit is set
    p2 = (bits + np.uint32(0x400000)) & np.uint32(0xFF800000)
    e = (p2 >> 23).astype(np.int64) - 127
    z = (bits - p2 + np.uint32(0x3F800000)).view(np.float32).astype(np.float64)
    c, lc = table[j, 0], table[j, 1]
    r = z * c - 1.0
    q = r * (1.0 / 7.0) - 1.0 / 6.0
    for coef in (1.0 / 5.0, -1.0 / 4.0, 1.0 / 3.0, -1.0 / 2.0):
        q = q * r + coef
    p = (r * r) * q + r
    return (-(e * math.log(2.0) + (lc + p))).astype(np.float32)
