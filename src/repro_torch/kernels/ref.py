"""Plain PyTorch oracles for the CUDA kernels (port of ``repro.kernels.ref``).

``pdes_step_ref`` (one step on a haloed chunk), ``pdes_multistep_ref`` (K
exact-GVT steps on bits read from memory) and
``pdes_multistep_counter_ref`` (K exact-GVT steps with the counter stream)
repeat the kernels' arithmetic with the shared update core of
``core.horizon``; the kernel wrappers run them for CPU tensors, and
``chip_smoke.py`` holds each kernel against its oracle on the GPU.
"""
from __future__ import annotations

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
                               border_both: bool = False):
    """K exact-GVT steps with the counter event stream, in plain PyTorch.

    Arguments as :func:`repro_torch.kernels.pdes_multistep.
    pdes_multistep_counter`.  Returns ``(tau (B, L), moments)`` with each
    moment a ``(K, B)`` tensor, in ``MOMENT_KEYS`` order.
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
    return tau, _stack_planes(planes)
