"""Counter-based event streams (port of ``repro.core.events``).

``counter_words`` is a murmur3-finalizer hash over (seed, step, trial, pe):
every consumer — the plain PyTorch path here and the CUDA kernel, which
carries a native uint32 copy of the same hash — derives the event bits of
any coordinate locally, so all backends see one stream.

PyTorch on the CPU has no ``>>`` for uint32, so the words are carried in
int64 tensors holding values in ``[0, 2**32)``.  Every multiply is masked
back to 32 bits; the product of two such values can exceed ``2**63`` and
relies on int64 multiplication wrapping modulo ``2**64``, whose low 32 bits
are then exact (tests/test_torch_events.py checks this).  Negative inputs
(the service's pad trial indices ``-1 - r``) wrap modulo ``2**32``, as the
JAX reference's ``astype(uint32)`` does.
"""
from __future__ import annotations

import torch

MASK32 = 0xFFFFFFFF

_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_STEP_C = 0x27D4EB2F
_TRIAL_C = 0x165667B1
_PE_C = 0xD3A2646C
_W0_C = 0x68E31DA4
_W1_C = 0xB5297A4D


def as_u32(x, device=None) -> torch.Tensor:
    """Integers (Python, numpy or tensor) -> int64 tensor of uint32 values."""
    t = torch.as_tensor(x, device=device)
    if t.dtype.is_floating_point:
        raise TypeError(f"expected integers, got {t.dtype}")
    return t.to(torch.int64) & MASK32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on int64-carried uint32 values."""
    h = h ^ (h >> 16)
    h = (h * _C1) & MASK32
    h = h ^ (h >> 13)
    h = (h * _C2) & MASK32
    h = h ^ (h >> 16)
    return h


def counter_words(seed, step, trial_idx, pe_idx):
    """The two event words for global coordinates, unstacked.

    Inputs are int64 tensors of uint32 values (see :func:`as_u32`) that
    broadcast against each other; outputs are the same.
    """
    h = _mix(seed ^ _GOLDEN)
    h = _mix(h ^ ((step * _STEP_C) & MASK32))
    h = _mix(h ^ ((trial_idx * _TRIAL_C) & MASK32))
    h = _mix(h ^ ((pe_idx * _PE_C) & MASK32))
    w0 = _mix(h ^ _W0_C)
    w1 = _mix(h ^ _W1_C)
    return w0, w1


def counter_bits(seed, step, trial_idx, pe_idx) -> torch.Tensor:
    """Event bits for global coordinates; shape broadcast(trial, pe) + (2,).

    Word 0 picks the site, word 1 gives the increment η (``horizon``).
    Values are uint32 carried in int64.
    """
    t = torch.as_tensor(trial_idx)
    dev = t.device
    w0, w1 = counter_words(as_u32(seed, dev), as_u32(step, dev),
                           as_u32(t, dev), as_u32(pe_idx, dev))
    return torch.stack(torch.broadcast_tensors(w0, w1), dim=-1)


def counter_bits_block(seed, step, b0, l0, n_b: int, n_l: int,
                       device=None) -> torch.Tensor:
    """Bits for the block [b0, b0+n_b) x [l0, l0+n_l) -> (n_b, n_l, 2).

    ``b0`` is a scalar (rows consume ``b0 + r``) or an ``(n_b,)`` vector of
    per-row global trial indices — the coalesced-batch form of the
    service.  A vector ``b0 = c + arange(n_b)`` equals the scalar form.
    """
    if isinstance(b0, torch.Tensor) and device is None:
        device = b0.device
    b = torch.as_tensor(b0, device=device)
    if b.ndim == 1:
        bi = b.to(torch.int64)[:, None]
    else:
        bi = b.to(torch.int64) + torch.arange(n_b, device=device)[:, None]
    li = int(l0) + torch.arange(n_l, device=device)[None, :]
    return counter_bits(seed, step, bi, li)
