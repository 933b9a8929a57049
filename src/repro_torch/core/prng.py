"""The threefry stream of ``jax.random``, in plain PyTorch.

``repro.core.horizon`` draws its events from JAX's default generator:
``threefry2x32`` (Salmon et al., "Parallel random numbers: as easy as 1, 2,
3", SC'11) in JAX's *partitionable* layout.  This module reproduces it bit
for bit, so that a port trajectory keyed on a JAX seed meets the same
events:

* ``key(s)`` has key data ``(0, s mod 2**32)``;
* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d mod 2**32))``, the two
  output words being the new key;
* ``split(k)`` gives the keys ``threefry2x32(k, (0, i))`` for ``i = 0, 1``;
* ``random_bits(k, shape)``: element ``n`` of the flattened ``shape`` is
  ``x0 ^ x1`` of ``threefry2x32(k, (n >> 32, n & 0xFFFFFFFF))``.

A key is a ``(2,)`` int64 tensor of uint32 values on an explicit device.
Words are uint32 values carried in int64 tensors, as in ``core.events``:
every add is masked back to 32 bits and a rotation is
``((x << r) | (x >> (32 - r))) & MASK32``.

On the GPU the bits of a whole chunk of steps come from the generator
kernel (``kernels/threefry.py``); this module is its plain version.
"""
from __future__ import annotations

import math

import torch

from .events import MASK32, as_u32

#: Rotation constants of threefry2x32, alternating by group of four rounds.
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: The key schedule's parity constant.
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry2x32 block cipher on int64-carried uint32 values.

    All four inputs broadcast against each other (tensors from
    :func:`repro_torch.core.events.as_u32`); returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK32
    x1 = (x1 + ks[1]) & MASK32
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & MASK32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & MASK32
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & MASK32
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """The key of ``jax.random.key(seed)``: data ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK32], dtype=torch.int64,
                        device=device)


def key_data(k: torch.Tensor) -> torch.Tensor:
    """The key's two uint32 words, as ``jax.random.key_data`` gives them."""
    if tuple(k.shape) != (2,) or k.dtype != torch.int64:
        raise ValueError(f"a key is a (2,) int64 tensor, got "
                         f"{tuple(k.shape)} {k.dtype}")
    return k


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: ``threefry2x32(k, (0, data mod 2**32))``."""
    k = key_data(k)
    d = as_u32(data, k.device)
    x0, x1 = threefry2x32(k[0], k[1], torch.zeros_like(d), d)
    return torch.stack([x0, x1])


def split(k: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.split(k)`` (two keys): ``threefry2x32(k, (0, i))``."""
    k = key_data(k)
    ctr = torch.arange(2, dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[0], k[1], torch.zeros_like(ctr), ctr)
    return torch.stack([x0[0], x1[0]]), torch.stack([x0[1], x1[1]])


def random_bits(k: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` as int64-carried uint32 values.

    Element ``n`` of the flattened ``shape`` is ``x0 ^ x1`` of
    ``threefry2x32(k, (n >> 32, n & 0xFFFFFFFF))``.
    """
    k = key_data(k)
    shape = tuple(int(s) for s in shape)
    n = torch.arange(math.prod(shape), dtype=torch.int64, device=k.device)
    x0, x1 = threefry2x32(k[0], k[1], n >> 32, n & MASK32)
    return (x0 ^ x1).reshape(shape)
