"""Carry simulation state between numpy (e.g. a JAX ``SimState``) and the port.

The system runs no model, so its counterpart of converting weights is
converting state: a burned-in ensemble from the JAX reference (as numpy
arrays) continues in the port, and back, bit for bit.  A threefry key
crosses the same way (``jax.random.key_data`` as numpy in, the port's key
out), so the port can continue a JAX key's stream.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.events import MASK32
from .core.horizon import SimState
from .device import resolve_device


def state_from_numpy(tau, offset, offset_comp, step, device=None) -> SimState:
    """A port ``SimState`` on ``device`` (``None`` = GPU) from numpy arrays.

    ``tau`` is ``(B, L)``, ``offset``/``offset_comp`` ``(B,)``, all float32;
    ``step`` is the parallel step index.
    """
    dev = resolve_device(device)
    tau = np.array(tau, np.float32)
    offset = np.array(offset, np.float32)
    offset_comp = np.array(offset_comp, np.float32)
    if tau.ndim != 2 or offset.shape != (tau.shape[0],) or \
            offset_comp.shape != offset.shape:
        raise ValueError(f"need tau (B, L) and offsets (B,), got "
                         f"{tau.shape}, {offset.shape}, {offset_comp.shape}")
    return SimState(*(torch.as_tensor(a, device=dev)
                      for a in (tau, offset, offset_comp)), int(step))


def state_to_numpy(state: SimState):
    """``(tau, offset, offset_comp, step)`` of a port state, as numpy."""
    return (*(state_field.detach().cpu().numpy() for state_field in
              (state.tau, state.offset, state.offset_comp)), int(state.step))


def key_from_numpy(data, device=None) -> torch.Tensor:
    """The port's threefry key (``core.prng``) on ``device`` (``None`` = GPU)
    from a JAX key's ``key_data``: two uint32 words."""
    words = np.asarray(data)
    if words.shape != (2,) or words.dtype.kind not in "iu":
        raise ValueError(f"key data must be two integer words, got "
                         f"{words.shape} {words.dtype}")
    return torch.as_tensor(words.astype(np.int64) & MASK32,
                           device=resolve_device(device))
