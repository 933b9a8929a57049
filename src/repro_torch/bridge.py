"""Carry simulation state between numpy (e.g. a JAX ``SimState``) and the port.

The system runs no model, so its counterpart of converting weights is
converting state: a burned-in ensemble from the JAX reference (as numpy
arrays) continues in the port, and back, bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

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
