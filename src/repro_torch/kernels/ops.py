"""Ring-level wrappers around the one-step kernel (port of ``repro.kernels.ops``).

``ring_halo`` turns full periodic rings into the haloed layout
``pdes_step`` takes; ``step_ring`` is one exact-GVT step on full rings.
``simulate`` (the threefry stream over ``pdes_multistep``) waits for the
port of ``jax.random``'s threefry (ROADMAP, queue A, A11).  The TPU tile
helpers ``vmem_bytes`` and ``pick_block_b`` have no Hopper counterpart:
the kernel runs one block per row whatever the row length.
"""
from __future__ import annotations

import torch

from ..core.horizon import PDESConfig
from .pdes_step import pdes_step


def ring_halo(tau: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, L + 2) with periodic wrap columns."""
    return torch.cat([tau[:, -1:], tau, tau[:, :1]], dim=1)


def step_ring(tau: torch.Tensor, bits: torch.Tensor, cfg: PDESConfig):
    """One fused step on full rings through the one-step kernel.

    Takes the exact GVT outside the kernel (one reduction), then does the
    fused sweep with ``cfg``'s static Δ.  Unlike ``repro``'s, it honours
    ``cfg.border_both``, as ``horizon.step_core`` does.  Returns
    ``(tau_next, moments)``.
    """
    gvt = torch.amin(tau, dim=-1, keepdim=True)
    return pdes_step(ring_halo(tau), bits, gvt, n_v=cfg.n_v, delta=cfg.delta,
                     rd_mode=cfg.rd_mode, border_both=cfg.border_both)
