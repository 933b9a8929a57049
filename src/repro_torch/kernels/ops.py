"""Ring-level wrappers around the kernels (port of ``repro.kernels.ops``).

``ring_halo`` turns full periodic rings into the haloed layout
``pdes_step`` takes; ``step_haloed`` is one step on a haloed strip with a
per-row Δ column folded into the window base (the engine's ``pallas``
backend and each shard of the sharded one); ``step_ring`` is one
exact-GVT step on full rings;
``simulate`` runs ``horizon.run``'s threefry stream in K-fused chunks
through B3 (``pdes_multistep``), the words of each chunk made by the
generator kernel (``threefry.threefry_bits``).  The TPU tile helpers
``vmem_bytes`` and ``pick_block_b`` have no Hopper counterpart: the kernels
size their launches from the row length alone (``kernels/tiling.py``).
"""
from __future__ import annotations

import torch

from ..core import horizon
from ..core.horizon import PDESConfig, SimState
from .pdes_multistep import pdes_multistep, pdes_multistep_counter  # noqa: F401  (re-export)
from .pdes_step import pdes_step
from .threefry import threefry_bits


def ring_halo(tau: torch.Tensor) -> torch.Tensor:
    """(B, L) -> (B, L + 2) with periodic wrap columns."""
    return torch.cat([tau[:, -1:], tau, tau[:, :1]], dim=1)


def step_haloed(tau_h: torch.Tensor, bits: torch.Tensor, gvt: torch.Tensor,
                cfg: PDESConfig, delta_col=None):
    """One step of B2 on a haloed strip with window base ``gvt``.

    ``delta_col`` None applies ``cfg.delta``; a ``(B, 1)`` per-row Δ column
    folds into the base: the kernel's rule is ``tau <= delta + base``, so
    ``gvt + delta_col`` with a static delta of 0 applies each row's own
    window with the same fp32 add.  Returns ``(tau_next, moments)``.
    """
    if delta_col is None:
        base, delta = gvt, cfg.delta
    else:
        base, delta = gvt + delta_col, 0.0
    return pdes_step(tau_h, bits, base, n_v=cfg.n_v, delta=delta,
                     rd_mode=cfg.rd_mode, border_both=cfg.border_both)


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


def simulate(state: SimState, key: torch.Tensor, cfg: PDESConfig,
             n_steps: int, *, k_fuse: int = 16):
    """Kernel-path counterpart of ``horizon.run`` (exact algorithm).

    Runs ``n_steps`` in chunks of ``k_fuse`` steps and a remainder chunk:
    the chunk's words (``threefry_bits``, keyed as ``horizon.event_bits``,
    into one buffer reused by every chunk), K fused steps of B3, the
    per-step (utilization, w2, gvt) through ``horizon.stats_from_moments``,
    and one rebase per chunk with the Kahan offset.  Unlike ``repro``'s, it
    honours ``cfg.border_both``.  ``horizon.run`` rebases every step, so
    the two agree only to rounding.

    Returns ``(final SimState, dict of (n_steps, B) tensors: u, w2, gvt)``.
    """
    if n_steps < 1 or k_fuse < 1:
        raise ValueError(f"need n_steps >= 1 and k_fuse >= 1, got "
                         f"{n_steps} and {k_fuse}")
    tau, off, comp, step = state
    B, L = tau.shape
    key = key.to(tau.device)
    n_chunks, rem = divmod(n_steps, k_fuse)
    buf = torch.empty((min(k_fuse, n_steps), B, L, 2), dtype=torch.int32,
                      device=tau.device)
    outs = {"u": [], "w2": [], "gvt": []}
    for k in [k_fuse] * n_chunks + ([rem] if rem else []):
        bits = threefry_bits(key, step, k, (B, L), out=buf[:k])
        tau, moments = pdes_multistep(
            tau, bits, n_v=cfg.n_v, delta=cfg.delta, rd_mode=cfg.rd_mode,
            border_both=cfg.border_both)
        st = horizon.stats_from_moments(moments, off[None, :], L)
        outs["u"].append(st.utilization)
        outs["w2"].append(st.w2)
        outs["gvt"].append(st.gvt)
        # rebase once per chunk (fp32 hygiene; see horizon.SimState)
        shift = torch.amin(tau, dim=-1)
        tau = tau - shift[:, None]
        off, comp = horizon._kahan_add(off, comp, shift)
        step += k
    return SimState(tau, off, comp, step), \
        {name: torch.cat(xs, dim=0) for name, xs in outs.items()}
