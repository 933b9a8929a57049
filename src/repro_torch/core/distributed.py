"""Sharded PDES runtime on ``torch.distributed`` (port of ``repro.core.distributed``).

The paper's algorithm across processes: the ensemble's rows shard over
the mesh's ``ens_axes``, the ring of L PEs over its ``ring_axis``, one
rank a ``(B_l, L_l)`` block (``core/mesh.py``).  Two modes, both
conservative:

* ``exact`` — every step, a one-column halo exchange each way along the
  ring (``batch_isend_irecv``, JAX's ``ppermute``) and, when the window is
  finite, an ``all_reduce(MIN)`` of the row minima for GVT: Eq. (1) and
  Eq. (3) verbatim.
* ``commavoid`` — per chunk of K steps, one K-wide halo each way and one
  GVT all-reduce; each rank recomputes its neighbours' K boundary PEs from
  the counter stream, and the window uses the chunk-start (stale) GVT,
  a subset of the exact window.

Per chunk, both modes combine the statistics in two all-reduces along the
ring: one ``SUM`` of the stacked (ucount, sum, sumsq) and one ``MIN`` of
the stacked (min, −max, rebase shift) — JAX's ``psum``, ``pmin``,
``pmax`` and the shift's ``pmin``, the last three in one message, since
negation is exact.  Nothing is gathered per step.

**SPMD entry points.**  As a JAX program on a mesh, every rank calls with
the same global tensors and gets the same global results: each slices its
block, runs its chunks and all-gathers τ, the Kahan pair and the stats
once, at the end of the call.  Everything above the engine keeps its
signatures.

**The shard-local step** is the one-step kernel B2
(``kernels/pdes_step.py``) on the haloed strip: on a CUDA tensor the
hand-written kernel, on a CPU tensor its plain version, the ``horizon``
update core.  The per-row Δ column folds into the window base
(``kernels.ops.step_haloed``, as in the engine's ``pallas`` branch).  Commavoid's K steps on the edge-padded strip
``(B_l, L_l + 2K + 2)`` are three launches a step — the left K columns,
the interior L_l and the right K columns — the same update as one launch
over the strip, with the interior's moments straight from the middle one.

With the same η, τ, the Kahan pair, ``u`` and ``gvt`` equal ``repro``'s
bit for bit; ``w2``, ``mean_tau``, ``max_dev`` and ``min_dev`` agree to
rounding (the sums' order differs).  ``repro``'s ``lower_sharded`` (an
XLA lowering for its dry-run tools) has no counterpart yet.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.distributed as tdist

from ..device import resolve_device
from . import horizon
from .events import counter_bits, counter_bits_block
from .horizon import PDESConfig
from .mesh import ProcessMesh


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """How the PDES ensemble maps onto the process mesh."""

    ens_axes: tuple[str, ...] = ("data",)
    ring_axis: str = "model"
    mode: str = "exact"          # "exact" | "commavoid"
    k_chunk: int = 16            # steps per chunk (halo width in commavoid)

    def __post_init__(self):
        if self.mode not in ("exact", "commavoid"):
            raise ValueError(self.mode)
        if self.k_chunk < 1:
            raise ValueError("k_chunk must be >= 1")


# ---------------------------------------------------------------------------
# shard-local step math
# ---------------------------------------------------------------------------


def _update_haloed(tau_h, bits, gvt, cfg: PDESConfig, delta=None):
    """Plain step on a haloed strip: tau_h (B, W + 2) -> (tau_next, update).

    The ``horizon`` update core, as ``run_reference`` takes it; ``delta``
    is None (static ``cfg.delta``) or a ``(B, 1)`` per-row window column.
    """
    tau = tau_h[:, 1:-1]
    is_left, is_right, eta = horizon.decode_events(bits, cfg)
    return horizon.conservative_update(
        tau, tau_h[:, :-2], tau_h[:, 2:], is_left, is_right, eta, gvt,
        delta=cfg.delta if delta is None else delta,
        rd_mode=cfg.rd_mode, border_both=cfg.border_both)


def _local_stats(moments: dict) -> tuple:
    """Shard-local partials (ucount, sum, sumsq, min, max) of one step's
    moments: additive across ring shards except min and max."""
    return tuple(moments[k] for k in ("ucount", "sum", "sumsq", "min", "max"))


#: Keys of the per-step stats dict every sharded runner returns.  ``wa`` is
#: absent by design: it needs the ring mean before the deviation reduction,
#: a second all-reduce per step (the engine reports it as NaN).
STAT_KEYS = ("u", "w2", "gvt", "mean_tau", "max_dev", "min_dev")


# ---------------------------------------------------------------------------
# sharded runner
# ---------------------------------------------------------------------------


def _multi_axis_index(mesh: ProcessMesh, axes: Sequence[str],
                      coords: dict) -> int:
    """Row-major index of ``coords`` over ``axes``."""
    idx = 0
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
    return idx


class _Ring:
    """This rank's place on the ring axis: group, size, neighbours."""

    def __init__(self, mesh: ProcessMesh, axis: str):
        self.group = mesh.group(axis)
        self.n = mesh.shape[axis]
        self.i = mesh.coords[axis]
        at = dict(mesh.coords)
        self.left = mesh.rank_of({**at, axis: (self.i - 1) % self.n})
        self.right = mesh.rank_of({**at, axis: (self.i + 1) % self.n})

    def halo(self, tau, w: int):
        """(left neighbour's last ``w`` columns, right's first ``w``).

        JAX's two ``ppermute``s.  On a ring of one the halo is the shard's
        own wrap (a rank cannot send to itself); on a ring of two both
        neighbours are one rank and its two messages match in order.
        """
        if self.n == 1:
            return tau[:, -w:], tau[:, :w]
        to_right = tau[:, -w:].contiguous()
        to_left = tau[:, :w].contiguous()
        lhalo, rhalo = torch.empty_like(to_right), torch.empty_like(to_left)
        ops = [tdist.P2POp(tdist.isend, to_right, self.right, self.group, 0),
               tdist.P2POp(tdist.isend, to_left, self.left, self.group, 1),
               tdist.P2POp(tdist.irecv, lhalo, self.left, self.group, 0),
               tdist.P2POp(tdist.irecv, rhalo, self.right, self.group, 1)]
        for req in tdist.batch_isend_irecv(ops):
            req.wait()
        return lhalo, rhalo

    def all_reduce(self, x, op):
        tdist.all_reduce(x, op=op, group=self.group)
        return x


def _shard_body(tau, off, comp, seed: int, step_base: int, b0,
                delta_col, *, ring: _Ring, cfg: PDESConfig, dist_cfg,
                n_steps: int):
    """The chunk loop of one rank on its ``(B_l, L_l)`` block.

    ``b0`` is the trial index of the block's row 0 (an int) or a ``(B_l,)``
    tensor of per-row trial indices; ``delta_col`` None or ``(B_l, 1)``.
    Returns the block's ``(tau, off, comp)`` and a ``(6, T, B_l)`` stack of
    :data:`STAT_KEYS` with ``T`` whole chunks of steps.
    """
    from ..kernels.ops import step_haloed     # kernels import core
    dev = tau.device
    B_l, L_l = tau.shape
    L_total = cfg.L
    l0 = ring.i * L_l
    K = dist_cfg.k_chunk
    n_chunks = -(-n_steps // K)
    # a sweep's Δ column may mix finite and inf rows, so its window base is
    # always needed; inf rows still satisfy tau <= inf + gvt
    finite_window = delta_col is not None or not math.isinf(cfg.delta)

    def gvt_of(tau):
        m = torch.amin(tau, dim=-1, keepdim=True)
        if not finite_window:
            return torch.zeros_like(m)            # unused by the kernel
        return ring.all_reduce(m, tdist.ReduceOp.MIN)

    def exact_chunk(tau, step0):
        parts = []
        for s in range(K):
            bits = counter_bits_block(seed, step0 + s, b0, l0, B_l, L_l,
                                      device=dev)
            lcol, rcol = ring.halo(tau, 1)
            gvt = gvt_of(tau)
            tau_h = torch.cat([lcol, tau, rcol], dim=1)
            tau, m = step_haloed(tau_h, bits, gvt, cfg, delta_col)
            parts.append(_local_stats(m))
        return tau, parts

    def commavoid_chunk(tau, step0):
        # one K-wide halo exchange + one stale GVT per chunk
        lhalo, rhalo = ring.halo(tau, K)
        tau_e = torch.cat([lhalo, tau, rhalo], dim=1)   # (B_l, L_l + 2K)
        gvt = gvt_of(tau)
        rows = (b0 if isinstance(b0, torch.Tensor)
                else b0 + torch.arange(B_l, device=dev))[:, None]
        pe_idx = torch.remainder(
            l0 - K + torch.arange(L_l + 2 * K, device=dev), L_total)[None, :]
        parts = []
        for s in range(K):
            bits = counter_bits(seed, step0 + s, rows, pe_idx)
            # non-periodic edges: edge columns turn garbage one cell a step;
            # the interior [K, K + L_l) stays exact for all s < K
            tau_pad = torch.cat([tau_e[:, :1], tau_e, tau_e[:, -1:]], dim=1)
            pieces = []
            for lo, hi in ((0, K), (K, K + L_l), (K + L_l, L_l + 2 * K)):
                t, m = step_haloed(tau_pad[:, lo:hi + 2], bits[:, lo:hi],
                                    gvt, cfg, delta_col)
                pieces.append(t)
                if lo == K:
                    parts.append(_local_stats(m))
            tau_e = torch.cat(pieces, dim=1)
        return tau_e[:, K:K + L_l], parts

    def finish_chunk(tau, off, comp, parts):
        ucount, ssum, ssq, smin, smax = (torch.stack(p) for p in zip(*parts))
        # one SUM and one MIN along the ring for the whole chunk
        tot = ring.all_reduce(torch.stack([ucount, ssum, ssq]),
                              tdist.ReduceOp.SUM)
        lo = ring.all_reduce(
            torch.cat([smin, -smax, torch.amin(tau, dim=-1)[None]]),
            tdist.ReduceOp.MIN)
        gmin, gmax, shift = lo[:K], -lo[K:2 * K], lo[2 * K]
        # XLA divides by the constant L as a multiply by fp32(1/L)
        inv_l = 1.0 / L_total
        u = tot[0] * inv_l
        mean = tot[1] * inv_l
        w2 = tot[2] * inv_l - mean * mean
        stats = torch.stack([u, w2, gmin + off[None, :], mean + off[None, :],
                             gmax - mean, mean - gmin])
        # rebase once per chunk (fp32 hygiene)
        tau = tau - shift[:, None]
        off, comp = horizon._kahan_add(off, comp, shift)
        return tau, off, comp, stats

    chunk = exact_chunk if dist_cfg.mode == "exact" else commavoid_chunk
    out = []
    for c in range(n_chunks):
        tau, parts = chunk(tau, step_base + c * K)
        tau, off, comp, stats = finish_chunk(tau, off, comp, parts)
        out.append(stats)
    return tau, off, comp, torch.cat(out, dim=1)


def _check_layout(cfg: PDESConfig, mesh: ProcessMesh, dist_cfg: DistConfig,
                  B: int, L: int) -> tuple[int, int]:
    """Validate the layout before any collective; returns (B_l, L_l)."""
    missing = [a for a in (*dist_cfg.ens_axes, dist_cfg.ring_axis)
               if a not in mesh.shape]
    if missing:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} lack the DistConfig "
                         f"axes {missing}")
    if L != cfg.L:
        raise ValueError(f"tau0 has {L} PEs a ring, cfg.L={cfg.L}")
    ens = math.prod(mesh.shape[a] for a in dist_cfg.ens_axes)
    ring_n = mesh.shape[dist_cfg.ring_axis]
    if B % ens or L % ring_n:
        raise ValueError(f"({B}, {L}) does not divide into blocks of the "
                         f"ensemble extent {ens} and ring extent {ring_n}")
    B_l, L_l = B // ens, L // ring_n
    if dist_cfg.mode == "commavoid" and dist_cfg.k_chunk > L_l:
        raise ValueError(f"commavoid needs k_chunk <= L per shard: "
                         f"k_chunk={dist_cfg.k_chunk}, L_l={L_l}")
    return B_l, L_l


def run_sharded_state(cfg: PDESConfig, mesh: ProcessMesh, *, n_steps: int,
                      seed: int = 0, dist: DistConfig = DistConfig(), tau0,
                      off0, comp0, step_base: int = 0, deltas=None,
                      trial_base=0):
    """Advance a carried state; returns (tau, offset, comp, stats dict).

    Every rank passes the same global ``tau0 (B, L)``, ``off0``/``comp0``
    ``(B,)`` and gets the same global results.  ``deltas`` (optional
    ``(B,)``) is the per-row window column of a batched sweep;
    ``trial_base`` is the counter-stream index of row 0, or a ``(B,)``
    vector of per-row indices (negative ones wrap mod ``2**32``).  Stats
    keys are :data:`STAT_KEYS`, each ``(n_steps, B)``; ``gvt``/``mean_tau``
    are absolute (offset included).  Whole chunks run: a ragged
    ``n_steps`` advances to the next multiple of ``k_chunk``.
    """
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    B, L = tau0.shape
    B_l, L_l = _check_layout(cfg, mesh, dist, B, L)
    ring = _Ring(mesh, dist.ring_axis)
    dev = mesh.device
    if deltas is not None and not isinstance(deltas, torch.Tensor):
        deltas = torch.as_tensor(deltas, dtype=tau0.dtype, device=dev)
    tb = torch.as_tensor(trial_base)
    for t in (tau0, off0, comp0, deltas, tb if tb.ndim else None):
        if t is not None and t.device != dev:
            raise ValueError(f"tensor on {t.device}, mesh on {dev}: the port "
                             f"does not move tensors between devices")
    e = _multi_axis_index(mesh, dist.ens_axes, mesh.coords)
    rows = slice(e * B_l, (e + 1) * B_l)
    cols = slice(ring.i * L_l, (ring.i + 1) * L_l)
    b0 = (tb[rows].to(torch.int64) if tb.ndim
          else int(tb) + e * B_l)
    delta_col = (None if deltas is None
                 else deltas[rows].to(tau0.dtype)[:, None])
    tau, off, comp, stats = _shard_body(
        tau0[rows, cols].contiguous(), off0[rows], comp0[rows],
        int(seed) & 0xFFFFFFFF, int(step_base), b0, delta_col, ring=ring,
        cfg=cfg, dist_cfg=dist, n_steps=n_steps)
    tau, off, comp, stats = _gather(mesh, dist, tau, off, comp, stats, B, L)
    return tau, off, comp, dict(zip(STAT_KEYS, stats[:, :n_steps]))


def _gather(mesh: ProcessMesh, dist_cfg: DistConfig, tau, off, comp, stats,
            B: int, L: int):
    """All-gather every rank's block once; every rank assembles the whole."""
    B_l, L_l = tau.shape
    T = stats.shape[1]
    payload = torch.cat([tau.reshape(-1), off, comp, stats.reshape(-1)])
    blocks = [torch.empty_like(payload) for _ in range(mesh.size)]
    tdist.all_gather(blocks, payload)
    g_tau = torch.empty((B, L), dtype=tau.dtype, device=tau.device)
    g_off = torch.empty((B,), dtype=off.dtype, device=off.device)
    g_comp = torch.empty_like(g_off)
    g_stats = torch.empty((len(STAT_KEYS), T, B), dtype=stats.dtype,
                          device=stats.device)
    n_tau = B_l * L_l
    for r, blk in enumerate(blocks):
        at = mesh.coords_of(r)
        if any(at[a] for a in mesh.axis_names
               if a not in (*dist_cfg.ens_axes, dist_cfg.ring_axis)):
            continue                    # a replica along an unused axis
        e, i = _multi_axis_index(mesh, dist_cfg.ens_axes, at), \
            at[dist_cfg.ring_axis]
        rows = slice(e * B_l, (e + 1) * B_l)
        g_tau[rows, i * L_l:(i + 1) * L_l] = blk[:n_tau].reshape(B_l, L_l)
        if i == 0:                      # off, comp, stats: equal on a ring
            g_off[rows] = blk[n_tau:n_tau + B_l]
            g_comp[rows] = blk[n_tau + B_l:n_tau + 2 * B_l]
            g_stats[:, :, rows] = blk[n_tau + 2 * B_l:].reshape(
                len(STAT_KEYS), T, B_l)
    return g_tau, g_off, g_comp, g_stats


def run_sharded(cfg: PDESConfig, mesh: ProcessMesh, *, n_trials: int,
                n_steps: int, seed: int = 0, dist: DistConfig = DistConfig(),
                dtype=torch.float32, tau0=None, step_base: int = 0,
                deltas=None, trial_base=0):
    """Run the sharded PDES; returns (tau_abs (B, L), stats dict (n_steps, B)).

    ``n_trials`` must be a multiple of the ensemble extent and ``cfg.L`` of
    the ring extent.  ``tau0``/``step_base`` continue an existing
    trajectory; ``deltas``/``trial_base`` run a batched window sweep (see
    :func:`run_sharded_state`, which the engine calls to carry the Kahan
    offset instead of this wrapper's final ``tau + offset``).
    """
    if tau0 is None:
        tau0 = torch.zeros((n_trials, cfg.L), dtype=dtype,
                           device=mesh.device)
    z = torch.zeros((tau0.shape[0],), dtype=tau0.dtype, device=tau0.device)
    tau, off, _, stats = run_sharded_state(
        cfg, mesh, n_steps=n_steps, seed=seed, dist=dist, tau0=tau0,
        off0=z, comp0=z, step_base=step_base, deltas=deltas,
        trial_base=trial_base)
    return tau + off[:, None], stats


# ---------------------------------------------------------------------------
# single-device reference with the identical counter event stream
# ---------------------------------------------------------------------------


def run_reference(cfg: PDESConfig, *, n_trials: int, n_steps: int,
                  seed: int = 0, stale_every: int | None = None,
                  dtype=torch.float32, deltas=None, trial_base=0,
                  device=None):
    """Unsharded oracle for :func:`run_sharded` (same counter stream).

    Plain PyTorch, one step at a time, no rebase.  ``stale_every=None`` is
    mode ``exact``; ``stale_every=K`` is mode ``commavoid`` with
    ``k_chunk=K`` (window base refreshed every K steps).  ``device=None``
    is the GPU.  Returns (tau_abs (B, L), stats dict (n_steps, B)).
    """
    dev = resolve_device(device)
    B, L = n_trials, cfg.L
    tau = torch.zeros((B, L), dtype=dtype, device=dev)
    K = stale_every or 1
    delta = (None if deltas is None
             else torch.as_tensor(deltas, dtype=dtype, device=dev)[:, None])
    gvt = None
    out = []
    for s in range(n_steps):
        bits = counter_bits_block(seed, s, trial_base, 0, B, L, device=dev)
        tau_h = torch.cat([tau[:, -1:], tau, tau[:, :1]], dim=1)
        if stale_every is None or s % K == 0:
            gvt = torch.amin(tau, dim=-1, keepdim=True)
        tau, update = _update_haloed(tau_h, bits, gvt, cfg, delta)
        u = update.to(dtype).sum(dim=-1) * (1.0 / L)
        mean = tau.mean(dim=-1)
        w2 = (tau * tau).mean(dim=-1) - mean * mean
        gmin = tau.amin(dim=-1)
        out.append((u, w2, gmin, mean, tau.amax(dim=-1) - mean, mean - gmin))
    return tau, {k: torch.stack(x) for k, x in zip(STAT_KEYS, zip(*out))}
