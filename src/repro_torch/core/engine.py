"""PDES engine (port of ``repro.core.engine``): one API over the backends.

The engine owns the init / chunk / rebase / Kahan / stats logic once and
dispatches each K-step chunk to a backend.  Every backend consumes the same
counter event stream keyed on ``(seed, step, trial, pe)`` and rebases on the
same per-chunk schedule, so trajectories agree bit for bit across backends.
On ``pallas_multistep`` B1 takes the rebase in its last store of τ: its
shift is the chunk's last ``min`` moment, the ring minimum the loop would
take, so the same subtraction on the same values.  In the stale window
every backend bases each step's window on the ring minimum of the chunk's
input τ (B1 takes it in the kernel before its first step), and a
remainder chunk starts a new base, as every chunk does.

Backends of the port::

    backend            window modes   chunk advance
    -----------------  -------------  -----------------------------------
    reference          exact, stale   plain PyTorch, one step at a time
    pallas             exact, stale   one CUDA kernel per step
                                      (kernels/pdes_step), bits from the
                                      plain counter_bits_block
    pallas_multistep   exact, stale   one CUDA kernel per K-step chunk
                                      (kernels/pdes_multistep, B1; the
                                      stale window in each tier's
                                      ``kStale`` instantiations)
    sharded            exact, stale   core.distributed on a process mesh
                                      (core/mesh.py): exact -> mode
                                      "exact", stale -> "commavoid"; each
                                      shard's step through kernels/pdes_step

The names ``pallas`` and ``pallas_multistep`` are the wire names of the
fused paths in specs, ``CompatKey`` and responses; in the port CUDA kernels
serve them (on CPU tensors their plain PyTorch versions).

Window sweeps lay the Δ grid on the ensemble axis (``init_sweep``): one
pass advances ``n_windows * replicas`` rows, each with its own Δ (the
``deltas=`` column) and, for the service, its own trial index (a vector
``trial_base=``).

The ``sharded`` backend advances whole ``k_chunk``-step chunks only and
reports ``wa`` as NaN: the absolute width needs the ring mean before the
deviation reduction, a second all-reduce per step that the
one-collective-per-chunk layout avoids.  ``gvt`` and ``mean_tau`` come
back absolute, on the same rebase schedule as the other backends.

Spans (``repro_torch.obs``, inert unless a tracer or the torch profiler
records): ``engine.run`` around each run (its args name the window; on
the fused path also B1's tier, ``tiling.ring_plan(L).tier``),
``engine.chunk`` around each chunk of the single-device loop, and
``engine.advance`` around the
backend's advance within it (for the fused path, the kernel wrapper's
host work up to B1's launch).  None synchronizes the device.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..device import resolve_device
from ..obs.trace import span as _span
from . import horizon
from .events import counter_bits_block
from .horizon import PDESConfig, SimState, StepStats

BACKENDS = ("reference", "pallas", "pallas_multistep", "sharded")
WINDOWS = ("exact", "stale")

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine parameters.

    Attributes:
      backend: one of ``BACKENDS``.
      window: "exact" (per-step GVT) or "stale" (per-chunk GVT base).
      k_fuse: steps per chunk — the fuse depth and the rebase cadence.
    """

    backend: str = "reference"
    window: str = "exact"
    k_fuse: int = 16

    def __post_init__(self):
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, "
                             f"got {self.backend!r}")
        if self.window not in WINDOWS:
            raise ValueError(f"window must be one of {WINDOWS}, "
                             f"got {self.window!r}")
        if self.k_fuse < 1:
            raise ValueError("k_fuse must be >= 1")


def _make_advance(cfg: PDESConfig, ecfg: EngineConfig, B: int, L: int,
                  rebase: bool = False):
    """Backend chunk advance ``(tau, step0, seed, k, delta_col, b0)``.

    Returns ``(tau_k, moments)`` with each moment ``(k, B)``.  ``delta_col``
    is None (static ``cfg.delta``) or a ``(B, 1)`` column; ``b0`` is a Python
    int (row ``r`` uses trial ``b0 + r``) or a ``(B,)`` tensor of per-row
    trial indices.  No rebasing inside, but where ``rebase`` asks the fused
    advance for it: tau_k less ``moments["min"][-1]`` (other backends ignore
    it; the chunk loop rebases for them).
    """
    stale = ecfg.window == "stale"

    if ecfg.backend == "reference":

        def one(tau, bits, gvt0, delta_col):
            is_l, is_r, eta = horizon.decode_events(bits, cfg)
            tau, update, _ = horizon.step_core(
                tau, is_l, is_r, eta, cfg,
                gvt_for_window=gvt0 if stale else None,
                delta_override=delta_col)
            return tau, horizon.ring_moments(tau, update)

    elif ecfg.backend == "pallas":
        from ..kernels.ops import ring_halo, step_haloed

        def one(tau, bits, gvt0, delta_col):
            gvt = gvt0 if stale else torch.amin(tau, dim=-1, keepdim=True)
            return step_haloed(ring_halo(tau), bits, gvt, cfg, delta_col)

    if ecfg.backend in ("reference", "pallas"):

        def advance(tau, step0, seed, k, delta_col, b0):
            gvt0 = torch.amin(tau, dim=-1, keepdim=True)   # the stale base
            planes = []
            for s in range(step0, step0 + k):
                bits = counter_bits_block(seed, s, b0, 0, B, L,
                                          device=tau.device)
                tau, m = one(tau, bits, gvt0, delta_col)
                planes.append(m)
            return tau, {key: torch.stack([m[key] for m in planes])
                         for key in horizon.MOMENT_KEYS}

        return advance

    if ecfg.backend == "pallas_multistep":
        from ..kernels.pdes_multistep import pdes_multistep_counter

        def advance(tau, step0, seed, k, delta_col, b0):
            # a (B,) b0 becomes the per-row trial column; ctr's scalar slot
            # is then unused (zeroed) — the kernel reads the column instead.
            vec = isinstance(b0, torch.Tensor)
            ctr = torch.tensor([[seed, step0 & 0xFFFFFFFF,
                                 0 if vec else b0 & 0xFFFFFFFF, 0]],
                               dtype=torch.int64)
            return pdes_multistep_counter(
                tau, ctr, delta_col, b0[:, None] if vec else None,
                k_steps=k, n_v=cfg.n_v, delta=cfg.delta,
                rd_mode=cfg.rd_mode, border_both=cfg.border_both,
                rebase=rebase, stale=stale)

        return advance

    raise ValueError(f"no single-device chunk advance for {ecfg.backend!r}")


def _run_single(state: SimState, seed: int, cfg: PDESConfig,
                ecfg: EngineConfig, n_steps: int, mode: str, deltas=None,
                trial_base=0):
    """The chunk loop: ``record`` | ``mean`` | ``burn`` (see ``repro``)."""
    B, L = state.tau.shape
    K = max(1, min(ecfg.k_fuse, n_steps))
    n_chunks, rem = divmod(n_steps, K)
    fused = ecfg.backend == "pallas_multistep"   # B1 rebases in its store
    advance = _make_advance(cfg, ecfg, B, L, rebase=fused)
    dtype = state.tau.dtype
    delta_col = None if deltas is None else deltas.to(dtype)[:, None]
    tau, off, comp, step = state
    pieces, acc = [], None
    for k in [K] * n_chunks + ([rem] if rem else []):
        with _span("engine.chunk", cat="engine"):
            with _span("engine.advance", cat="engine"):
                tau, moments = advance(tau, step, seed, k, delta_col,
                                       trial_base)
            if mode != "burn":
                st = horizon.stats_from_moments(moments, off[None, :], L)
                if mode == "record":
                    pieces.append(st)
                else:
                    sums = [x.sum(dim=0) for x in st]
                    acc = sums if acc is None else [a + x for a, x in
                                                    zip(acc, sums)]
            # rebase once per chunk: identical schedule on every backend,
            # so trajectories stay bitwise comparable
            if fused:   # tau came rebased by the ring's last minimum
                shift = moments["min"][-1]
            else:
                shift = torch.amin(tau, dim=-1)
                tau = tau - shift[:, None]
            off, comp = horizon._kahan_add(off, comp, shift)
        step += k
    out_state = SimState(tau, off, comp, step)
    if mode == "burn":
        return out_state, None
    if mode == "record":
        return out_state, StepStats(*(torch.cat(xs, dim=0)
                                      for xs in zip(*pieces)))
    return out_state, StepStats(*(a / n_steps for a in acc))


class PDESEngine:
    """One entry point for the port's PDES execution paths.

    Args:
      cfg: the physics (``PDESConfig``).
      backend: one of ``BACKENDS``.
      window: "exact" | "stale".
      k_fuse: chunk depth (fuse and rebase cadence).
      device: where state lives and the work runs; ``None`` is the GPU
        (raises without CUDA) or the mesh's device, ``"cpu"`` the plain
        PyTorch path.
      mesh / dist: required / optional for ``backend="sharded"``: the
        process mesh (``core.mesh.make_mesh``) and ``DistConfig``.  When
        ``dist`` is omitted it is derived from ``window`` (exact ->
        "exact", stale -> "commavoid" with ``k_chunk=k_fuse``).
    """

    def __init__(self, cfg: PDESConfig, backend: str = "reference", *,
                 window: str = "exact", k_fuse: int = 16, device=None,
                 mesh=None, dist=None):
        self.cfg = cfg
        self.ecfg = EngineConfig(backend=backend, window=window,
                                 k_fuse=k_fuse)
        self.mesh = mesh
        self.dist = dist
        if backend == "sharded":
            if mesh is None:
                raise ValueError("backend='sharded' requires a mesh")
            if dist is None:
                from .distributed import DistConfig
                self.dist = DistConfig(
                    mode="exact" if window == "exact" else "commavoid",
                    k_chunk=k_fuse)
            elif (dist.mode == "exact") != (window == "exact"):
                raise ValueError(f"window={window!r} conflicts with "
                                 f"dist.mode={dist.mode!r}")
        self.device = resolve_device(device, mesh)

    # -- state ------------------------------------------------------------

    def init(self, n_trials: int) -> SimState:
        """Fully synchronized initial condition (all clocks equal)."""
        return horizon.init_state(self.cfg, n_trials, self.device)

    def init_sweep(self, deltas, replicas: int):
        """Per-Δ rows of a batched window sweep: ``(state, deltas_rows)``.

        Window ``w`` owns rows ``[w*replicas, (w+1)*replicas)``; ``inf``
        rows run unconstrained.
        """
        d = torch.as_tensor([float(x) for x in deltas], dtype=self.cfg.dtype,
                            device=self.device).repeat_interleave(replicas)
        return self.init(int(d.shape[0])), d

    # -- runs -------------------------------------------------------------

    def run(self, state: SimState, seed, n_steps: int, *, deltas=None,
            trial_base=0):
        """Advance ``n_steps``, recording StepStats per step (n_steps, B).

        ``deltas``: optional (B,) per-row window widths.  ``trial_base``:
        the counter-stream trial index of row 0, or a (B,) vector of
        per-row indices (negative entries wrap mod ``2**32``).
        """
        return self._dispatch(state, seed, n_steps, "record",
                              deltas=deltas, trial_base=trial_base)

    def run_mean(self, state: SimState, seed, n_steps: int, *, deltas=None,
                 trial_base=0):
        """Advance ``n_steps``; return only time-averaged StepStats (B,)."""
        return self._dispatch(state, seed, n_steps, "mean",
                              deltas=deltas, trial_base=trial_base)

    def burn_in(self, state: SimState, seed, n_steps: int, *, deltas=None,
                trial_base=0) -> SimState:
        """Advance without recording (reach the steady state)."""
        return self._dispatch(state, seed, n_steps, "burn",
                              deltas=deltas, trial_base=trial_base)[0]

    def _dispatch(self, state, seed, n_steps, mode, deltas=None,
                  trial_base=0):
        if n_steps < 1:
            raise ValueError(f"n_steps must be >= 1, got {n_steps}")
        B = state.tau.shape[0]
        if state.tau.device != self.device:
            raise ValueError(f"state lives on {state.tau.device}, engine on "
                             f"{self.device}")
        seed = int(seed) & 0xFFFFFFFF
        if deltas is not None:
            deltas = torch.as_tensor(deltas, dtype=state.tau.dtype,
                                     device=self.device)
            if tuple(deltas.shape) != (B,):
                raise ValueError(
                    f"deltas must have shape ({B},) — one window width per "
                    f"ensemble row — got {tuple(deltas.shape)}")
        tb = torch.as_tensor(trial_base)
        if tb.dtype.is_floating_point or tb.ndim not in (0, 1) or (
                tb.ndim == 1 and tuple(tb.shape) != (B,)):
            raise ValueError(
                f"trial_base must be an integer scalar or have shape ({B},) "
                f"— one stream index per ensemble row — got "
                f"{tuple(tb.shape)} {tb.dtype}")
        trial_base = int(tb) if tb.ndim == 0 else \
            tb.to(device=self.device, dtype=torch.int64)
        state = SimState(state.tau, state.offset, state.offset_comp,
                         int(state.step))
        sharded = self.ecfg.backend == "sharded"
        K = self.dist.k_chunk if sharded \
            else max(1, min(self.ecfg.k_fuse, n_steps))
        L = state.tau.shape[1]
        args = {"mode": mode, "B": B, "L": L, "n_steps": n_steps, "K": K,
                "window": self.ecfg.window}
        if self.ecfg.backend == "pallas_multistep":
            from ..kernels.tiling import ring_plan
            args["tier"] = ring_plan(L).tier
        with _span("engine.run", cat="engine", args=args):
            if sharded:
                return self._run_sharded(state, seed, n_steps, mode, deltas,
                                         trial_base)
            return _run_single(state, seed, self.cfg, self.ecfg, n_steps,
                               mode, deltas, trial_base)

    def _run_sharded(self, state, seed, n_steps, mode, deltas, trial_base):
        from . import distributed as D
        K = self.dist.k_chunk
        if n_steps % K:
            raise ValueError(
                f"sharded backend advances whole chunks: n_steps={n_steps} "
                f"must be a multiple of k_chunk={K}")
        tau, off, comp, st = D.run_sharded_state(
            self.cfg, self.mesh, n_steps=n_steps, seed=seed, dist=self.dist,
            tau0=state.tau, off0=state.offset, comp0=state.offset_comp,
            step_base=state.step, deltas=deltas, trial_base=trial_base)
        out_state = SimState(tau, off, comp, state.step + n_steps)
        if mode == "burn":
            return out_state, None
        stats = StepStats(
            utilization=st["u"], w2=st["w2"],
            wa=torch.full_like(st["u"], math.nan), gvt=st["gvt"],
            mean_tau=st["mean_tau"], max_dev=st["max_dev"],
            min_dev=st["min_dev"])
        if mode == "mean":
            stats = StepStats(*(a.mean(dim=0) for a in stats))
        return out_state, stats
