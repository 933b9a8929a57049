"""Batched window-sweep experiments (port of ``repro.experiments.sweep``).

A ``WindowSweep`` describes the paper's grid over ring size L, volume load
N_V and window width Δ; ``run_window_sweep`` runs the whole Δ axis of each
(L, N_V) point in one engine pass, with the Δ grid laid on the ensemble
axis (``PDESEngine.init_sweep``).  ``serial_window_sweep`` runs one engine
call per Δ on the same counter-stream rows and is the bit-identical oracle.

The JSON encodings (``spec_to_dict``, ``SweepResult.as_dict``) are exactly
``repro``'s, so specs and responses travel between the two packages.

**Mesh sweeps**: with ``backend="sharded"`` pass ``mesh=`` (a
``core.mesh.ProcessMesh``; every rank calls with the same spec) and
optionally ``dist=``.  ``plan_mesh_sweep`` checks that the ring axis
divides every L, pads ragged Δ-batches to a multiple of the ensemble
extent (pad rows run unconstrained, ``Δ = inf``, and are sliced off before
``measurement.sweep_reduce``) and rounds the burn-in up to whole chunks.
Every row's counter stream depends only on its own global trial index, so
the sharded pass equals the single-device serial loop bit for bit in its
trajectories.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Sequence

import numpy as np
import torch

from ..core import measurement
from ..core.engine import PDESEngine
from ..core.ensemble import default_burn_in, sync_if_traced
from ..core.horizon import PDESConfig
from ..device import resolve_device
from ..obs.trace import span as _span


@dataclasses.dataclass(frozen=True)
class WindowSweep:
    """One batched window-sweep study (see ``repro.experiments.sweep``).

    Attributes:
      Ls, n_vs, deltas: the grid (``math.inf`` = unconstrained scheme).
      replicas: independent trajectories per (L, N_V, Δ) point.
      n_steps: recorded measurement steps per grid point.
      burn_in: steps discarded first; None = ``default_burn_in`` of the
        widest window.
      backend, window, k_fuse: engine options.
      rd_mode, border_both: physics options (``PDESConfig``).
      steady_frac: trailing fraction of the series treated as steady.
      seed: counter-stream seed.
    """

    Ls: Sequence[int] = (64,)
    n_vs: Sequence[int] = (1,)
    deltas: Sequence[float] = (math.inf,)
    replicas: int = 16
    n_steps: int = 400
    burn_in: int | None = None
    backend: str = "reference"
    window: str = "exact"
    k_fuse: int = 16
    rd_mode: bool = False
    border_both: bool = False
    steady_frac: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if not self.Ls or not self.n_vs or not self.deltas:
            raise ValueError("Ls, n_vs and deltas must all be non-empty")
        if self.replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {self.replicas}")
        if len(set(self.deltas)) != len(self.deltas):
            raise ValueError(f"duplicate window widths: {self.deltas}")

    @property
    def n_windows(self) -> int:
        """Number of Δ values in the grid (ensemble rows per replica)."""
        return len(self.deltas)

    @property
    def n_trajectories(self) -> int:
        """Trajectories advanced per (L, N_V) grid point in one pass."""
        return self.n_windows * self.replicas

    def burn_in_for(self, cfg: PDESConfig) -> int:
        """Shared burn-in of one grid point: the widest window dominates."""
        if self.burn_in is not None:
            return self.burn_in
        return max(
            default_burn_in(dataclasses.replace(cfg, delta=d))
            for d in self.deltas)


def spec_to_dict(spec: WindowSweep) -> dict:
    """JSON-ready dict of a spec (``inf`` spelled as the string ``"inf"``)."""
    d = dataclasses.asdict(spec)
    d["Ls"] = [int(x) for x in spec.Ls]
    d["n_vs"] = [int(x) for x in spec.n_vs]
    d["deltas"] = ["inf" if math.isinf(x) else float(x) for x in spec.deltas]
    return d


def spec_from_dict(d: dict) -> WindowSweep:
    """Rebuild a :class:`WindowSweep` from :func:`spec_to_dict` output."""
    d = dict(d)
    d["Ls"] = tuple(int(x) for x in d["Ls"])
    d["n_vs"] = tuple(int(x) for x in d["n_vs"])
    d["deltas"] = tuple(math.inf if x == "inf" else float(x)
                        for x in d["deltas"])
    return WindowSweep(**d)


@dataclasses.dataclass(frozen=True)
class SweepRecord:
    """Per-(L, N_V, Δ) steady-state estimates (ensemble mean ± std. error)."""

    L: int
    n_v: int
    delta: float
    u: float
    u_err: float
    w2: float
    w2_err: float
    w: float
    wa: float
    spread: float
    rate: float
    rate_err: float

    def as_dict(self) -> dict:
        """JSON-ready dict of the record's scalar fields."""
        d = dataclasses.asdict(self)
        if math.isinf(self.delta):
            d["delta"] = "inf"
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "SweepRecord":
        """Inverse of :meth:`as_dict` (decodes the ``"inf"`` spelling)."""
        d = dict(d)
        d["delta"] = math.inf if d["delta"] == "inf" else float(d["delta"])
        return cls(**d)


@dataclasses.dataclass(frozen=True)
class SweepResult:
    """All records of one executed sweep, plus selection helpers."""

    spec: WindowSweep
    records: tuple[SweepRecord, ...]

    def select(self, *, L: int | None = None, n_v: int | None = None,
               delta: float | None = None) -> list[SweepRecord]:
        """Records matching every given coordinate (None = don't filter)."""
        return [r for r in self.records
                if (L is None or r.L == L) and (n_v is None or r.n_v == n_v)
                and (delta is None or r.delta == delta)]

    def as_dict(self) -> dict:
        """JSON-ready ``{"spec": ..., "records": [...]}`` encoding."""
        return {"spec": spec_to_dict(self.spec),
                "records": [r.as_dict() for r in self.records]}

    @classmethod
    def from_dict(cls, d: dict) -> "SweepResult":
        """Inverse of :meth:`as_dict` — the wire-layer decode path."""
        return cls(spec=spec_from_dict(d["spec"]),
                   records=tuple(SweepRecord.from_dict(r)
                                 for r in d["records"]))

    def to_json(self, path: str | pathlib.Path) -> pathlib.Path:
        """Write spec + records to ``path`` as JSON; returns the path."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.as_dict(), indent=1))
        return path


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def _derive_dist(spec: WindowSweep):
    """The DistConfig ``PDESEngine`` would derive for this spec."""
    from ..core.distributed import DistConfig
    return DistConfig(mode="exact" if spec.window == "exact" else "commavoid",
                      k_chunk=spec.k_fuse)


def ens_extent(mesh, dist) -> int:
    """Product of the mesh's sizes along ``dist.ens_axes``."""
    return math.prod(mesh.shape[a] for a in dist.ens_axes)


@dataclasses.dataclass(frozen=True)
class MeshSweepPlan:
    """How one (L, N_V) grid point of a sweep maps onto the process mesh.

    Attributes:
      L, n_v: the grid point.
      trial_base: counter-stream index of row 0, as in the single-device
        pass, so padding never shifts real rows' streams.
      n_rows: real (Δ, replica) rows, ``spec.n_trajectories``.
      n_pad: rows appended so ``n_rows + n_pad`` is a multiple of the
        ensemble extent; they run with ``Δ = inf`` on stream indices past
        the real block and are sliced off before reduction.
      ens_extent: product of the mesh's ensemble axis sizes.
      ring_extent: the mesh's ring axis size (divides L).
      burn_in: the grid point's burn-in rounded up to whole chunks.
    """

    L: int
    n_v: int
    trial_base: int
    n_rows: int
    n_pad: int
    ens_extent: int
    ring_extent: int
    burn_in: int

    @property
    def n_padded(self) -> int:
        """Rows laid out on the mesh (``n_rows + n_pad``)."""
        return self.n_rows + self.n_pad


def plan_mesh_sweep(spec: WindowSweep, mesh,
                    dist=None) -> tuple[MeshSweepPlan, ...]:
    """Grid scheduler: pack the sweep's (L, N_V, Δ) points onto a mesh.

    Validates the layout (the mesh has the ``DistConfig`` axes, the ring
    axis divides every L, whole-chunk step counts) and returns one
    :class:`MeshSweepPlan` per (L, N_V) point, in execution order.  Works
    on ``ProcessMesh.abstract`` too: planning needs axis sizes only.
    """
    if dist is None:
        dist = _derive_dist(spec)
    missing = [a for a in (*dist.ens_axes, dist.ring_axis)
               if a not in mesh.shape]
    if missing:
        raise ValueError(f"mesh axes {tuple(mesh.shape)} lack the "
                         f"DistConfig axes {missing}")
    ens = ens_extent(mesh, dist)
    ring = mesh.shape[dist.ring_axis]
    if spec.n_steps % dist.k_chunk:
        raise ValueError(
            f"sharded sweeps advance whole chunks: n_steps={spec.n_steps} "
            f"must be a multiple of k_chunk={dist.k_chunk}")
    plans = []
    base = 0
    for L in spec.Ls:
        if int(L) % ring:
            raise ValueError(f"ring axis {dist.ring_axis!r} of extent {ring} "
                             f"does not divide L={L}")
        for n_v in spec.n_vs:
            cfg = PDESConfig(L=int(L), n_v=int(n_v), delta=math.inf,
                             rd_mode=spec.rd_mode,
                             border_both=spec.border_both)
            B = spec.n_trajectories
            plans.append(MeshSweepPlan(
                L=int(L), n_v=int(n_v), trial_base=base, n_rows=B,
                n_pad=_round_up(B, ens) - B, ens_extent=ens,
                ring_extent=ring,
                burn_in=_round_up(spec.burn_in_for(cfg), dist.k_chunk)))
            base += B
    return tuple(plans)


def records_from_reduction(L: int, n_v: int, deltas, red: dict
                           ) -> list[SweepRecord]:
    """One :class:`SweepRecord` per Δ from a ``sweep_reduce`` output."""
    return [SweepRecord(
        L=L, n_v=n_v, delta=float(d),
        u=float(red["u"][w]), u_err=float(red["u_err"][w]),
        w2=float(red["w2"][w]), w2_err=float(red["w2_err"][w]),
        w=float(red["w"][w]), wa=float(red["wa"][w]),
        spread=float(red["spread"][w]),
        rate=float(red["rate"][w]), rate_err=float(red["rate_err"][w]))
        for w, d in enumerate(deltas)]


def _engine(spec: WindowSweep, cfg: PDESConfig, device, mesh=None,
            dist=None) -> PDESEngine:
    return PDESEngine(cfg, backend=spec.backend, window=spec.window,
                      k_fuse=spec.k_fuse, device=device, mesh=mesh,
                      dist=dist)


def _check_mesh_args(spec: WindowSweep, mesh) -> None:
    if spec.backend == "sharded" and mesh is None:
        raise ValueError(
            "backend='sharded' sweeps need a process mesh: pass mesh= "
            "(and optionally dist=)")
    if mesh is not None and spec.backend != "sharded":
        raise ValueError(
            f"mesh= is only meaningful for backend='sharded', "
            f"got backend={spec.backend!r}")


def run_window_sweep(spec: WindowSweep, *, device=None, mesh=None,
                     dist=None) -> SweepResult:
    """Execute a sweep: one batched engine pass per (L, N_V) grid point.

    ``device=None`` runs on the GPU (raises without CUDA), or on the
    mesh's device; ``"cpu"`` runs the plain PyTorch path.  With
    ``backend="sharded"`` pass ``mesh=`` (and optionally ``dist=``): each
    pass shards over the mesh per :func:`plan_mesh_sweep`.
    """
    _check_mesh_args(spec, mesh)
    dev = resolve_device(device, mesh)
    if mesh is not None:
        return _run_window_sweep_sharded(spec, mesh, dist, dev)
    records = []
    grid_base = 0
    for L in spec.Ls:
        for n_v in spec.n_vs:
            cfg = PDESConfig(L=int(L), n_v=int(n_v), delta=math.inf,
                             rd_mode=spec.rd_mode,
                             border_both=spec.border_both)
            eng = _engine(spec, cfg, dev)
            state, drows = eng.init_sweep(spec.deltas, spec.replicas)
            burn = spec.burn_in_for(cfg)
            point = {"L": cfg.L, "n_v": cfg.n_v,
                     "rows": spec.n_trajectories}
            if burn:
                with _span("burn", args=dict(point, steps=burn)) as sp:
                    state = eng.burn_in(state, spec.seed, burn,
                                        deltas=drows, trial_base=grid_base)
                    sync_if_traced(sp, dev)
            with _span("measure", args=dict(point,
                                            steps=spec.n_steps)) as sp:
                _, stats = eng.run(state, spec.seed, spec.n_steps,
                                   deltas=drows, trial_base=grid_base)
                sync_if_traced(sp, dev)
            with _span("reduce", args=point):
                red = measurement.sweep_reduce(
                    stats, spec.n_windows, spec.replicas,
                    steady_frac=spec.steady_frac)
            records.extend(records_from_reduction(cfg.L, cfg.n_v,
                                                  spec.deltas, red))
            grid_base += spec.n_trajectories
    return SweepResult(spec=spec, records=tuple(records))


def _run_window_sweep_sharded(spec: WindowSweep, mesh, dist,
                              dev) -> SweepResult:
    """Mesh execution of :func:`run_window_sweep` (same records contract).

    Pad rows run with ``Δ = inf`` on counter-stream indices past the grid
    point's real block and are sliced off the recorded stats before
    ``measurement.sweep_reduce``.
    """
    records = []
    for plan in plan_mesh_sweep(spec, mesh, dist):
        cfg = PDESConfig(L=plan.L, n_v=plan.n_v, delta=math.inf,
                         rd_mode=spec.rd_mode, border_both=spec.border_both)
        eng = _engine(spec, cfg, dev, mesh=mesh, dist=dist)
        state, drows = eng.init_sweep(spec.deltas, spec.replicas)
        if plan.n_pad:
            state = eng.init(plan.n_padded)
            drows = torch.cat([drows, torch.full((plan.n_pad,), math.inf,
                                                 dtype=drows.dtype,
                                                 device=dev)])
        point = {"L": plan.L, "n_v": plan.n_v, "rows": plan.n_rows,
                 "n_pad": plan.n_pad}
        if plan.burn_in:
            with _span("burn", args=dict(point, steps=plan.burn_in)) as sp:
                state = eng.burn_in(state, spec.seed, plan.burn_in,
                                    deltas=drows, trial_base=plan.trial_base)
                sync_if_traced(sp, dev)
        with _span("measure", args=dict(point, steps=spec.n_steps)) as sp:
            _, stats = eng.run(state, spec.seed, spec.n_steps, deltas=drows,
                               trial_base=plan.trial_base)
            sync_if_traced(sp, dev)
        with _span("reduce", args=point):
            stats = type(stats)(*(a[:, :plan.n_rows] for a in stats))
            red = measurement.sweep_reduce(
                stats, spec.n_windows, spec.replicas,
                steady_frac=spec.steady_frac)
        records.extend(records_from_reduction(cfg.L, cfg.n_v, spec.deltas,
                                              red))
    return SweepResult(spec=spec, records=tuple(records))


def serial_window_sweep(spec: WindowSweep, *, device=None, mesh=None,
                        dist=None) -> SweepResult:
    """The same study as a serial per-Δ engine loop (oracle + baseline).

    Window ``w`` runs with a static ``cfg.delta`` and ``trial_base = w *
    replicas``, i.e. on exactly the counter-stream rows the batched pass
    assigns it, so its records equal :func:`run_window_sweep`'s.
    ``mesh=``/``dist=`` run each per-Δ call on the sharded backend
    (``replicas`` must then be a multiple of the ensemble extent, and the
    burn-in rounds up to whole chunks as the batched mesh pass's does).
    """
    _check_mesh_args(spec, mesh)
    dev = resolve_device(device, mesh)
    burn_quantum = 1
    if mesh is not None:
        dcfg = dist if dist is not None else _derive_dist(spec)
        ens = ens_extent(mesh, dcfg)
        if spec.replicas % ens:
            raise ValueError(
                f"serial sharded sweeps run replicas={spec.replicas} rows "
                f"per engine call; must be a multiple of the ensemble "
                f"extent {ens}")
        burn_quantum = dcfg.k_chunk
    records = []
    grid_base = 0
    for L in spec.Ls:
        for n_v in spec.n_vs:
            per_delta = []
            for w, d in enumerate(spec.deltas):
                cfg = PDESConfig(L=int(L), n_v=int(n_v), delta=float(d),
                                 rd_mode=spec.rd_mode,
                                 border_both=spec.border_both)
                burn = _round_up(spec.burn_in_for(cfg), burn_quantum)
                eng = _engine(spec, cfg, dev, mesh=mesh, dist=dist)
                state = eng.init(spec.replicas)
                base = grid_base + w * spec.replicas
                if burn:
                    state = eng.burn_in(state, spec.seed, burn,
                                        trial_base=base)
                _, stats = eng.run(state, spec.seed, spec.n_steps,
                                   trial_base=base)
                per_delta.append(stats)
            joined = type(per_delta[0])(*(
                np.concatenate([measurement.to_numpy(getattr(s, f))
                                for s in per_delta], axis=1)
                for f in per_delta[0]._fields))
            red = measurement.sweep_reduce(
                joined, spec.n_windows, spec.replicas,
                steady_frac=spec.steady_frac)
            records.extend(records_from_reduction(int(L), int(n_v),
                                                  spec.deltas, red))
            grid_base += spec.n_trajectories
    return SweepResult(spec=spec, records=tuple(records))
