"""Optimal window width Δ* (port of ``repro.experiments.optimal_window``).

The paper's closing claim (Sec. V): Δ is a tuning parameter that "could be
adjusted to optimize the utilization so as to maximize the efficiency".
Utilization u(Δ) and the horizon width w(Δ) both rise with Δ; a window is
scored by utilization per unit width-bounded cost::

    efficiency(Δ) = u(Δ) / (1 + w(Δ))

``find_optimal_window`` takes the grid argmax of one (L, N_V) point of a
sweep; ``refine_optimal_window`` refines it by golden-section search with
every probe a single-Δ request to a :class:`~repro_torch.service.
SweepService`.  The ``as_dict`` encodings are ``repro``'s.  A sharded
spec probes through a service on a process mesh (``mesh=``/``dist=``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..core.horizon import PDESConfig
from .sweep import SweepResult, WindowSweep, run_window_sweep


def efficiency(u, w):
    """Utilization per unit width-bounded cost, u / (1 + w) (elementwise)."""
    return np.asarray(u, dtype=float) / (1.0 + np.asarray(w, dtype=float))


@dataclasses.dataclass(frozen=True)
class OptimalWindow:
    """The efficiency curve of one (L, N_V) grid point and its maximizer."""

    L: int
    n_v: int
    deltas: tuple[float, ...]      # sorted, as swept (inf allowed, last)
    eff: tuple[float, ...]         # efficiency per Δ, same order
    u: tuple[float, ...]
    w: tuple[float, ...]
    delta_star: float              # grid maximizer of the efficiency
    eff_star: float
    interior: bool                 # Δ* strictly inside the swept grid

    def as_dict(self) -> dict:
        """JSON-ready dict (``inf`` spelled as the string ``"inf"``)."""
        d = dataclasses.asdict(self)
        d["deltas"] = ["inf" if math.isinf(x) else x for x in self.deltas]
        for k in ("deltas", "eff", "u", "w"):
            d[k] = list(d[k])
        return d


def find_optimal_window(result: SweepResult, *, L: int,
                        n_v: int) -> OptimalWindow:
    """Locate Δ* on the swept grid of one (L, N_V) point.

    Sorts the records by Δ (inf last), computes the efficiency curve and
    returns the grid argmax; ``interior`` says whether it sits strictly
    between the smallest and largest swept Δ.
    """
    recs = sorted(result.select(L=L, n_v=n_v), key=lambda r: r.delta)
    if not recs:
        raise ValueError(f"no records for L={L}, n_v={n_v}")
    deltas = tuple(r.delta for r in recs)
    u = tuple(r.u for r in recs)
    w = tuple(r.w for r in recs)
    eff = efficiency(u, w)
    i = int(np.argmax(eff))
    return OptimalWindow(
        L=L, n_v=n_v, deltas=deltas, eff=tuple(float(e) for e in eff),
        u=u, w=w, delta_star=deltas[i], eff_star=float(eff[i]),
        interior=0 < i < len(deltas) - 1)


def optimal_windows(spec_or_result: WindowSweep | SweepResult, *,
                    device=None) -> list[OptimalWindow]:
    """Δ* for every (L, N_V) grid point of a sweep (running it if needed).

    A spec runs on ``device`` (``None`` is the GPU, ``"cpu"`` the plain
    PyTorch path).
    """
    result = (spec_or_result if isinstance(spec_or_result, SweepResult)
              else run_window_sweep(spec_or_result, device=device))
    return [find_optimal_window(result, L=int(L), n_v=int(n_v))
            for L in result.spec.Ls for n_v in result.spec.n_vs]


# ---------------------------------------------------------------------------
# adaptive Δ* refinement through the sweep service
# ---------------------------------------------------------------------------

_INV_PHI = (math.sqrt(5.0) - 1.0) / 2.0     # golden-section shrink ratio


@dataclasses.dataclass(frozen=True)
class RefinedWindow:
    """A golden-section-refined optimum of one (L, N_V) grid point.

    ``evaluations`` logs every Δ probed, in evaluation order, with its
    efficiency: the coarse grid first, then the interior golden-section
    points, then the polish re-measurement of the winner.
    """

    L: int
    n_v: int
    delta_star: float
    eff_star: float
    u_star: float
    w_star: float
    bracket: tuple[float, float]   # initial finite bracket around Δ*
    evaluations: tuple[tuple[float, float], ...]   # (Δ, efficiency)
    rounds: int                    # golden-section rounds actually run
    interior: bool                 # coarse argmax strictly inside the grid

    def as_dict(self) -> dict:
        """JSON-ready dict, as ``repro``'s."""
        d = dataclasses.asdict(self)
        d["evaluations"] = [list(e) for e in self.evaluations]
        d["bracket"] = list(self.bracket)
        return d


def refine_optimal_window(spec: WindowSweep, *, L=None, n_v=None,
                          rounds: int = 4, polish_steps: int | None = None,
                          service=None, device=None, mesh=None,
                          dist=None) -> RefinedWindow:
    """Golden-section search for Δ*, issuing probes through the sweep service.

    ``spec.deltas`` is the coarse bracketing grid.  Every probe is a
    single-Δ ``WindowSweep`` submitted to a ``SweepService`` (``service=``
    to share one across calls; else a private one on ``device``, with
    ``mesh``/``dist`` for sharded probes), so the
    probes of a round coalesce into one pass, a re-probed Δ deduplicates,
    and the final polish (the winner re-measured with ``polish_steps``,
    default ``2 * spec.n_steps``) reuses the burned-in rows from the
    service's state cache.  The search runs only when the coarse argmax is
    interior; a boundary argmax is returned as it is with
    ``interior=False``.
    """
    from ..service import SweepService
    L = int(L if L is not None else spec.Ls[0])
    n_v = int(n_v if n_v is not None else spec.n_vs[0])
    cfg = PDESConfig(L=L, n_v=n_v, delta=math.inf, rd_mode=spec.rd_mode,
                     border_both=spec.border_both)
    burn = int(spec.burn_in_for(cfg))
    if service is None:
        service = SweepService(device=device, mesh=mesh, dist=dist)
    memo: dict[float, tuple[float, float, float]] = {}   # Δ -> (u, w, eff)
    evaluations: list[tuple[float, float]] = []

    def probe_spec(delta: float, n_steps: int) -> WindowSweep:
        return dataclasses.replace(
            spec, Ls=(L,), n_vs=(n_v,), deltas=(float(delta),),
            n_steps=int(n_steps), burn_in=burn)

    def evaluate(deltas, n_steps=spec.n_steps):
        new = [float(d) for d in deltas if float(d) not in memo]
        reqs = [service.submit(probe_spec(d, n_steps), requester="refiner")
                for d in new]
        if reqs:
            by_id = {r.request_id: r.result
                     for r in service.drain() if r.result is not None}
            for d, req in zip(new, reqs):
                rec = by_id[req.request_id].records[0]
                eff = float(efficiency(rec.u, rec.w))
                memo[d] = (float(rec.u), float(rec.w), eff)
                evaluations.append((d, eff))
        return [memo[float(d)][2] for d in deltas]

    # coarse pass: the spec's own grid, one coalesced pass
    grid = tuple(sorted(float(d) for d in spec.deltas))
    evaluate(grid)
    i = int(np.argmax([memo[d][2] for d in grid]))
    interior = 0 < i < len(grid) - 1
    finite = [d for d in grid if math.isfinite(d)]
    if not finite:
        raise ValueError("refinement needs at least one finite Δ in the grid")
    a = grid[i - 1] if i > 0 and math.isfinite(grid[i - 1]) else finite[0]
    b = grid[i + 1] if interior and math.isfinite(grid[i + 1]) else finite[-1]
    bracket = (a, b)

    done = 0
    if interior and b > a:
        c = b - _INV_PHI * (b - a)
        d = a + _INV_PHI * (b - a)
        evaluate([c, d])                      # both points, one shared pass
        for done in range(1, rounds + 1):
            if memo[float(c)][2] >= memo[float(d)][2]:
                b, d = d, c
                c = b - _INV_PHI * (b - a)
                evaluate([c])
            else:
                a, c = c, d
                d = a + _INV_PHI * (b - a)
                evaluate([d])

    best = max(memo, key=lambda d: memo[d][2])
    # polish: re-measure the winner with a longer series; its burned-in
    # rows come straight from the service state cache
    n_polish = int(polish_steps if polish_steps is not None
                   else 2 * spec.n_steps)
    resp = service.submit(probe_spec(best, n_polish), requester="refiner")
    rec = {r.request_id: r for r in service.drain()}[resp.request_id]
    rec = rec.result.records[0]
    eff_star = float(efficiency(rec.u, rec.w))
    evaluations.append((float(best), eff_star))
    return RefinedWindow(
        L=L, n_v=n_v, delta_star=float(best), eff_star=eff_star,
        u_star=float(rec.u), w_star=float(rec.w), bracket=bracket,
        evaluations=tuple(evaluations), rounds=done, interior=interior)
