"""Emit the paper's figure data from batched window sweeps, on the PyTorch
port (the counterpart of ``examples/paper_figures.py``).

Reproduces the qualitative content of the systematic study in
Kolakowska & Novotny (cs/0211013) with one ``WindowSweep`` per figure:

* ``fig_util_vs_L``        — steady-state utilization vs ring size L at
  fixed window Δ: u(L) levels off at a nonzero plateau (the computation
  phase scales), with the unconstrained Δ=inf curve as contrast.
* ``fig_w2_vs_delta``      — steady-state ⟨w²⟩ vs Δ at fixed L: the window
  bounds the virtual-time-horizon width, and the bound tightens as Δ
  shrinks (the measurement phase scales).
* ``fig_rate_vs_delta``    — average progress rate vs Δ: the constraint
  controls the rate of global progress.
* ``fig_efficiency_vs_delta`` — efficiency u/(1+w) vs Δ: an *interior* Δ*
  maximizes it, the paper's tuning-parameter claim
  (repro_torch.experiments.optimal_window).

Each figure's data is written to ``<out>/figures/<name>.json`` (``--out``,
default ``results/torch``); the qualitative claims are asserted before
writing, so a successful run is itself a reproduction check.  Runs on the
GPU unless ``--device cpu``.

Usage: PYTHONPATH=src python examples/paper_figures_torch.py [--fast]
           [--backend reference|pallas|pallas_multistep] [--device cpu]
           [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib

from repro_torch.experiments import (WindowSweep, find_optimal_window,
                                     run_window_sweep)


def _write(out_dir: pathlib.Path, name: str, payload: dict) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    p = out_dir / f"{name}.json"
    p.write_text(json.dumps(payload, indent=1))
    print(f"wrote {p}")


def _delta_key(d: float) -> str:
    return "inf" if math.isinf(d) else f"{d:g}"


def fig_util_vs_L(backend: str, fast: bool, device, out_dir) -> None:
    """u(L) at fixed Δ saturates with L (computation + measurement scale)."""
    Ls = (16, 32, 64, 128) if fast else (16, 32, 64, 128, 256)
    spec = WindowSweep(
        Ls=Ls, n_vs=(1, 10), deltas=(4.0, math.inf),
        replicas=8 if fast else 16, n_steps=200 if fast else 400,
        burn_in=400 if fast else None, backend=backend, seed=11)
    res = run_window_sweep(spec, device=device)
    curves = {}
    for n_v in spec.n_vs:
        for d in spec.deltas:
            recs = [r for r in res.select(n_v=n_v, delta=d)]
            recs.sort(key=lambda r: r.L)
            curves[f"nv{n_v}_d{_delta_key(d)}"] = {
                "L": [r.L for r in recs],
                "u": [r.u for r in recs],
                "u_err": [r.u_err for r in recs],
            }
    # claim: constrained utilization levels off at a nonzero plateau —
    # the last L-doubling moves u by a few percent at most.
    for n_v in spec.n_vs:
        u = curves[f"nv{n_v}_d4"]["u"]
        assert u[-1] > 0.1, u
        assert abs(u[-1] - u[-2]) < 0.1 * u[-2] + 0.02, u
    _write(out_dir, "fig_util_vs_L", {"spec_deltas": [_delta_key(d)
                                             for d in spec.deltas],
                             "curves": curves})


def _delta_sweep(backend: str, fast: bool,
                 device) -> tuple[WindowSweep, object]:
    deltas = ((0.5, 2.0, 8.0, math.inf) if fast
              else (0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, math.inf))
    spec = WindowSweep(
        Ls=(64,) if fast else (128,), n_vs=(1, 10), deltas=deltas,
        replicas=8 if fast else 16, n_steps=300 if fast else 600,
        burn_in=400 if fast else None, backend=backend, seed=29)
    return spec, run_window_sweep(spec, device=device)


def fig_w2_and_rate_vs_delta(spec, res, out_dir) -> None:
    """⟨w²⟩ bounded by the window and shrinking with Δ; rate controlled."""
    L = spec.Ls[0]
    w2_out, rate_out = {}, {}
    for n_v in spec.n_vs:
        recs = sorted(res.select(L=L, n_v=n_v), key=lambda r: r.delta)
        finite = [r for r in recs if not math.isinf(r.delta)]
        unc = [r for r in recs if math.isinf(r.delta)][0]
        key = f"L{L}_nv{n_v}"
        w2_out[key] = {
            "delta": [_delta_key(r.delta) for r in recs],
            "w2": [r.w2 for r in recs], "w2_err": [r.w2_err for r in recs],
            "spread": [r.spread for r in recs],
        }
        rate_out[key] = {
            "delta": [_delta_key(r.delta) for r in recs],
            "rate": [r.rate for r in recs],
            "rate_err": [r.rate_err for r in recs],
            "u": [r.u for r in recs],
        }
        # claims: (a) every *binding* window (Δ below the unconstrained
        # width — wider windows rarely act and just reproduce the
        # unconstrained noise) keeps ⟨w²⟩ at or below the unconstrained
        # saturation level, (b) tightening the window tightens the width —
        # ⟨w²⟩ is non-decreasing in Δ, and the smallest window beats the
        # widest by a clear margin, (c) the horizon extent obeys the hard
        # bound Δ + max increment for every finite Δ.
        binding = [r for r in finite if r.delta <= math.sqrt(unc.w2)]
        assert binding and all(r.w2 <= unc.w2 * 1.15 for r in binding), \
            w2_out[key]
        w2s = [r.w2 for r in finite]
        assert all(b >= a - 0.15 * max(a, 0.1)
                   for a, b in zip(w2s, w2s[1:])), w2s
        assert w2s[0] < 0.7 * max(w2s[-1], unc.w2), w2s
        eta_max = 25 * math.log(2)           # decode_words: -log(2^-25)
        assert all(r.spread <= r.delta + eta_max for r in finite), w2_out[key]
        # claim: the window throttles global progress — rate grows with Δ.
        rates = [r.rate for r in finite]
        assert rates[0] < rates[-1] + 1e-3, rates
    _write(out_dir, "fig_w2_vs_delta", w2_out)
    _write(out_dir, "fig_rate_vs_delta", rate_out)


def fig_efficiency_vs_delta(spec, res, out_dir) -> None:
    """Efficiency u/(1+w) has an interior maximizer Δ* (tuning parameter)."""
    out = {}
    interior_seen = False
    for n_v in spec.n_vs:
        ow = find_optimal_window(res, L=spec.Ls[0], n_v=n_v)
        out[f"L{ow.L}_nv{ow.n_v}"] = ow.as_dict()
        interior_seen |= ow.interior
        print(f"  L={ow.L} n_v={ow.n_v}: delta*={ow.delta_star:g} "
              f"eff={ow.eff_star:.4f} interior={ow.interior}")
    assert interior_seen, out   # the paper's claim: Δ* is a true optimum
    _write(out_dir, "fig_efficiency_vs_delta", out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--backend", default="pallas_multistep",
                    choices=["reference", "pallas", "pallas_multistep"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    ap.add_argument("--out", default="results/torch",
                    help="output directory (default: results/torch)")
    args = ap.parse_args(argv)
    out_dir = pathlib.Path(args.out) / "figures"
    fig_util_vs_L(args.backend, args.fast, args.device, out_dir)
    # shared by two figures
    spec, res = _delta_sweep(args.backend, args.fast, args.device)
    fig_w2_and_rate_vs_delta(spec, res, out_dir)
    fig_efficiency_vs_delta(spec, res, out_dir)
    print("all paper-figure claims hold")


if __name__ == "__main__":
    main()
