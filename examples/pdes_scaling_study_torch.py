"""Scaling study of the PyTorch port: the shape of paper Figs. 5/6 at
laptop scale (the counterpart of ``examples/pdes_scaling_study.py``).

Sweeps (L, N_V, Δ), extrapolates u_inf, and compares with the paper's
composite fit Eq. (12).  Writes ``<out>/example_scaling.json`` (``--out``,
default ``results/torch``).

Usage: PYTHONPATH=src python examples/pdes_scaling_study_torch.py [--fast]
           [--backend reference|pallas|pallas_multistep] [--device cpu]
           [--out DIR]

``--backend`` routes every simulation through ``PDESEngine``
(``repro_torch.core.engine``) on the counter stream instead of the
threefry-keyed steps; on the GPU ``pallas_multistep`` is the fast path for
exactly this kind of sweep.  Runs on the GPU unless ``--device cpu``.
"""
import argparse
import json
import pathlib

from repro_torch.core import PDESConfig, ensemble, scaling, theory


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true")
    ap.add_argument("--backend", default=None,
                    choices=["reference", "pallas", "pallas_multistep"],
                    help="route the sweep through this PDESEngine backend")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    ap.add_argument("--out", default="results/torch",
                    help="output directory (default: results/torch)")
    args = ap.parse_args(argv)
    Ls = [32, 64, 128, 256] if args.fast else [64, 128, 256, 512, 1024]
    out = {"backend": args.backend or "legacy-horizon"}
    for delta in (5.0, 20.0):
        for nv in (1, 10, "rd"):
            us = []
            for L in Ls:
                cfg = PDESConfig(L=L, n_v=1 if nv == "rd" else nv,
                                 delta=delta, rd_mode=(nv == "rd"))
                ss = ensemble.steady_state(cfg, n_trials=16, seed=L,
                                           backend=args.backend,
                                           device=args.device)
                us.append(ss.utilization)
            ex = scaling.rational_extrapolate(Ls, us)
            nv_eff = 1e8 if nv == "rd" else nv
            fit = float(theory.u_composite(nv_eff, delta))
            out[f"delta{delta}_nv{nv}"] = {
                "L": Ls, "u": us, "u_inf": ex.u_inf, "paper_fit": fit}
            print(f"Δ={delta:5.1f} N_V={str(nv):>3s}: "
                  f"u(L): {', '.join(f'{u:.3f}' for u in us)}  "
                  f"-> u_inf={ex.u_inf:.3f}  paper Eq.(12)={fit:.3f}")
    p = pathlib.Path(args.out) / "example_scaling.json"
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(out, indent=1))
    print(f"wrote {p}")


if __name__ == "__main__":
    main()
