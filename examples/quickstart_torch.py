"""Quickstart of the PyTorch port: the paper's two scalability claims side
by side (the counterpart of ``examples/quickstart.py``).

Runs the Δ-window constrained conservative PDES and shows:
  * simulation phase: utilization stays finite as the ring grows;
  * measurement phase: the Δ-window bounds the time-horizon width that
    diverges without it.

Runs on the GPU; ``--device cpu`` runs it on the CPU (minutes there).

Usage: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

from repro_torch.core import PDESConfig, ensemble, theory

#: Ring sizes and window widths of the two sections.
LS = (32, 128, 512)
DELTAS = (5.0, 10.0)


def unconstrained(Ls, device):
    print("=== unconstrained (paper Secs. III, Korniss et al. 2000) ===")
    for L in Ls:
        ss = ensemble.steady_state(PDESConfig(L=L, n_v=1), n_trials=32,
                                   seed=L, measure_steps=1500, device=device)
        print(f"  L={L:4d}: utilization={ss.utilization:.4f} "
              f"(paper u_inf={theory.U_INF_KPZ_NV1:.4f})  width w={ss.w:.2f}"
              f"  <- width grows ~sqrt(L): measurement phase NOT scalable")


def constrained(deltas, Ls, device):
    print("=== Δ-window constrained (the paper's contribution) ===")
    for delta in deltas:
        for L in Ls:
            ss = ensemble.steady_state(
                PDESConfig(L=L, n_v=1, delta=delta), n_trials=32, seed=L,
                measure_steps=1500, device=device)
            print(f"  Δ={delta:5.1f} L={L:4d}: u={ss.utilization:.4f} "
                  f"w={ss.w:.2f} (bounded by Δ) rate={ss.rate:.3f}")


def capacity():
    print("=== capacity planning with the paper's own fits (Appendix) ===")
    for delta in (2.0, 10.0, 100.0):
        print(f"  Δ={delta:6.1f}: predicted cluster utilization "
              f"u_RD={float(theory.u_rd(delta)):.3f} "
              f"(what a Δ-window DP training cluster achieves with "
              f"Exp(1)-spread stragglers)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    unconstrained(LS, args.device)
    constrained(DELTAS, LS, args.device)
    capacity()


if __name__ == "__main__":
    main()
