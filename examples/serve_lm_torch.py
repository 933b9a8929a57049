"""Batched serving demo of the PyTorch port: continuous batching with
Δ-window lane sync (the counterpart of ``examples/serve_lm.py``).

Serves a reduced llama3.2 model (random weights from a seeded generator —
the point is the engine path: prefill, KV-cache decode, lane scheduling,
bounded head-of-line blocking) and reports lane utilization vs the paper's
prediction.  Runs on the GPU; ``--device cpu`` runs it on the CPU.

Usage: PYTHONPATH=src python examples/serve_lm_torch.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config
from repro_torch.core.theory import u_rd
from repro_torch.models import build_model
from repro_torch.serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' to run there)")
    args = ap.parse_args(argv)
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device=args.device, seed=0)
    delta = 16.0
    eng = ServeEngine(model, batch_lanes=4, max_len=64, delta=delta,
                      device=args.device)
    rng = np.random.default_rng(0)
    for uid in range(8):
        eng.submit(Request(
            uid=uid,
            prompt=rng.integers(0, cfg.vocab_size, rng.integers(4, 12),
                                dtype=np.int32),
            max_new_tokens=int(rng.integers(4, 12))))
    results = eng.run()
    for uid in sorted(results):
        r = results[uid]
        print(f"request {uid}: {len(r.tokens)} tokens -> {r.tokens}")
    print(f"lane utilization: {eng.lane_utilization:.3f} "
          f"(paper fit u_RD(Δ={delta:.0f}) = {float(u_rd(delta)):.3f}) "
          f"on {eng.device}")


if __name__ == "__main__":
    main()
