"""End-to-end example of the PyTorch port: train mamba2-130m (about 130M
parameters) for a few hundred steps with the Δ-window scheduler, the
deterministic pipeline, checkpointing and, optionally, injected node
failures: ``examples/train_lm.py`` on ``repro_torch.launch.train``.

Usage:
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300      # on the GPU
  PYTHONPATH=src python examples/train_lm_torch.py --steps 300 --reduced \\
      --fail-at 100 --device cpu
"""
import argparse

from repro_torch.launch.train import DEFAULT_CKPT_DIR
from repro_torch.launch.train import main as train_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    args = ap.parse_args(argv)
    argv = ["--arch", "mamba2-130m",          # 130M params: the ~100M deliverable
            "--steps", str(args.steps), "--batch", "4", "--seq", "512",
            "--ckpt-every", "100", "--ckpt-dir", args.ckpt_dir]
    if args.reduced:
        argv.append("--reduced")
    if args.fail_at:
        argv += ["--fail-at"] + [str(s) for s in args.fail_at]
    if args.device is not None:
        argv += ["--device", args.device]
    return train_main(argv)


if __name__ == "__main__":
    main()
