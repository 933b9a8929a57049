"""End-to-end training entry point (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 300 --batch 8 --seq 256 --reduced --device cpu

Builds the Δ-window scheduler, the deterministic pipeline, the train step
and the fault-tolerant controller, on one device: the GPU unless
``--device cpu``.  Checkpoints go to ``--ckpt-dir`` (by default
``results/torch/ckpt`` under the working directory).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config
from ..data.pipeline import DataConfig, make_batch
from ..device import resolve_device
from ..distributed.delta_sync import DeltaScheduler, DeltaSyncConfig
from ..optim.adamw import AdamWConfig
from ..train.fault import FaultInjector, RecoveryConfig, TrainController
from ..train.train_step import init_train_state, make_train_step

DEFAULT_CKPT_DIR = "results/torch/ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="use the tiny smoke config (CPU-friendly)")
    ap.add_argument("--delta", type=float, default=4.0)
    ap.add_argument("--ckpt-dir", default=DEFAULT_CKPT_DIR)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--fail-at", type=int, nargs="*", default=[])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, ce_chunk=min(cfg.ce_chunk, args.seq))

    opt = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 20, 5),
                      total_steps=args.steps)
    model, step_fn = make_train_step(cfg, None, opt, device=dev, seed=0)
    state = init_train_state(model)
    n_params = sum(p.numel() for p in model.parameters())
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M devices=1 ({name})")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch)
    # the reference's max(device_count, 2) workers, on one device
    scheduler = DeltaScheduler(DeltaSyncConfig(n_workers=2, delta=args.delta))
    ctl = TrainController(
        step_fn, state, lambda s: make_batch(dc, s, dev),
        RecoveryConfig(ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every),
        scheduler=scheduler,
        injector=FaultInjector(tuple(args.fail_at)) if args.fail_at else None)

    t0 = time.time()
    log = ctl.run(args.steps)
    dt = time.time() - t0
    losses = [m["loss"] for m in log]
    print(f"steps={len(log)} restarts={ctl.restarts} "
          f"time={dt:.1f}s ({dt/max(len(log),1)*1e3:.0f} ms/step)")
    print(f"loss: first={losses[0]:.3f} last={losses[-1]:.3f} "
          f"min={min(losses):.3f}")
    print(f"Δ-window: utilization={scheduler.utilization:.3f} "
          f"gvt={scheduler.gvt:.1f} spread={scheduler.spread:.2f} (Δ={args.delta})")
    return log


if __name__ == "__main__":
    main()
