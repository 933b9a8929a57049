"""Roofline terms of one rank's cost (port of ``repro.launch.roofline``).

    compute  = flops_per_device / BF16_FLOPS_PER_S
    memory   = bytes_per_device / HBM_BYTES_PER_S
    collect. = collective_bytes_per_device / NVLINK_BYTES_PER_S

The reference reads these from a compiled SPMD module; the port from the
``launch.cost.Cost`` of one rank's run (the counter yields the collective
bytes, so ``collective_bytes`` has no counterpart).  The peaks are one
NVIDIA H100 SXM's data-sheet rates at its full 700 W (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses

from .cost import Cost
from .mesh import BF16_FLOPS_PER_S, HBM_BYTES_PER_S, NVLINK_BYTES_PER_S


@dataclasses.dataclass
class Roofline:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    useful_ratio: float
    coll_detail: dict

    def to_dict(self):
        return dataclasses.asdict(self)


def analyze(cost: Cost, *, n_devices: int, model_flops: float) -> Roofline:
    """Roofline terms of one rank's ``cost`` (every rank runs the same
    program on its shard)."""
    flops, byts = cost.flops, cost.bytes
    t_c = flops / BF16_FLOPS_PER_S
    t_m = byts / HBM_BYTES_PER_S
    t_x = cost.coll_bytes / NVLINK_BYTES_PER_S
    dom = max((("compute", t_c), ("memory", t_m), ("collective", t_x)),
              key=lambda kv: kv[1])[0]
    useful = model_flops / (flops * n_devices) if flops else 0.0
    return Roofline(
        flops_per_dev=flops, bytes_per_dev=byts,
        coll_bytes_per_dev=cost.coll_bytes,
        compute_s=t_c, memory_s=t_m, collective_s=t_x, dominant=dom,
        model_flops=model_flops, useful_ratio=useful,
        coll_detail=dict(cost.coll, msgs=cost.coll_msgs),
    )


def model_flops_for(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D train / 2·N·D prefill / 2·N·B decode (per step)."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch      # decode: one token per lane
