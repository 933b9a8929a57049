"""Marker ops: the linter's stand-ins for the sharded runtime's collectives.

The reference's graphs carry ``shard_map`` bodies with ``ppermute`` and
``psum``/``pmin`` equations, and ``pallas_call`` nodes with the kernel's
body inlined.  An aten graph of the port has neither: its collectives go
through ``torch.distributed``, which ``make_fx`` does not record as
dataflow, and its kernels are ctypes calls.  So:

* **Collectives.**  This module defines two ops in the ``repro_analysis``
  ``torch.library`` namespace, which only the analysis imports:
  ``ppermute(x, shift, axis)`` (a halo: shard ``i``'s ``x`` arrives at
  shard ``i + shift`` of the ring axis) and ``ring_reduce(x, op, axis)``
  (an all-reduce along the axis: the GVT's MIN, the stats' SUM).
  :class:`AnalysisRing` is a ``core.distributed._Ring`` whose ``halo`` and
  ``all_reduce`` emit them, so one rank's ``_shard_body`` traces with no
  process group: every collective of the body passes through the ring.
  Their values here are the operand's own (a ring of one): the analysis
  computes no result, it reads the graph.
* **Kernels.**  On CPU tensors a kernel wrapper runs its kernel's plain
  version (``kernels/ref.py``), so the traced graph holds the plain
  version's ops in the kernel's place, as the reference inlines a
  ``pallas_call``'s body: the rules prove their invariants over the plain
  version, and ``chip_smoke.py`` holds each kernel bit for bit against it
  on the card.  The kernel itself enters through its wrapper's
  ``launch_plan``, which the probes record at every call and the
  ``vmem-budget`` rule reads (``probes.py``).
"""
from __future__ import annotations

import torch

from ..core.distributed import _Ring

NAMESPACE = "repro_analysis"

#: ``torch.distributed.ReduceOp`` names the ring's all-reduces take
REDUCE_OPS = ("sum", "min", "max")


@torch.library.custom_op(f"{NAMESPACE}::ppermute", mutates_args=())
def ppermute(x: torch.Tensor, shift: int, axis: str) -> torch.Tensor:
    """Shard ``i``'s ``x`` to shard ``i + shift`` along ``axis`` (a marker:
    returns a copy of ``x``)."""
    return x.clone()


@ppermute.register_fake
def _(x, shift, axis):
    return torch.empty_like(x)


@torch.library.custom_op(f"{NAMESPACE}::ring_reduce", mutates_args=())
def ring_reduce(x: torch.Tensor, op: str, axis: str) -> torch.Tensor:
    """``x`` reduced with ``op`` (one of :data:`REDUCE_OPS`) across the
    shards of ``axis`` (a marker: returns a copy of ``x``)."""
    if op not in REDUCE_OPS:
        raise ValueError(f"op must be one of {REDUCE_OPS}, got {op!r}")
    return x.clone()


@ring_reduce.register_fake
def _(x, op, axis):
    return torch.empty_like(x)


class AnalysisRing(_Ring):
    """Shard ``i`` of a ring of ``n`` along ``axis`` whose collectives are
    the marker ops: a halo is two ``ppermute``s, an all-reduce one
    ``ring_reduce``."""

    def __init__(self, n: int, i: int, axis: str = "model"):
        self.n, self.i, self.axis = n, i, axis

    def halo(self, tau, w: int):
        # the left neighbour's last w columns travel one shard right, the
        # right neighbour's first w one shard left
        return (ppermute(tau[:, -w:].contiguous(), 1, self.axis),
                ppermute(tau[:, :w].contiguous(), -1, self.axis))

    def all_reduce(self, x, op):
        import torch.distributed as tdist
        name = {tdist.ReduceOp.SUM: "sum", tdist.ReduceOp.MIN: "min",
                tdist.ReduceOp.MAX: "max"}[op]
        return ring_reduce(x, name, self.axis)
