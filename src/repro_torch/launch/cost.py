"""Per-rank cost of a PyTorch program: flops, bytes, collectives and peak
memory (port of ``repro.launch.hlo_cost``).

The reference parses the optimized HLO of a compiled SPMD program.  The
port runs the program (on real tensors, or on fake ones under
``FakeTensorMode``) inside ``CostCounter``, a ``TorchDispatchMode`` that
sees every aten op one rank runs.  For a DTensor op it steps aside
(returns ``NotImplemented``), so DTensor runs and the counter sees the
local ops on the rank's shards and the collectives DTensor issues: the
counts are per device, as the SPMD module's shapes are in the reference.
Ops that DTensor's sharding propagation runs to find an output's global
shape (under a fake mode: its own, or the caller's where one is active)
are not counted.

Accounting rules, the reference's where it has one:

* flops: ``2 · prod(out) · prod(contracting)`` per product op (``mm``,
  ``addmm``, ``bmm``, ``baddbmm``, ``mv``, ``dot``, ``convolution``;
  ``matmul`` and ``einsum`` reach the counter decomposed into those).
  Elementwise flops are ignored.
* bytes: inputs plus outputs of every op the rank runs, views excluded.
  This is eager PyTorch's traffic, each op reading and writing memory; a
  fused program (XLA's, the reference's count) moves less, so this is an
  upper bound on it.
* collectives: result bytes per op (operand bytes for reduce-scatter),
  per kind, and a message count, from the ``_c10d_functional`` ops that
  DTensor issues and the ``c10d`` ops of ``torch.distributed``.  Point to
  point traffic (``batch_isend_irecv``) does not pass the dispatcher:
  its callers report it (``Cost.add_collective``) as ``collective-permute``.
* memory: the bytes of every storage alive, from the tensors registered
  as arguments (``track``) and every op's outputs, freed when their last
  reference goes; ``peak_bytes`` is the most at once.
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
              "collective-permute")


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll: dict = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLL_KINDS})
    coll_msgs: float = 0.0

    def scaled(self, m: float) -> "Cost":
        return Cost(self.flops * m, self.bytes * m,
                    {k: v * m for k, v in self.coll.items()},
                    self.coll_msgs * m)

    def add(self, o: "Cost"):
        self.flops += o.flops
        self.bytes += o.bytes
        for k in COLL_KINDS:
            self.coll[k] += o.coll[k]
        self.coll_msgs += o.coll_msgs

    def add_collective(self, kind: str, n_bytes: float, msgs: int = 1):
        if kind not in self.coll:
            raise KeyError(kind)
        self.coll[kind] += n_bytes
        self.coll_msgs += msgs

    @property
    def coll_bytes(self) -> float:
        return sum(self.coll.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _product_flops(name: str, args, out) -> float:
    """``2 · prod(out) · prod(contracting)`` of one product op."""
    if name in ("mm", "addmm", "bmm", "baddbmm"):
        a = args[1] if name in ("addmm", "baddbmm") else args[0]
        return 2.0 * out.numel() * a.shape[-1]
    if name == "mv":
        return 2.0 * out.numel() * args[0].shape[-1]
    if name == "dot":
        return 2.0 * args[0].numel()
    if name == "convolution":
        w, transposed, groups = args[1], args[6], args[8]
        window = math.prod(w.shape[2:])
        cin = w.shape[0] // groups if transposed else w.shape[1]
        return 2.0 * out.numel() * cin * window
    return 0.0


# collective kind and the bytes it moves, by op name (funcol and c10d)
_FUNCOL = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
}
_NO_BYTES = {"wait_tensor", "detach", "alias", "lift_fresh",
             "_to_copy_if_needed"}


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _collective(ns: str, name: str, args, out):
    """``(kind, bytes)`` of a collective op, else None."""
    if ns == "_c10d_functional" or ns == "c10d_functional":
        kind = _FUNCOL.get(name)
        if kind is None:
            return None
        if kind == "reduce-scatter":
            return kind, sum(map(_nbytes, _tensors(args[0])))
        return kind, sum(map(_nbytes, _tensors(out)))
    if ns == "c10d":
        kind = _C10D.get(name)
        if kind is None:
            return None
        # in-place c10d ops: the output (or input) tensor lists come first
        if kind == "reduce-scatter":
            return kind, sum(map(_nbytes, _tensors(args[1])))
        return kind, sum(map(_nbytes, _tensors(args[0])))
    return None


def _in_propagation() -> bool:
    """Whether DTensor's shape propagation is on the call stack (it runs
    its fake ops under the caller's fake mode when one is active)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name == "_propagate_tensor_meta_non_cached":
            return True
        f = f.f_back
    return False


class CostCounter(TorchDispatchMode):
    """Counts what one rank runs into ``self.cost`` and ``peak_bytes``.

    ``with CostCounter() as c: step(...)``; ``c.track(tree)`` first
    registers the tensors that exist before (the arguments), so that the
    peak includes them.
    """

    def __init__(self):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        self._fake_on_entry = None

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        return super().__enter__()

    def _free(self, n: int):
        self.live_bytes -= n

    def _hold(self, t: torch.Tensor):
        local = getattr(t, "_local_tensor", t)
        try:
            st = local.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        n = st.nbytes()
        self._seen[st] = n
        weakref.finalize(st, self._free, n)
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, tree) -> int:
        """Register the tensors of ``tree`` as live; returns their bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._hold(t)
        return self.live_bytes - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # let DTensor lower to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        from torch._guards import active_fake_mode
        if active_fake_mode() is not self._fake_on_entry or \
                isinstance(func, torch._ops.HigherOrderOperator) or \
                (self._fake_on_entry is not None and _in_propagation()):
            return out                     # DTensor's shape propagation
        ns = func.namespace
        name = func._overloadpacket.__name__
        coll = _collective(ns, name, args, out)
        if coll is not None:
            self.cost.add_collective(*coll)
        elif ns == "aten":
            self.cost.flops += _product_flops(name, args, out)
            if not func.is_view and name not in _NO_BYTES:
                self.cost.bytes += sum(map(_nbytes, _tensors((args, kwargs))))
                self.cost.bytes += sum(map(_nbytes, _tensors(out)))
        if name != "wait_tensor":
            for t in _tensors(out):
                self._hold(t)
        return out
