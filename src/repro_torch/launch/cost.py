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

**Loops, counted once** (:func:`scan`; the reference's count is trip-count
aware in the same way: it costs a loop body once and multiplies by its
trip count).  The model's repeated bodies (the layer loops, the SSD chunk
loop, the chunked cross-entropy, flash's tile loops) run through
:func:`scan`, which is the plain loop unless a counter is counting on
fake tensors (``FakeTensorMode``, the dry run).  Then only three
representative iterations of each kind of body (``key``) run: the first,
the second weighted by the count of that kind less two, and the last;
the rest reuse the carry (same shapes and dtypes on fake tensors).  The
first stands apart because its carry may come in shaped or placed as no
later one's (a DTensor's placements settle after one layer), the last
because it closes the loop.  Under autograd, in the backward every op,
and every gradient accumulation the engine makes, is attributed to the
autograd node that runs (``torch._C._current_autograd_node``) and
weighted by that node's iteration, so the engine's accumulations at
iteration boundaries and into tensors every iteration reads (a shared
block's weights, the hidden states the cross-entropy slices) come out as
in the full loop: the first and last iterations carry the loop's two
boundaries, the middle one the iterations between.  Each skipped
iteration's own inputs (``xs``, its layer's parameter views) receive a
zero gradient from a stand-in node that counts nothing, as the full
loop's backward would give them one.

Memory: storages a weighted iteration allocates and leaves alive (the
activations autograd saves, a layer's KV slab) count times its weight
until freed, and so do the gradients of its parameters; a carry that
nothing saves counts once.  ``CostCounter(scale_loops=False)`` runs every
iteration (the full trace the scaled count is held against).
"""
from __future__ import annotations

import dataclasses
import math
import sys
import weakref
from collections import Counter as _Tally

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

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


#: counters inside their ``with`` block, innermost last
_ACTIVE: list = []


class CostCounter(TorchDispatchMode):
    """Counts what one rank runs into ``self.cost`` and ``peak_bytes``.

    ``with CostCounter() as c: step(...)``; ``c.track(tree)`` first
    registers the tensors that exist before (the arguments), so that the
    peak includes them.  ``scale_loops=False`` runs every iteration of a
    :func:`scan` even on fake tensors.
    """

    def __init__(self, *, scale_loops: bool = True):
        super().__init__()
        self.cost = Cost()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.scale_loops = scale_loops
        from torch.utils.weak import WeakIdKeyDictionary
        self._seen = WeakIdKeyDictionary()
        self._fake_on_entry = None
        self._mult = 1.0            # weight of the forward ops now
        self._born: list = []       # per weighted iteration: its records
        self._node_w: dict = {}     # _nkey(autograd node) -> weight

    def __enter__(self):
        from torch._guards import active_fake_mode
        self._fake_on_entry = active_fake_mode()
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    @property
    def scaling(self) -> bool:
        """Whether :func:`scan` counts loops once here: on fake tensors."""
        return self.scale_loops and self._fake_on_entry is not None

    def _release(self, rec):
        rec[2] = False
        self.live_bytes -= rec[0] * rec[1]

    def _hold(self, t: torch.Tensor):
        local = getattr(t, "_local_tensor", t)
        try:
            st = local.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        if st in self._seen:
            return
        rec = [st.nbytes(), 1.0, True]       # bytes, weight, alive
        self._seen[st] = rec
        weakref.finalize(st, self._release, rec)
        self.live_bytes += rec[0]
        for born in self._born:
            born.append(rec)
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _record_of(self, t):
        local = getattr(t, "_local_tensor", t)
        try:
            return self._seen.get(local.untyped_storage())
        except (RuntimeError, NotImplementedError):
            return None

    def _reweight(self, recs, w: float):
        """Live records ``recs`` count ``w`` times more from now on."""
        for rec in recs:
            if rec[2]:
                self.live_bytes += rec[0] * rec[1] * (w - 1)
                rec[1] *= w
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def track(self, tree) -> int:
        """Register the tensors of ``tree`` as live; returns their bytes."""
        before = self.live_bytes
        for t in _tensors(tree):
            self._hold(t)
        return self.live_bytes - before

    def _weight(self) -> float:
        """The weight of the op now: the forward's, times the weight of the
        autograd node the backward runs (1 for a node of no scaled
        iteration)."""
        node = torch._C._current_autograd_node()
        if node is None:
            return self._mult
        return self._mult * self._node_w.get(_nkey(node), 1.0)

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
        w = self._weight()
        if w == 0:
            return out                     # a stand-in: counts nothing
        ns = func.namespace
        name = func._overloadpacket.__name__
        coll = _collective(ns, name, args, out)
        if coll is not None:
            self.cost.add_collective(coll[0], w * coll[1], msgs=w)
        elif ns == "aten":
            self.cost.flops += w * _product_flops(name, args, out)
            if not func.is_view and name not in _NO_BYTES:
                self.cost.bytes += w * sum(map(_nbytes,
                                               _tensors((args, kwargs))))
                self.cost.bytes += w * sum(map(_nbytes, _tensors(out)))
        if name != "wait_tensor":
            for t in _tensors(out):
                self._hold(t)
        return out


def counting() -> CostCounter | None:
    """The innermost counter if it counts loops once (on fake tensors),
    else None."""
    return _ACTIVE[-1] if _ACTIVE and _ACTIVE[-1].scaling else None


class _StandIns(torch.autograd.Function):
    """Identity on ``anchor``; its backward gives the skipped iterations'
    inputs ``like`` a zero gradient, as the full loop's backward gives them
    one: at each flat position ``state["pos"]`` of an iteration's inputs
    that the middle representative read, shaped and placed as the middle
    one's gradient there (``state["spec"]``).  It stands between the first
    representative and the middle one, so its backward runs after the
    middle's; its node weighs nothing (registered by :func:`scan`)."""

    @staticmethod
    def forward(ctx, anchor, state, positions, *like):
        # what the zeros must look like, not the tensors: holding them
        # would keep their storage alive through the backward
        ctx.state = state
        ctx.like = [(j, _zeros_spec(t)) for j, t in zip(positions, like)]
        return anchor.view_as(anchor)

    @staticmethod
    def backward(ctx, g):
        pos, spec = ctx.state["pos"], ctx.state["spec"]
        return (g, None, None,
                *[_zeros_of(spec.get(j, sp)) if j in pos else None
                  for j, sp in ctx.like])


def _zeros_spec(t) -> tuple:
    from torch.distributed.tensor import DTensor
    if isinstance(t, DTensor):
        local = t._local_tensor
        return (tuple(local.shape), local.dtype, local.device,
                (t.device_mesh, tuple(t.placements), t.shape, t.stride()))
    return tuple(t.shape), t.dtype, t.device, None


def _zeros_of(spec):
    shape, dtype, device, dt = spec
    z = torch.zeros(shape, dtype=dtype, device=device)
    if dt is None:
        return z
    from torch.distributed.tensor import DTensor
    mesh, placements, gshape, gstride = dt
    return DTensor.from_local(z, mesh, placements, run_check=False,
                              shape=gshape, stride=gstride)


def _seq_now(c: CostCounter) -> int:
    """The sequence number the next autograd node gets (a probe that
    ``c`` does not count)."""
    outer, c._mult = c._mult, 0.0
    try:
        x = torch.zeros((), requires_grad=True)
        return x.view(()).grad_fn._sequence_nr() + 1
    finally:
        c._mult = outer


def _nkey(node):
    """A node's identity that does not rest on its Python wrapper: its
    sequence number (a leaf's accumulator: its tensor's)."""
    if type(node).__name__ == "AccumulateGrad":
        return ("leaf", id(node.variable))
    return node._sequence_nr()


def _nodes_of(outs, s0: int):
    """``(nodes, frontier)``: the autograd nodes made since sequence number
    ``s0`` that ``outs`` reach, by :func:`_nkey`, and ``{(key, nr):
    count}`` of their edges to older nodes."""
    nodes, frontier, stack = {}, _Tally(), []
    for t in _tensors(outs):
        if t.grad_fn is not None:
            stack.append(t.grad_fn)
    while stack:
        n = stack.pop()
        if _nkey(n) in nodes:
            continue
        nodes[_nkey(n)] = n
        for nf, nr in n.next_functions:
            if nf is None:
                continue
            if type(nf).__name__ == "AccumulateGrad" or \
                    nf._sequence_nr() < s0:
                frontier[(_nkey(nf), nr)] += 1
            else:
                stack.append(nf)
    return nodes, frontier


def _edge(t):
    from torch.autograd.graph import get_gradient_edge
    e = get_gradient_edge(t)
    return (_nkey(e.node), e.output_nr)


def scan(body, carry, n: int, *, xs=None, key=None, under_grad=True):
    """``for i in range(n): carry, y = body(i, carry)``; returns
    ``(carry, [y_0, ..., y_{n-1}])``.

    Under a counter counting on fake tensors only representative
    iterations run (module docstring); the others leave the carry as it
    is and repeat a representative's ``y`` (detached under autograd).
    ``key(i)`` names the body's kind where iterations differ (no
    gradient); ``xs[i]`` holds iteration ``i``'s own tensors, which a
    skipped iteration's stand-in gives a zero gradient.
    ``under_grad=False`` runs every iteration while autograd records: for
    a loop whose last iteration's output takes no gradient, whose backward
    then does not run (the three representatives stand for the full loop
    only when the last one's does).
    """
    c = counting()
    grad = torch.is_grad_enabled()
    if c is None or n < 3 or (grad and not under_grad):
        ys = []
        for i in range(n):
            carry, y = body(i, carry)
            ys.append(y)
        return carry, ys
    keys = [key(i) if key is not None else 0 for i in range(n)]
    if grad and len(set(keys)) != 1:
        raise ValueError("scan under autograd takes one kind of body")
    # per kind: the first (its carry may come in placed or shaped as no
    # later one's), the second for all between, the last
    reps = {}
    for k in dict.fromkeys(keys):
        idx = [i for i, kk in enumerate(keys) if kk == k]
        reps[idx[0]] = 1.0
        if len(idx) > 1:
            reps[idx[1]] = float(len(idx) - 2) if len(idx) > 2 else 1.0
            reps[idx[-1]] = 1.0
    ys, rep_y, first_nodes = [None] * n, {}, None
    state = {"pos": set(), "spec": {}}
    for i in range(n):
        if i not in reps:
            continue
        w = reps[i]
        if grad and i == 1 and xs is not None and n > 3:
            carry = _stand_in(c, carry, state, [
                (j, t) for k in range(2, n - 1)
                for j, t in enumerate(_tensors(xs[k])) if t.requires_grad])
        s0 = _seq_now(c) if grad else None
        born = []
        c._born.append(born)
        outer = c._mult
        c._mult = outer * w
        try:
            carry_new, y = body(i, carry)
        finally:
            c._mult = outer
            c._born.pop()
        # a carry that nothing saves (no autograd, not a y) is replaced,
        # not repeated
        keep = set() if grad else \
            {id(r) for r in map(c._record_of, _tensors(carry_new)) if r} - \
            {id(r) for r in map(c._record_of, _tensors(y)) if r}
        c._reweight([r for r in born if id(r) not in keep], w)
        if grad:
            nodes, frontier = _nodes_of((carry_new, y), s0)
            for key in nodes:
                c._node_w[key] = c._node_w.get(key, 1.0) * w
            if i == 1 and xs is not None:
                own = _tensors(xs[i])
                edges = {_edge(t): j for j, t in enumerate(own)
                         if t.requires_grad and _edge(t) in frontier}
                state["pos"] = set(edges.values())
                _weigh_param_grads(c, nodes, edges, w, first_nodes,
                                   state["spec"])
            first_nodes = first_nodes or nodes
        carry = carry_new
        ys[i] = y
        rep_y[keys[i]] = y
    for i in range(n):
        if ys[i] is None:
            y = rep_y[keys[i]]
            ys[i] = tree_map(lambda t: t.detach() if isinstance(
                t, torch.Tensor) else t, y) if grad else y
    return carry, ys


def _stand_in(c, carry, state, like):
    """``carry`` with its first gradient-carrying tensor passed through a
    :class:`_StandIns` node (weight 0) for ``like``, ``(position,
    tensor)`` pairs."""
    from torch.utils._pytree import tree_unflatten
    flat, spec = tree_flatten(carry)
    for j, t in enumerate(flat):
        if isinstance(t, torch.Tensor) and t.requires_grad:
            outer, c._mult = c._mult, 0.0      # its view counts nothing
            try:
                flat[j] = _StandIns.apply(t, state, [p for p, _ in like],
                                          *[u for _, u in like])
            finally:
                c._mult = outer
            c._node_w[_nkey(flat[j].grad_fn)] = 0.0
            break
    return tree_unflatten(flat, spec)


def _weigh_param_grads(c, nodes, edges, w, later, specs):
    """Hooks on the middle iteration's nodes: the gradients they send to
    its own inputs (``edges``: edge -> flat position) count ``w`` times in
    memory, as the ``w`` iterations' gradients would, until their consumer
    frees them, and their shapes and placements go to ``specs`` for the
    stand-ins.  The weight applies once the iteration's backward is over
    (when a node of ``later``, the iteration run before it, starts): the
    full loop frees an iteration's saved activations as it makes its
    gradients."""
    pending = []
    for node in nodes.values():
        slots = [(j, edges[(_nkey(nf), nr)])
                 for j, (nf, nr) in enumerate(node.next_functions)
                 if nf is not None and (_nkey(nf), nr) in edges]
        if slots:
            def hook(grad_inputs, grad_outputs, slots=slots):
                for j, pos in slots:
                    if grad_inputs[j] is not None:
                        pending.append(c._record_of(grad_inputs[j]))
                        specs[pos] = _zeros_spec(grad_inputs[j])
            node.register_hook(hook)

    def apply(grad_outputs):
        c._reweight([r for r in pending if r], w)
        pending.clear()

    for node in (later or {}).values():
        node.register_prehook(apply)
