"""Aten graphs as one dataflow graph in the reference's vocabulary.

``make_fx`` (``tracing_mode="real"``, see ``probes.py``) gives a flat
``torch.fx`` graph of aten ops: the port's Python loops (the engine's K
steps, the shard body's chunks) are unrolled, and a kernel wrapper called
on CPU tensors appears as its plain version's ops (``markers.py``).  This
module turns it into a :class:`Graph` of :class:`Node`\\ s with the API of
the reference's (``src/repro/analysis/graph.py``): ``node``,
``ancestors``, ``find``, ``in_gids``, ``out_gids`` and
:func:`ring_axis_of`, so the rules read as the reference's do.

One table, :data:`ATEN_PRIMS`, maps aten op names to the reference's
primitive names (``aten.roll`` -> ``roll``, ``aten.amin`` ->
``reduce_min``, ``aten.where`` -> ``select_n`` with its operands in
``select_n``'s order, ``aten.slice``/``select`` -> ``slice`` with the
reference's ``start_indices``/``limit_indices``/``strides``); the marker
ops become ``ppermute`` and ``psum``/``pmin``/``pmax``.  An op outside the
table becomes ``unknown:<aten name>``, which every rule treats as
unanalysable: a rule that meets it on a path it must prove fails there,
never passes silently.  An in-place op's result replaces the mutated
tensor for the ops after it, with the old value among its deps.

Provenance: each node carries ``src`` (``file:line`` inside the port's
package, e.g. ``core/horizon.py:140``) and ``path`` (the port's functions
on the stack, outermost first), from the stack ``make_fx`` records where
the torch build lets it keep the port's frames (``probes._anchor_port``);
elsewhere both are empty, and no rule's verdict rests on them.

The graph over-approximates dataflow: a rule that finds no violating path
has proven its invariant for the traced shapes.
"""
from __future__ import annotations

import dataclasses
import operator
import re
from typing import Any

import torch

from .markers import NAMESPACE


@dataclasses.dataclass(frozen=True)
class Aval:
    """Shape and dtype name (``"float32"``, ``"int64"``, ``"bool"``)."""

    shape: tuple
    dtype: str


@dataclasses.dataclass
class Node:
    gid: int
    prim: str
    deps: list
    aval: Any = None          # Aval of the (first) output, or None
    params: dict = dataclasses.field(default_factory=dict)
    path: str = ""            # provenance: the port's calling functions
    src: str = ""             # provenance: "file:line" in the package

    def describe(self) -> str:
        s = self.prim
        if self.aval is not None:
            s += f" -> {self.aval.dtype}{list(self.aval.shape)}"
        return s


@dataclasses.dataclass
class Graph:
    nodes: list
    in_gids: list
    out_gids: list

    def node(self, gid: int) -> Node:
        return self.nodes[gid]

    def ancestors(self, gid: int) -> set:
        """All gids reachable backwards from ``gid`` (inclusive)."""
        seen, stack = set(), [gid]
        while stack:
            g = stack.pop()
            if g in seen:
                continue
            seen.add(g)
            stack.extend(self.nodes[g].deps)
        return seen

    def users(self) -> dict:
        """``{gid: [gids that read it]}``."""
        out = {n.gid: [] for n in self.nodes}
        for n in self.nodes:
            for d in n.deps:
                out[d].append(n.gid)
        return out

    def find(self, prim: str) -> list:
        return [n for n in self.nodes if n.prim == prim]


#: aten op name (the overload packet's) -> the reference's primitive
ATEN_PRIMS = {
    # elementwise arithmetic
    "add": "add", "sub": "sub", "mul": "mul", "div": "div", "neg": "neg",
    "abs": "abs", "exp": "exp", "log": "log", "log1p": "log1p",
    "sqrt": "sqrt", "rsqrt": "rsqrt", "floor": "floor", "ceil": "ceil",
    "round": "round", "sign": "sign", "tanh": "tanh", "sigmoid": "logistic",
    "pow": "pow", "square": "square", "remainder": "rem", "fmod": "rem",
    "maximum": "max", "minimum": "min", "clamp": "clamp",
    "clamp_min": "clamp", "clamp_max": "clamp",
    # comparisons and bits
    "eq": "eq", "ne": "ne", "lt": "lt", "le": "le", "gt": "gt", "ge": "ge",
    "isfinite": "is_finite",
    "bitwise_and": "and", "bitwise_or": "or", "bitwise_xor": "xor",
    "bitwise_not": "not", "logical_and": "and", "logical_or": "or",
    "logical_xor": "xor", "logical_not": "not",
    "__and__": "and", "__or__": "or", "__xor__": "xor",
    "__rshift__": "shift_right_logical",
    "bitwise_right_shift": "shift_right_logical",
    "__lshift__": "shift_left", "bitwise_left_shift": "shift_left",
    "where": "select_n",
    # dtype and copies
    "_to_copy": "convert_element_type", "to": "convert_element_type",
    "clone": "copy", "alias": "copy", "detach": "copy",
    "lift_fresh_copy": "copy", "contiguous": "copy", "copy": "copy",
    # views and layout
    "view": "reshape", "_unsafe_view": "reshape", "reshape": "reshape",
    "unsqueeze": "expand_dims", "squeeze": "squeeze",
    "permute": "transpose", "transpose": "transpose", "t": "transpose",
    "expand": "broadcast_in_dim",
    "slice": "slice", "select": "slice",
    "cat": "concatenate", "stack": "stack", "roll": "roll",
    # reductions
    "amin": "reduce_min", "amax": "reduce_max", "sum": "reduce_sum",
    "mean": "reduce_mean", "prod": "reduce_prod", "argmin": "argmin",
    "argmax": "argmax", "any": "reduce_or", "all": "reduce_and",
    "min": "reduce_min", "max": "reduce_max",
    # sources
    "arange": "iota", "scalar_tensor": "const", "full": "const",
    "zeros": "const", "ones": "const", "full_like": "const",
    "zeros_like": "const", "ones_like": "const", "empty": "const",
    "empty_like": "const", "tensor": "const",
    # indexing
    "index": "gather", "index_select": "gather", "gather": "gather",
    "scatter": "scatter", "scatter_add": "scatter", "index_put": "scatter",
}

_REDUCE = {"reduce_min", "reduce_max", "reduce_sum", "reduce_mean",
           "reduce_prod", "argmin", "argmax", "reduce_or", "reduce_and"}
_FILL = {"full": 1, "full_like": 1, "zeros": 0.0, "zeros_like": 0.0,
         "ones": 1.0, "ones_like": 1.0}


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def _aval_of(fx_node):
    val = fx_node.meta.get("val")
    if isinstance(val, (list, tuple)):
        val = val[0] if val and isinstance(val[0], torch.Tensor) else None
    if isinstance(val, torch.Tensor):
        return Aval(tuple(int(s) for s in val.shape), _dtype_name(val.dtype))
    return None


_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
_PKG = "repro_torch/"


def _provenance(stack_trace: str | None) -> tuple[str, str]:
    """``(path, src)`` of a node from the stack ``make_fx`` recorded: the
    port's frames (the analysis's own left out), outermost first."""
    if not stack_trace:
        return "", ""
    frames = []
    for file, line, fn in _FRAME.findall(stack_trace):
        i = file.rfind(_PKG)
        if i < 0 or file[i + len(_PKG):].startswith("analysis/"):
            continue
        frames.append((file[i + len(_PKG):], int(line), fn))
    if not frames:
        return "", ""
    path = "/" + "/".join(fn for _, _, fn in frames)
    return path, f"{frames[-1][0]}:{frames[-1][1]}"


def _norm_dim(d, rank: int) -> int:
    return d % rank if rank else 0


def _axes(dims, rank: int) -> tuple:
    if dims is None:
        return tuple(range(rank))
    if isinstance(dims, int):
        dims = (dims,)
    return tuple(sorted(_norm_dim(d, rank) for d in dims))


class _Builder:
    def __init__(self):
        self.nodes: list[Node] = []
        self.env: dict = {}            # fx node -> gid (or tuple of gids)

    def add(self, prim, deps, aval=None, params=None, path="", src=""):
        gid = len(self.nodes)
        self.nodes.append(Node(gid, prim, [d for d in deps if d is not None],
                               aval, params or {}, path, src))
        return gid

    def const(self, val, path="", src=""):
        aval = None
        if isinstance(val, torch.Tensor):
            aval = Aval(tuple(val.shape), _dtype_name(val.dtype))
        return self.add("const", [], aval=aval, params={"val": val},
                        path=path, src=src)

    def read(self, a, path, src):
        """gid of an fx argument (a node, or a constant made a node)."""
        if isinstance(a, torch.fx.Node):
            return self.env[a]
        return self.const(a, path, src)

    def call(self, n: torch.fx.Node) -> int:
        path, src = _provenance(n.meta.get("stack_trace"))
        target = n.target
        if target is operator.getitem:
            base = self.env[n.args[0]]
            return self.add("proj", [base], aval=_aval_of(n),
                            params={"index": n.args[1]}, path=path, src=src)
        aval = _aval_of(n)
        if not isinstance(target, torch._ops.OpOverload):
            deps = [self.env[a] for a in n.all_input_nodes]
            return self.add(f"unknown:{target}", deps, aval, path=path,
                            src=src)
        ns = target.namespace
        name = target._overloadpacket.__name__
        args = list(n.args)
        kw = dict(n.kwargs)
        if ns == NAMESPACE:
            x = self.read(args[0], path, src)
            if name == "ppermute":
                return self.add("ppermute", [x], aval, {
                    "shift": int(args[1]), "axis_name": (args[2],)},
                    path, src)
            return self.add("p" + args[1], [x], aval,
                            {"axes": (args[2],)}, path, src)
        inplace = name.endswith("_") and not name.startswith("_")
        base = name[:-1] if inplace else name
        prim = ATEN_PRIMS.get(base) if ns == "aten" else None
        if prim is None:
            deps = [self.env[a] for a in n.all_input_nodes]
            gid = self.add(f"unknown:{ns}.{name}", deps, aval, path=path,
                           src=src)
        else:
            gid = self._translate(prim, base, target, args, kw, aval, n,
                                  path, src)
        if inplace and isinstance(args[0], torch.fx.Node):
            old = self.env[args[0]]
            if old not in self.nodes[gid].deps:
                self.nodes[gid].deps.append(old)
            self.env[args[0]] = gid        # later readers see the new value
        return gid

    def _translate(self, prim, name, target, args, kw, aval, n, path, src):
        rd = lambda a: self.read(a, path, src)   # noqa: E731
        rank = len(aval.shape) if aval is not None else 0
        in_rank = len(_aval_of(args[0]).shape) \
            if args and isinstance(args[0], torch.fx.Node) and \
            _aval_of(args[0]) is not None else rank
        if prim == "const":
            if name in _FILL:
                fill = args[1] if name in ("full", "full_like") else \
                    _FILL[name]
                return self.add("const", [], aval, {"val": fill}, path, src)
            if name == "scalar_tensor":
                return self.add("const", [], aval, {"val": args[0]}, path,
                                src)
            return self.add("const", [], aval, {"val": None}, path, src)
        if prim == "iota":
            return self.add("iota", [], aval, {}, path, src)
        if prim == "select_n":
            c, x, y = args[0], args[1], args[2]
            return self.add("select_n", [rd(c), rd(y), rd(x)], aval, {},
                            path, src)
        if name == "rsub":
            return self.add("sub", [rd(args[1]), rd(args[0])], aval, {},
                            path, src)
        if prim in ("add", "sub") and kw.get("alpha", 1) != 1:
            deps = [rd(a) for a in args[:2]]
            return self.add(f"unknown:aten.{name}(alpha)", deps, aval, {},
                            path, src)
        if prim == "clamp":
            lo = args[1] if name != "clamp_max" and len(args) > 1 else \
                kw.get("min")
            hi = args[2] if name == "clamp" and len(args) > 2 else \
                (args[1] if name == "clamp_max" else kw.get("max"))
            return self.add("clamp", [rd(args[0])], aval,
                            {"min": lo, "max": hi}, path, src)
        if prim == "convert_element_type":
            return self.add(prim, [rd(args[0])], aval,
                            {"new_dtype": aval.dtype if aval else None},
                            path, src)
        if prim == "slice":
            x = args[0]
            shape = _aval_of(x).shape
            dim = _norm_dim(args[1] if len(args) > 1 else kw.get("dim", 0),
                            len(shape))
            starts = [0] * len(shape)
            limits = list(shape)
            strides = [1] * len(shape)
            if name == "select":
                i = args[2] % shape[dim]
                starts[dim], limits[dim] = i, i + 1
            else:
                size = shape[dim]
                start = args[2] if len(args) > 2 else kw.get("start")
                end = args[3] if len(args) > 3 else kw.get("end")
                step = args[4] if len(args) > 4 else kw.get("step", 1)
                start, end, step = slice(start, end, step).indices(size)
                starts[dim], limits[dim], strides[dim] = start, max(
                    end, start), step
            return self.add("slice", [rd(x)], aval, {
                "start_indices": tuple(starts),
                "limit_indices": tuple(limits), "strides": tuple(strides),
                "squeeze": name == "select"}, path, src)
        if prim in ("concatenate", "stack"):
            deps = [rd(a) for a in args[0]]
            dim = args[1] if len(args) > 1 else kw.get("dim", 0)
            return self.add(prim, deps, aval,
                            {"dimension": _norm_dim(dim, rank)}, path, src)
        if prim == "roll":
            shifts = args[1]
            dims = args[2] if len(args) > 2 else kw.get("dims", ())
            shifts = (shifts,) if isinstance(shifts, int) else tuple(shifts)
            dims = (dims,) if isinstance(dims, int) else tuple(dims)
            return self.add("roll", [rd(args[0])], aval, {
                "shifts": shifts,
                "dims": tuple(_norm_dim(d, rank) for d in dims)}, path, src)
        if prim in _REDUCE:
            dims = args[1] if len(args) > 1 else kw.get("dim")
            if name in ("min", "max") and len(args) == 1:
                dims = None
            if name in ("argmin", "argmax") and dims is None:
                dims = None
            return self.add(prim, [rd(args[0])], aval,
                            {"axes": _axes(dims, in_rank)}, path, src)
        if prim == "gather" and name == "index":
            deps = [rd(args[0])] + [rd(i) for i in args[1] if i is not None]
            return self.add("gather", deps, aval, {}, path, src)
        deps = []
        for a in list(args) + list(kw.values()):
            if isinstance(a, torch.fx.Node):
                deps.append(self.env[a])
            elif isinstance(a, (int, float, bool)) and not isinstance(
                    a, torch.dtype) and prim not in (
                    "reshape", "expand_dims", "squeeze", "transpose",
                    "broadcast_in_dim", "copy"):
                deps.append(self.const(a, path, src))
            elif isinstance(a, (list, tuple)) and prim not in (
                    "reshape", "expand_dims", "squeeze", "transpose",
                    "broadcast_in_dim"):
                deps.extend(self.env[x] for x in a
                            if isinstance(x, torch.fx.Node))
        return self.add(prim, deps, aval, {}, path, src)


def build_graph(gm: torch.fx.GraphModule) -> Graph:
    """Flatten a ``make_fx`` GraphModule into a :class:`Graph`."""
    from torch.utils._pytree import tree_flatten
    b = _Builder()
    in_gids, out_gids = [], []
    for n in gm.graph.nodes:
        if n.op == "placeholder":
            b.env[n] = b.add("input", [], aval=_aval_of(n),
                             params={"index": len(in_gids)})
            in_gids.append(b.env[n])
        elif n.op == "get_attr":
            b.env[n] = b.const(getattr(gm, n.target))
        elif n.op == "call_function":
            b.env[n] = b.call(n)
        elif n.op == "output":
            for o in tree_flatten(n.args[0])[0]:
                if isinstance(o, torch.fx.Node):
                    out_gids.append(b.env[o])
    return Graph(b.nodes, in_gids, out_gids)


def ring_axis_of(aval, ring_widths) -> int | None:
    """Axis index whose extent is a known ring width, else None.

    Probe shapes are chosen so ring widths collide with no other extent,
    making this lookup unambiguous (see probes.py).
    """
    shape = getattr(aval, "shape", None)
    if not shape:
        return None
    for ax in range(len(shape) - 1, -1, -1):   # ring rides the minor axis
        if shape[ax] in ring_widths:
            return ax
    return None
