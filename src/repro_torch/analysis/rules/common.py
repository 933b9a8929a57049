"""Shared helpers for the analysis rules."""
from __future__ import annotations

import numpy as np
import torch

from ..graph import Graph, ring_axis_of
from ..probes import Probe

#: prims whose output is just their (first) input, re-viewed
PASSTHROUGH = frozenset({
    "proj", "copy", "convert_element_type", "reshape", "squeeze",
    "expand_dims", "transpose", "broadcast_in_dim",
})

#: order-preserving elementwise prims (hull semantics for both analyses)
ELEMENTWISE = frozenset({
    "add", "sub", "mul", "div", "max", "min", "neg", "abs", "exp", "log",
    "log1p", "sqrt", "rsqrt", "floor", "ceil", "round", "sign", "tanh",
    "logistic", "pow", "rem", "and", "or", "xor", "not",
    "shift_right_logical", "shift_left", "select_n", "eq", "ne", "lt", "le",
    "gt", "ge", "clamp", "is_finite", "square",
})

RING_REDUCE = frozenset({"reduce_min", "reduce_max", "reduce_sum",
                         "reduce_mean", "reduce_prod", "reduce_and",
                         "reduce_or", "argmin", "argmax"})

NAMED_REDUCE = frozenset({"psum", "pmin", "pmax"})

_WIDE = ("float64", "int64", "uint64", "complex128")


def dtype_of(node) -> str:
    return getattr(node.aval, "dtype", "") if node is not None else ""


def is_float(node) -> bool:
    return dtype_of(node).startswith(("float", "bfloat"))


def is_wide(node) -> bool:
    """A 64-bit result."""
    return dtype_of(node) in _WIDE


def dep_ring_axis(graph: Graph, node, probe: Probe):
    """Ring axis index of a node's first dep, else None."""
    if not node.deps:
        return None
    return ring_axis_of(graph.node(node.deps[0]).aval, probe.ring_widths)


def named_axes(node) -> tuple:
    ax = node.params.get("axes", node.params.get("axis_name", ()))
    if isinstance(ax, (str, int)):
        ax = (ax,)
    return tuple(ax)


def is_ring_reduction(graph: Graph, node, probe: Probe) -> bool:
    """True for a reduction that collapses the ring axis (the GVT channel)."""
    if node.prim in RING_REDUCE:
        dax = dep_ring_axis(graph, node, probe)
        return dax is not None and dax in tuple(node.params.get("axes", ()))
    if node.prim in NAMED_REDUCE:
        return any(a in probe.shard_L for a in named_axes(node))
    return False


def ring_min_gids(graph: Graph, probe: Probe) -> set:
    """gids of min-reductions over the ring — the sanctioned window base."""
    out = set()
    for n in graph.nodes:
        if n.prim in ("reduce_min", "pmin") and \
                is_ring_reduction(graph, n, probe):
            out.add(n.gid)
    return out


def tau_io(graph: Graph, probe: Probe):
    """(tau input gid, tau output gid) of a probe."""
    return graph.in_gids[probe.tau_in], graph.out_gids[probe.tau_out]


def const_bounds(val):
    """(lo, hi) of a numeric constant, else None."""
    try:
        if isinstance(val, torch.Tensor):
            if val.numel() == 0 or val.dtype == torch.bool:
                return (0.0, 1.0) if val.dtype == torch.bool else None
            return float(val.min()), float(val.max())
        a = np.asarray(val)
        if a.size == 0 or not (np.issubdtype(a.dtype, np.number)
                               or a.dtype == bool):
            return None
        return float(a.min()), float(a.max())
    except Exception:
        return None


def where(node) -> str:
    """Provenance string for a finding."""
    loc = node.path or "/"
    if node.src:
        loc += f" ({node.src})"
    return loc
