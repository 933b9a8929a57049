"""stencil-locality: tau updates may reach only {i-1, i, i+1} ring neighbors.

Toroczkai et al. show the horizon statistics are set by the communication
stencil itself, so a leaked next-nearest-neighbor dependence is a correctness
bug even when short parity tests pass.  This rule proves the nearest-neighbor
property by abstract interpretation of the aten graph, as the reference's
does of the jaxpr.

Abstraction ("ring reach"): every value is either

* ``None`` — no per-site dependence on tau (event bits, iotas, constants,
  and full-ring reductions: the GVT/window channel is *uniform* across the
  ring and is the paper's sanctioned global constraint, so it does not count
  toward the stencil); or
* ``(lo, hi)`` — output position ``p`` depends only on tau sites
  ``[p + lo, p + hi]`` (ring coordinates, global across shards); or
* ``TOP`` — an un-analyzable ring-indexed op was hit (conservative fail).

Transfer highlights:

* ``roll`` by ``s`` on the ring axis moves reach by ``-s``, normalised mod
  the true ring size ``L``: ``torch.roll(tau, 1)`` is the left neighbour,
  reach ``(-1, -1)``.
* ``slice`` by start ``s`` on the ring axis shifts reach by ``+s``;
  ``concatenate`` shifts each piece by ``-offset`` and takes the hull after
  normalizing each contribution mod ``L`` — this makes circular constructs
  *exact*: the wrap halo ``cat([tau[:,-1:], tau, tau[:,:1]])`` comes out as
  the degenerate reach ``(-1, -1)``.
* the clamp-pad ``cat([x[:,:1], x, x[:,-1:]])`` of the communication-
  avoiding mode is recognized structurally and treated as alignment-shifting
  only (the duplicated edge values lie within the strip's existing reach).
* the ``ppermute`` marker by a shard shift ``s`` moves reach by
  ``-s * L_local`` (so a distance-2 permute shows up as a reach of
  ``2 * L_local``).
* the port's step loops are unrolled in the graph, so the check is *per
  advance*: at every advance site ``tau' = v + where(update, eta, 0)``,
  ``reach(tau') - reach(v)`` must lie within ``[-1, +1]`` (the role the
  reference gives its loop carries), and the probe's tau output must end
  within ``[-n, +n]`` for the ``n`` advances on its longest path.
"""
from __future__ import annotations

from ..graph import Graph, ring_axis_of
from ..probes import Probe
from ..report import Finding
from .common import (ELEMENTWISE, NAMED_REDUCE, PASSTHROUGH, RING_REDUCE,
                     is_float, is_ring_reduction, named_axes, tau_io, where)

RULE = "stencil-locality"
TOP = "TOP"


def _hull(reaches):
    acc = None
    for r in reaches:
        if r is None:
            continue
        if r == TOP or acc == TOP:
            return TOP
        acc = r if acc is None else (min(acc[0], r[0]), max(acc[1], r[1]))
    return acc


def _shift(r, s):
    if r is None or r == TOP:
        return r
    return (r[0] + s, r[1] + s)


def _norm(r, L):
    """Normalize a reach interval mod the ring size (midpoint near 0)."""
    if r is None or r == TOP or L <= 0:
        return r
    k = round(((r[0] + r[1]) / 2) / L)
    return (r[0] - k * L, r[1] - k * L)


def _is_clamp_pad(graph, node):
    """concat([x[:, :1], x, x[:, -1:]], axis) -> gid of x, else None."""
    if len(node.deps) != 3:
        return None
    a, x, b = (graph.node(d) for d in node.deps)
    dim = node.params.get("dimension")
    for edge, start_at_end in ((a, False), (b, True)):
        if edge.prim != "slice" or not edge.deps or edge.deps[0] != x.gid:
            return None
        xs = x.aval.shape
        starts = edge.params.get("start_indices", ())
        limits = edge.params.get("limit_indices", ())
        if dim is None or dim >= len(starts):
            return None
        want = (xs[dim] - 1, xs[dim]) if start_at_end else (0, 1)
        if (starts[dim], limits[dim]) != want:
            return None
    return x.gid


def advance_of(graph, n):
    """For an advance site ``v + where(update, eta, 0)`` (a float ``add``
    with a float ``select_n`` operand): the gid of ``v``, else None."""
    if n.prim != "add" or len(n.deps) != 2 or not is_float(n):
        return None
    a, b = (graph.node(d) for d in n.deps)
    if b.prim == "select_n" and is_float(b):
        return a.gid
    if a.prim == "select_n" and is_float(a):
        return b.gid
    return None


def _compute_reach(graph: Graph, probe: Probe):
    tau_in, _ = tau_io(graph, probe)
    L = probe.L_ring
    reach: dict[int, object] = {}
    top_origin: dict[int, int] = {}   # gid -> gid of first-TOP ancestor

    def mark_top(n, deps_r):
        for d, r in zip(n.deps, deps_r):
            if r == TOP:
                return top_origin.get(d, d)
        return n.gid

    for n in graph.nodes:
        deps_r = [reach.get(d) for d in n.deps]
        r = None
        dep = graph.node(n.deps[0]) if n.deps else None
        if n.prim == "input":
            r = (0, 0) if n.gid == tau_in else None
        elif n.prim in ("const", "iota"):
            r = None
        elif n.prim == "ppermute":
            if deps_r and deps_r[0] is not None:
                s = n.params.get("shift")
                L_l = None
                for a in named_axes(n):
                    L_l = probe.shard_L.get(a, L_l)
                r = TOP if s is None or L_l is None else \
                    _norm(_shift(deps_r[0], -s * L_l), L)
        elif n.prim in RING_REDUCE or n.prim in NAMED_REDUCE:
            if is_ring_reduction(graph, n, probe):
                r = None              # the sanctioned global (window) channel
            else:
                r = _hull(deps_r)
        elif n.prim == "roll":
            dr = deps_r[0] if deps_r else None
            if dr in (None, TOP):
                r = dr
            else:
                rax = ring_axis_of(dep.aval, probe.ring_widths)
                r = dr
                for s, d in zip(n.params.get("shifts", ()),
                                n.params.get("dims", ())):
                    if d == rax:
                        r = _norm(_shift(r, -s), L)
        elif n.prim == "slice":
            dr = deps_r[0] if deps_r else None
            if dr in (None, TOP):
                r = dr
            else:
                rax = ring_axis_of(dep.aval, probe.ring_widths)
                if rax is None:
                    r = dr             # slicing non-ring axes only
                else:
                    starts = n.params.get("start_indices", ())
                    strides = n.params.get("strides") or (1,) * len(starts)
                    r = TOP if strides[rax] != 1 else _shift(dr, starts[rax])
        elif n.prim == "concatenate":
            if all(dr is None for dr in deps_r):
                r = None
            else:
                dim = n.params.get("dimension")
                rax = ring_axis_of(n.aval, probe.ring_widths)
                dax = ring_axis_of(dep.aval, probe.ring_widths)
                if dim != rax and dim != dax:
                    r = _hull(deps_r)  # stacking along a non-ring axis
                else:
                    pad_of = _is_clamp_pad(graph, n)
                    if pad_of is not None:
                        r = _shift(reach.get(pad_of), -1)
                    else:
                        off, parts = 0, []
                        for d, dr in zip(n.deps, deps_r):
                            w = graph.node(d).aval.shape[dim]
                            if dr is not None:
                                parts.append(_norm(_shift(dr, -off), L))
                            off += w
                        r = _hull(parts)
        elif n.prim in ("gather", "scatter"):
            has_ring_dep = any(dr is not None for dr in deps_r)
            ring_indexed = dep is not None and \
                ring_axis_of(dep.aval, probe.ring_widths) is not None
            r = TOP if (has_ring_dep and ring_indexed) else _hull(deps_r)
        elif n.prim in PASSTHROUGH or n.prim in ELEMENTWISE or \
                n.prim == "stack":
            r = _hull(deps_r)
        else:
            # unknown op: conservative only if it actually consumes tau-reach
            r = _hull(deps_r)
            if r is not None:
                r = TOP
        reach[n.gid] = r
        if r == TOP:
            top_origin[n.gid] = mark_top(n, deps_r)
    return reach, top_origin


def _fmt(r):
    if r == TOP:
        return "unbounded"
    return f"[{r[0]:+d}, {r[1]:+d}]"


def check(probe: Probe, **_) -> list:
    graph = probe.graph
    reach, top_origin = _compute_reach(graph, probe)
    findings = []

    def blame(gid, msg):
        origin = top_origin.get(gid, gid)
        n = graph.node(origin)
        findings.append(Finding(
            rule=RULE, message=msg, op=n.prim, path=where(n)))

    # per-step growth at every advance site (the unrolled step loop)
    depth: dict[int, int] = {}
    for n in graph.nodes:
        v = advance_of(graph, n)
        depth[n.gid] = max((depth[d] for d in n.deps), default=0) + \
            (v is not None)
        if v is None:
            continue
        r_in, r_out = reach.get(v), reach.get(n.gid)
        if r_out == TOP or r_in == TOP:
            blame(n.gid if r_out == TOP else v,
                  "ring-indexed op defeats stencil analysis on a tau "
                  "update")
            continue
        if r_in is None or r_out is None:
            continue
        glo, ghi = r_out[0] - r_in[0], r_out[1] - r_in[1]
        if glo < -1 or ghi > 1:
            blame(n.gid, f"per-step ring reach grows by [{glo:+d}, {ghi:+d}]"
                         " (allowed [-1, +1]): data flows beyond nearest "
                         "neighbors in one step")

    # the probe's tau output itself
    _, tau_out = tau_io(graph, probe)
    r = reach.get(tau_out)
    n_adv = max(depth.get(tau_out, 0), 1)
    if r == TOP:
        blame(tau_out, "tau output depends on tau through an un-analyzable "
                       "ring-indexed op")
    elif r is not None and (r[0] < -n_adv or r[1] > n_adv):
        blame(tau_out, f"tau output reaches ring neighbors {_fmt(r)} "
                       f"(allowed [-{n_adv}, +{n_adv}] after {n_adv} "
                       "advance(s))")
    return findings
