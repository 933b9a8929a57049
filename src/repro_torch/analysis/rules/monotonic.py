"""tau-monotonicity: no dataflow path may decrease a local virtual time.

Conservative PDES correctness requires every PE's local virtual time to be
non-decreasing: a tau write must be the old value plus a provably
non-negative increment (or a guarded select between such values).  The
rule combines two analyses over the aten graph, as the reference's does:

* **interval analysis** — forward value ranges seeded from dtype bounds,
  clamped to the dtype after every op; an integer op that can overflow
  its dtype (the int64-carried hash's products wrap) goes to the dtype's
  whole range, and a bitwise ``and`` with a non-negative mask bounds the
  result by the mask whatever the other operand's sign, so the hash's
  words come out in ``[0, 2^32)``.  This is what proves the exponential
  increment positive through the port's decode (``core/horizon.py``):
  ``k = w1 >> 8`` lies in ``[0, 2^24)``, ``fp32(k) * 2^-24 + 2^-25`` in
  ``(0, 1]``, so ``-log`` of it (in fp64, cast back to fp32) is
  ``>= 0``.
* **monotone walk** — a memoized structural recursion from the tau
  output: the old tau value may flow through views, slices, rolls,
  concatenations and stacks (halos select tau *values*, they never scale
  them), the halo marker and selects; it may be combined only via ``add``
  with an interval-non-negative term, ``max``, or — the one sanctioned
  decrease — subtraction of the *ring-uniform* rebase shift (a ring min
  reduction: subtracting the global minimum shifts all clocks equally).

The port's Python loops are unrolled in the graph, so the walk from the
tau output passes every step's tau on its way to the input: each step is
checked.  Any other path (e.g. the seeded ``eta - 1.0`` fixture) fails
with the offending node as witness.
"""
from __future__ import annotations

import math

from ..probes import Probe
from ..report import Finding
from .common import PASSTHROUGH, const_bounds, dtype_of, ring_min_gids, \
    tau_io, where

RULE = "tau-monotonicity"

_UNK = (-math.inf, math.inf)

_DTYPE_RANGE = {
    "uint8": (0, 2**8 - 1), "uint16": (0, 2**16 - 1),
    "uint32": (0, 2**32 - 1), "uint64": (0, 2**64 - 1),
    "int8": (-2**7, 2**7 - 1), "int16": (-2**15, 2**15 - 1),
    "int32": (-2**31, 2**31 - 1), "int64": (-2**63, 2**63 - 1),
    "bool": (0, 1),
}


def _clamp(iv, node):
    rng = _DTYPE_RANGE.get(dtype_of(node))
    if rng is None:
        return iv
    if iv[0] < rng[0] or iv[1] > rng[1]:
        # an integer result past its dtype wraps: any value of the dtype
        return rng if dtype_of(node) != "bool" else (0, 1)
    return iv


def _mul(a, b):
    cands = [a[0] * b[0], a[0] * b[1], a[1] * b[0], a[1] * b[1]]
    cands = [c for c in cands if not math.isnan(c)]
    return (min(cands), max(cands)) if cands else _UNK


def _log(iv):
    lo = math.log(iv[0]) if iv[0] > 0 else -math.inf
    hi = math.log(iv[1]) if iv[1] > 0 else -math.inf
    return (lo, hi)


def _bits(hi) -> int:
    return int(hi).bit_length() if math.isfinite(hi) else 10**6


def _hull(d):
    return (min((x[0] for x in d), default=-math.inf),
            max((x[1] for x in d), default=math.inf)) if d else _UNK


def compute_intervals(graph) -> dict:
    """Forward value ranges per gid (dtype-clamped after every transfer)."""
    iv: dict[int, tuple] = {}
    for n in graph.nodes:
        d = [iv.get(g, _UNK) for g in n.deps]
        r = _UNK
        p = n.prim
        if p == "const":
            r = const_bounds(n.params.get("val")) or _UNK
        elif p == "input":
            r = _DTYPE_RANGE.get(dtype_of(n), _UNK)
        elif p == "iota":
            shape = getattr(n.aval, "shape", None) or (1,)
            r = (0, max(shape) - 1)
        elif p in PASSTHROUGH or p in (
                "slice", "concatenate", "stack", "roll", "reduce_min",
                "reduce_max", "reduce_mean", "pmin", "pmax", "ppermute"):
            r = _hull(d)
        elif p == "add" and len(d) == 2:
            r = (d[0][0] + d[1][0], d[0][1] + d[1][1])
        elif p == "sub" and len(d) == 2:
            r = (d[0][0] - d[1][1], d[0][1] - d[1][0])
        elif p == "mul" and len(d) == 2:
            r = _mul(d[0], d[1])
        elif p == "div" and len(d) == 2 and d[1][0] > 0:
            r = _mul(d[0], (1.0 / d[1][1], 1.0 / d[1][0]))
        elif p == "neg":
            r = (-d[0][1], -d[0][0])
        elif p == "abs":
            lo = 0.0 if d[0][0] <= 0 <= d[0][1] else min(abs(d[0][0]),
                                                         abs(d[0][1]))
            r = (lo, max(abs(d[0][0]), abs(d[0][1])))
        elif p == "exp":
            r = (math.exp(min(d[0][0], 700)), math.exp(min(d[0][1], 700)))
        elif p == "log":
            r = _log(d[0])
        elif p == "sqrt":
            r = (math.sqrt(max(d[0][0], 0)),
                 math.sqrt(max(d[0][1], 0)) if d[0][1] >= 0 else 0.0)
        elif p == "max" and len(d) == 2:
            r = (max(d[0][0], d[1][0]), max(d[0][1], d[1][1]))
        elif p == "min" and len(d) == 2:
            r = (min(d[0][0], d[1][0]), min(d[0][1], d[1][1]))
        elif p == "clamp":
            lo, hi = n.params.get("min"), n.params.get("max")
            r = (max(d[0][0], lo) if lo is not None else d[0][0],
                 min(d[0][1], hi) if hi is not None else d[0][1])
        elif p == "shift_right_logical" and len(d) == 2:
            if d[1][0] == d[1][1] and float(d[1][0]).is_integer() \
                    and d[0][0] >= 0 and math.isfinite(d[0][1]):
                s = int(d[1][0])
                r = (int(d[0][0]) >> s, int(d[0][1]) >> s)
        elif p == "shift_left" and len(d) == 2:
            if d[1][0] == d[1][1] and float(d[1][0]).is_integer() \
                    and d[0][0] >= 0 and math.isfinite(d[0][1]):
                s = int(d[1][0])
                r = (int(d[0][0]) << s, int(d[0][1]) << s)
        elif p == "and" and dtype_of(n) != "bool":
            masks = [x[1] for x in d if x[0] >= 0]
            if masks:              # a non-negative mask bounds the result
                r = (0, min(masks))
        elif p in ("or", "xor") and dtype_of(n) != "bool":
            if d and all(x[0] >= 0 for x in d):
                r = (0, 2 ** max(_bits(x[1]) for x in d) - 1)
        elif p == "rem" and len(d) == 2:
            if d[1][0] > 0:
                r = (0 if d[0][0] >= 0 else -d[1][1] + 1, d[1][1] - 1)
        elif p == "select_n":
            cases = d[1:] if len(d) > 1 else d
            r = _hull(cases)
        elif p in ("eq", "ne", "lt", "le", "gt", "ge", "and", "or", "not",
                   "xor", "is_finite", "reduce_and", "reduce_or"):
            r = (0, 1)
        elif p in ("reduce_sum", "psum"):
            if d and d[0][0] >= 0:
                r = (0, math.inf)
        iv[n.gid] = _clamp(r, n)
    return iv


#: prims through which "is (a view of) the old tau value" propagates
_MONO_VIEWS = PASSTHROUGH | {"slice", "concatenate", "stack", "roll",
                             "ppermute"}


def check(probe: Probe, **_) -> list:
    graph = probe.graph
    iv = compute_intervals(graph)
    window = ring_min_gids(graph, probe)
    tau_in, tau_out = tau_io(graph, probe)
    memo: dict[int, tuple] = {}

    def uniform_shift(gid) -> bool:
        """Ring-uniform rebase amount: derives from a full-ring min."""
        return bool(graph.ancestors(gid) & window)

    def mono(gid):
        """(ok, witness_gid): is node a non-decreasing function of tau?"""
        if gid in memo:
            return memo[gid]
        n = graph.node(gid)
        res = (False, gid)
        if gid == tau_in:
            res = (True, None)
        elif n.prim in _MONO_VIEWS:
            res = (True, None)
            for d in n.deps:
                ok, w = mono(d)
                if not ok:
                    res = (False, w)
                    break
        elif n.prim == "select_n":
            res = (True, None)
            for d in n.deps[1:]:
                ok, w = mono(d)
                if not ok:
                    res = (False, w)
                    break
        elif n.prim == "add" and len(n.deps) == 2:
            for i, j in ((0, 1), (1, 0)):
                ok, _w = mono(n.deps[i])
                if ok and iv.get(n.deps[j], _UNK)[0] >= 0:
                    res = (True, None)
                    break
        elif n.prim == "max":
            oks = [mono(d) for d in n.deps]
            res = (True, None) if any(ok for ok, _ in oks) else (False, gid)
        elif n.prim == "sub" and len(n.deps) == 2:
            ok, _w = mono(n.deps[0])
            if ok and uniform_shift(n.deps[1]):
                res = (True, None)      # the sanctioned GVT rebase
        memo[gid] = res
        return res

    ok, witness = mono(tau_out)
    if ok:
        return []
    n = graph.node(witness if witness is not None else tau_out)
    lohi = iv.get(n.gid)
    extra = ""
    if n.prim == "add" and len(n.deps) == 2:
        lo = min(iv.get(d, _UNK)[0] for d in n.deps)
        extra = f" (increment may be as low as {lo:.3g})"
    elif lohi and lohi[0] < 0:
        extra = f" (value range [{lohi[0]:.3g}, {lohi[1]:.3g}])"
    return [Finding(
        rule=RULE, op=n.prim, path=where(n),
        message=f"tau output is not a provably non-decreasing update of "
                f"tau{extra}")]
