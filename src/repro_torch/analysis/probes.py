"""Traced entry points ("probes") the rules run against.

A probe is one backend's step function traced to an aten graph at
analysis shapes, plus the metadata the rules need to interpret it: which
flat input and output is ``tau``, which array extents are ring widths, the
total ring size (for mod-L wrap normalisation), the per-shard ring length
of each mesh axis, where the window inputs live, and the kernel launches
the traced call made (each with its wrapper's ``launch_plan``).  The
probes and shapes are the reference's (``src/repro/analysis/probes.py``):

* single-device backends: ``step`` (exact window), ``stale`` (not for
  ``pallas_multistep``, which takes the exact window only), ``sweep`` (the
  per-row Δ column as a traced operand) and ``service`` (the Δ column and
  the per-row trial vector), at B 4, L 16, K 2; ``pallas`` and
  ``pallas_multistep`` add a ``vmem`` probe at 64 x 1024, K 16, where the
  ``vmem-budget`` rule sizes the kernels' real launches;
* ``sharded``: ``step``, ``stale`` (``commavoid``, K 4), ``sweep`` and
  ``service`` of one rank's ``core.distributed._shard_body`` on a
  ``(2, 4)`` layout of B 4, L 32, its collectives through
  ``markers.AnalysisRing``.

Probe shapes are chosen so that ring widths collide with no other extent,
so the "which axis is the ring" lookup in ``graph.ring_axis_of`` is
unambiguous.

Tracing is ``make_fx(..., tracing_mode="real")`` on CPU tensors: the
plain B1's counter stream reads its counter tensor's values, which a fake
trace cannot.  This is a static tool: it computes no result, it reads the
graph of the computation, so tracing on the CPU is not a fallback from the
card; what runs on the card is the kernels, whose budgets the
``vmem-budget`` rule checks from their launch plans.  64-bit types need
no switch in PyTorch: every 64-bit value shows in the graph as it is,
which is what the ``dtype-drift`` rule reads.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import traceback

import torch

from ..core.engine import BACKENDS, EngineConfig, _make_advance
from ..core.horizon import PDESConfig
from .graph import Graph, build_graph

DEFAULT_DELTA = 8.0


@dataclasses.dataclass(frozen=True)
class KernelCall:
    """One kernel launch a probe's call made: the wrapper, its plan."""

    kernel: str              # "pdes_multistep_counter" | "pdes_step" | ...
    plan: dict               # the wrapper's launch_plan(...)
    src: str = ""            # where it was called, "file:line"


@dataclasses.dataclass
class Probe:
    """One traced entry point + the metadata rules interpret it with."""

    name: str                 # "step" | "sweep" | "stale" | "service" | "vmem"
    backend: str
    graph: Graph
    tau_in: int               # flat input index of tau
    tau_out: int              # flat output index of tau
    ring_widths: frozenset    # array extents that mean "ring axis"
    L_ring: int               # total ring size (mod-L wrap normalization)
    delta: float | None       # static window width (None = inf)
    delta_input: int | None   # flat input index of the per-row Δ column
    shard_L: dict = dataclasses.field(default_factory=dict)  # axis -> L_local
    dtype: str = "float32"    # declared base dtype of tau
    trial_input: int | None = None   # flat input index of the trial vector
    kernels: list = dataclasses.field(default_factory=list)  # KernelCall


def _anchor_port() -> None:
    """Let ``make_fx`` keep the port's frames in a node's stack: it keeps
    only ``forward`` frames and registered anchors (its private set, where
    this torch has it; without it nodes carry no provenance)."""
    from torch.fx import proxy
    anchors = getattr(proxy, "_STACK_TRACE_ANCHORS", None)
    if anchors is None:
        return

    def codes(co):
        yield co
        for c in co.co_consts:
            if hasattr(c, "co_code"):
                yield from codes(c)

    for name, mod in list(sys.modules.items()):
        if not name.startswith("repro_torch.") or \
                name.startswith("repro_torch.analysis"):
            continue
        for obj in list(vars(mod).values()):
            fns = [obj] if callable(obj) else []
            if isinstance(obj, type):
                fns = [v for v in vars(obj).values() if callable(v)]
            for f in fns:
                co = getattr(f, "__code__", None)
                if co is not None and co.co_filename == getattr(
                        mod, "__file__", None):
                    for c in codes(co):
                        anchors.add((c.co_filename, c.co_name))


def _caller_src() -> str:
    """``file:line`` of the innermost frame of the port outside the
    analysis and the kernels package."""
    for fr in reversed(traceback.extract_stack()[:-2]):
        i = fr.filename.rfind("repro_torch/")
        rel = fr.filename[i + len("repro_torch/"):] if i >= 0 else ""
        if rel and not rel.startswith(("analysis/", "kernels/")):
            return f"{rel}:{fr.lineno}"
    return ""


def _ring_plan(tau, *a, **kw):
    from ..kernels import pdes_multistep
    return pdes_multistep.launch_plan(*tau.shape)


def _b3_plan(tau, *a, **kw):
    from ..kernels import pdes_multistep
    return pdes_multistep.launch_plan(*tau.shape, bits=True)


def _b2_plan(tau_h, *a, **kw):
    from ..kernels import pdes_step
    return pdes_step.launch_plan(tau_h.shape[0], tau_h.shape[1] - 2)


#: (module, attribute) of each kernel wrapper as its callers reach it, the
#: kernel's name and the plan of a call's arguments
_WRAPPERS = (
    ("repro_torch.kernels.pdes_multistep", "pdes_multistep_counter",
     "pdes_multistep_counter", _ring_plan),
    ("repro_torch.kernels.pdes_multistep", "pdes_multistep",
     "pdes_multistep", _b3_plan),
    ("repro_torch.kernels.ops", "pdes_step", "pdes_step", _b2_plan),
    ("repro_torch.kernels.ops", "pdes_multistep", "pdes_multistep",
     _b3_plan),
)


_CALLS: list | None = None      # the active recording's calls


@contextlib.contextmanager
def recording_kernels():
    """Record every kernel wrapper call as a :class:`KernelCall` (the
    wrapper still runs: its plain version on CPU tensors).  A caller that
    binds a wrapper by name (the engine's ``_make_advance``) must do so
    inside, so nested uses share one recording."""
    global _CALLS
    if _CALLS is not None:
        yield _CALLS
        return
    import importlib
    calls, saved = [], []
    for mod_name, attr, kernel, plan_of in _WRAPPERS:
        mod = importlib.import_module(mod_name)
        orig = getattr(mod, attr)

        def wrapped(*args, _orig=orig, _kernel=kernel, _plan=plan_of,
                    **kwargs):
            calls.append(KernelCall(_kernel, _plan(*args, **kwargs),
                                    _caller_src()))
            return _orig(*args, **kwargs)

        saved.append((mod, attr, orig))
        setattr(mod, attr, wrapped)
    _CALLS = calls
    try:
        yield calls
    finally:
        _CALLS = None
        for mod, attr, orig in saved:
            setattr(mod, attr, orig)


def trace(fn, *args) -> tuple[Graph, list]:
    """``(graph, kernel calls)`` of ``fn(*args)`` traced by ``make_fx``."""
    from torch.fx.experimental.proxy_tensor import make_fx
    _anchor_port()
    with recording_kernels() as calls:
        start = len(calls)
        gm = make_fx(fn, tracing_mode="real", record_stack_traces=True)(*args)
        return build_graph(gm), calls[start:]


def _advance_fns(advance, K):
    """``(step, sweep, service)``: the chunk advance with a static window,
    with the Δ column, and with the Δ column and the trial vector as
    traced operands (``make_fx`` traces one tensor argument a parameter)."""
    return (lambda tau: advance(tau, 0, 0, K, None, 0),
            lambda tau, dcol: advance(tau, 0, 0, K, dcol, 0),
            lambda tau, dcol, trials: advance(tau, 0, 0, K, dcol, trials))


def _single_probes(backend: str):
    """step/stale/sweep/service (+ production-shape vmem) probes for one-
    device backends."""
    B, L, K = 4, 16, 2
    cfg = PDESConfig(L=L, n_v=4, delta=DEFAULT_DELTA)
    widths = frozenset({L, L + 2})
    tau0 = torch.zeros((B, L), dtype=torch.float32)
    for name, window in (("step", "exact"), ("stale", "stale")):
        if backend == "pallas_multistep" and window == "stale":
            continue       # rejected by EngineConfig: exact-GVT only
        step, _, _ = _advance_fns(
            _make_advance(cfg, EngineConfig(backend, window, K), B, L), K)
        g, calls = trace(step, tau0)
        yield Probe(name, backend, g, tau_in=0, tau_out=0,
                    ring_widths=widths, L_ring=L, delta=cfg.delta,
                    delta_input=None, kernels=calls)

    _, sweep, service = _advance_fns(
        _make_advance(cfg, EngineConfig(backend, "exact", K), B, L), K)
    dcol = torch.full((B, 1), DEFAULT_DELTA, dtype=torch.float32)
    g, calls = trace(sweep, tau0, dcol)
    yield Probe("sweep", backend, g, tau_in=0, tau_out=0,
                ring_widths=widths, L_ring=L, delta=0.0, delta_input=1,
                kernels=calls)

    # the coalesced-batch form (service): per-row Δ column plus a per-row
    # trial-index vector instead of a scalar stream base
    g, calls = trace(service, tau0, dcol, torch.arange(B))
    yield Probe("service", backend, g, tau_in=0, tau_out=0,
                ring_widths=widths, L_ring=L, delta=0.0, delta_input=1,
                trial_input=2, kernels=calls)

    if backend in ("pallas", "pallas_multistep"):
        # production-shape trace: the budget rule sizes real launches here
        Bp, Lp, Kp = 64, 1024, 16
        cfgp = PDESConfig(L=Lp, n_v=4, delta=DEFAULT_DELTA)
        step, _, _ = _advance_fns(
            _make_advance(cfgp, EngineConfig(backend, "exact", Kp), Bp, Lp),
            Kp)
        g, calls = trace(step, torch.zeros((Bp, Lp), dtype=torch.float32))
        yield Probe("vmem", backend, g, tau_in=0, tau_out=0,
                    ring_widths=frozenset({Lp, Lp + 2}), L_ring=Lp,
                    delta=cfgp.delta, delta_input=None, kernels=calls)


def _shard_fn(cfg, dist, ring, K, sweep, trial):
    """One rank's ``_shard_body`` with the Δ column and the trial vector
    as traced operands where the probe has them."""
    from ..core.distributed import _shard_body

    def body(tau, off, comp, dcol, b0):
        return _shard_body(tau, off, comp, 0, 0, b0, dcol, ring=ring,
                           cfg=cfg, dist_cfg=dist, n_steps=K)

    if trial:
        return lambda tau, off, comp, dcol, tcol: body(tau, off, comp, dcol,
                                                       tcol)
    if sweep:
        return lambda tau, off, comp, dcol: body(tau, off, comp, dcol, 0)
    return lambda tau, off, comp: body(tau, off, comp, None, 0)


def _sharded_probes():
    from ..core.distributed import DistConfig
    from .markers import AnalysisRing

    B, L, ens, ring_n = 4, 32, 2, 4
    B_l, L_l = B // ens, L // ring_n
    cfg = PDESConfig(L=L, n_v=4, delta=DEFAULT_DELTA)
    # (name, mode, K, with Δ-column sweep operand, with trial-vector operand)
    for name, mode, K, sweep, trial in (
            ("step", "exact", 2, False, False),
            ("stale", "commavoid", 4, False, False),
            ("sweep", "exact", 2, True, False),
            ("service", "exact", 2, True, True)):
        dist = DistConfig(mode=mode, k_chunk=K)
        fn = _shard_fn(cfg, dist, AnalysisRing(ring_n, 1, dist.ring_axis),
                       K, sweep, trial)
        args = [torch.zeros((B_l, L_l)), torch.zeros((B_l,)),
                torch.zeros((B_l,))]
        if sweep:
            # the Δ column shards over the ensemble axes like the tau rows
            args.append(torch.full((B_l, 1), DEFAULT_DELTA))
        if trial:
            # ...as does the coalesced-batch per-row trial-index vector
            args.append(torch.arange(B_l))
        g, calls = trace(fn, *args)
        widths = {L, L_l, L_l + 2}
        if mode == "commavoid":
            widths |= {L_l + 2 * K, L_l + 2 * K + 2}
        yield Probe(name, "sharded", g, tau_in=0, tau_out=0,
                    ring_widths=frozenset(widths), L_ring=L,
                    delta=0.0 if sweep else cfg.delta,
                    delta_input=3 if sweep else None,
                    trial_input=4 if trial else None,
                    shard_L={dist.ring_axis: L_l}, kernels=calls)


def iter_probes(backend: str):
    """Yield every :class:`Probe` of one backend."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")
    with recording_kernels():
        if backend == "sharded":
            yield from _sharded_probes()
        else:
            yield from _single_probes(backend)
