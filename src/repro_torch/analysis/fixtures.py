"""Seeded-violation fixtures: each proves one rule actually fires.

A linter whose rules never fire proves nothing, so each fixture here is a
small traced function with exactly one protocol violation planted in
otherwise-idiomatic step code: the reference's six
(``src/repro/analysis/fixtures.py``), in torch.  ``FIXTURES`` maps
fixture name to a function returning ``(probe, expected_rule)``; the tests
assert that the expected rule reports a finding on its fixture and that
the other rules stay quiet.  The event words come from the counter stream
(``core.events``), as in the engine.

``f64_tau`` (in ``EXTRA``) is the port's own: tau itself widened to fp64,
which ``dtype-drift`` must flag while it passes C1's fp64 decode.
"""
from __future__ import annotations

import math

import torch

from ..core.events import counter_bits_block
from ..core.horizon import conservative_update, decode_words
from .probes import DEFAULT_DELTA, Probe, trace

B, L = 4, 16


def _decode(bits, n_v, dtype):
    return decode_words(bits[..., 0], bits[..., 1], n_v, dtype)


def _std_probe(name, fn, *args, delta=DEFAULT_DELTA, L=L, **kw):
    g, calls = trace(fn, *args)
    return Probe(name, backend=f"fixture:{name}", graph=g, tau_in=0,
                 tau_out=0, ring_widths=frozenset({L, L + 2}), L_ring=L,
                 delta=delta, delta_input=None, kernels=calls, **kw)


def _step(tau, left_shift=1, eta_shift=0.0, delta=DEFAULT_DELTA):
    """One step of the update core on full rings, with the planted
    changes: the left neighbour's roll, an offset on eta, the window."""
    bits = counter_bits_block(0, 0, 0, 0, *tau.shape, device=tau.device)
    is_l, is_r, eta = _decode(bits, 4, torch.float32)
    left = torch.roll(tau, left_shift, dims=-1)
    right = torch.roll(tau, -1, dims=-1)
    gvt = torch.amin(tau, dim=-1, keepdim=True)
    out, _ = conservative_update(tau, left, right, is_l, is_r,
                                 eta - eta_shift if eta_shift else eta, gvt,
                                 delta=delta)
    return out


def nnn_roll():
    """Leaked next-nearest-neighbor dependence: left neighbor from roll(2)."""
    return _std_probe("nnn_roll", lambda tau: _step(tau, left_shift=2),
                      torch.zeros((B, L))), "stencil-locality"


def no_window_guard():
    """Finite Δ claimed, but the advance never compares against the base."""
    # BUG: the window comparison was dropped (delta=inf short-circuits
    # Eq. (3)) while the probe still claims a finite window.
    return _std_probe("no_window_guard",
                      lambda tau: _step(tau, delta=math.inf),
                      torch.zeros((B, L))), "window-bound"


def decreasing_tau():
    """Unguarded tau increment that can be negative (eta - 1)."""
    return _std_probe("decreasing_tau", lambda tau: _step(tau, eta_shift=1.0),
                      torch.zeros((B, L))), "tau-monotonicity"


def f64_promotion():
    """Event decode computed in float64 — silently widens the whole step."""

    def fn(tau):
        bits = counter_bits_block(0, 0, 0, 0, *tau.shape)
        w0, w1 = bits[..., 0], bits[..., 1]
        site = torch.remainder(w0, 4)
        # BUG: float64 decode — propagates into tau
        u = (w1 >> 8).to(torch.float64) * 2.0**-24
        eta = -torch.log(u + 2.0**-25)
        left = torch.roll(tau, 1, dims=-1)
        right = torch.roll(tau, -1, dims=-1)
        gvt = torch.amin(tau, dim=-1, keepdim=True)
        out, _ = conservative_update(tau, left, right, site == 0, site == 3,
                                     eta, gvt, delta=DEFAULT_DELTA)
        return out

    return _std_probe("f64_promotion", fn, torch.zeros((B, L))), "dtype-drift"


def nondet_reduction():
    """Window base from a float SUM all-reduce (a mean) instead of the
    order-free MIN."""
    from .markers import AnalysisRing
    ring_n, L_l, B_l = 4, 8, 2
    ring = AnalysisRing(ring_n, 1)

    def fn(tau):
        # BUG: deriving the window base via a float all-reduce-sum — its
        # cross-rank order is unspecified, breaking bit parity.
        gvt = ring.all_reduce(torch.amin(tau, dim=-1, keepdim=True),
                              torch.distributed.ReduceOp.SUM) / ring_n
        bits = counter_bits_block(0, 0, 0, L_l, *tau.shape)
        is_l, is_r, eta = _decode(bits, 4, tau.dtype)
        lcol, rcol = ring.halo(tau, 1)
        tau_h = torch.cat([lcol, tau, rcol], dim=1)
        out, _ = conservative_update(
            tau_h[:, 1:-1], tau_h[:, :-2], tau_h[:, 2:], is_l, is_r, eta,
            gvt, delta=DEFAULT_DELTA)
        return out

    Lg = ring_n * L_l
    g, calls = trace(fn, torch.zeros((B_l, L_l)))
    probe = Probe("nondet_reduction", backend="fixture:nondet_reduction",
                  graph=g, tau_in=0, tau_out=0,
                  ring_widths=frozenset({Lg, L_l, L_l + 2}), L_ring=Lg,
                  delta=DEFAULT_DELTA, delta_input=None,
                  shard_L={"model": L_l}, kernels=calls)
    return probe, "nondeterministic-reduction"


def vmem_blowup():
    """A ring beyond the shared memory of all the card's blocks: B3 on 2^23
    PEs (32 MiB of ring, past ``tiling.MAX_GRID_RING_L``, where B3, unlike
    B1, has no tier that keeps part of a segment in device memory;
    ``tiling.check_ring_fits`` would raise at launch, the rule flags it
    from the launch plan first)."""
    from ..kernels import pdes_multistep
    Lb = 1 << 23

    def fn(tau):
        bits = torch.zeros((1, *tau.shape, 2), dtype=torch.int32)
        out, _ = pdes_multistep.pdes_multistep(tau, bits, n_v=4,
                                               delta=DEFAULT_DELTA)
        return out

    g, calls = trace(fn, torch.zeros((1, Lb)))
    probe = Probe("vmem_blowup", backend="fixture:vmem_blowup", graph=g,
                  tau_in=0, tau_out=0, ring_widths=frozenset({Lb, Lb + 2}),
                  L_ring=Lb, delta=DEFAULT_DELTA, delta_input=None,
                  kernels=calls)
    return probe, "vmem-budget"


def f64_tau():
    """tau itself widened to fp64 before the update (the decode is C1's)."""
    return _std_probe("f64_tau",
                      lambda tau: _step(tau.to(torch.float64)),
                      torch.zeros((B, L))), "dtype-drift"


FIXTURES = {
    "nnn_roll": nnn_roll,
    "no_window_guard": no_window_guard,
    "decreasing_tau": decreasing_tau,
    "f64_promotion": f64_promotion,
    "nondet_reduction": nondet_reduction,
    "vmem_blowup": vmem_blowup,
}

#: the port's own fixtures, beyond the reference's six
EXTRA = {"f64_tau": f64_tau}
