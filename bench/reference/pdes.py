"""Plain reference of the sweep service's answers, in PyTorch and numpy.

A frozen copy, not an import, of the port's arithmetic as it stands at
commit 8550d91 of this repository:

* the counter-stream hash: ``src/repro_torch/core/events.py``
  (``_mix``, ``counter_words``);
* the η decode rule: ``src/repro_torch/core/horizon.py`` (``decode_eta``,
  ``decode_words``);
* the conservative update with a per-row Δ, exact and stale:
  ``horizon.conservative_update`` and ``horizon.step_core``;
* the per-chunk rebase with the Kahan-compensated offset:
  ``src/repro_torch/core/engine.py`` (``_run_single``) and
  ``horizon._kahan_add``;
* the moments: ``horizon.ring_moments`` and ``horizon.stats_from_moments``;
* the steady-state reduction: ``src/repro_torch/core/measurement.py``
  (``steady_start``, ``progress_rate``, ``sweep_reduce``) and
  ``src/repro_torch/experiments/sweep.py`` (``records_from_reduction``).

It recomputes a request from its spec and its seed, burn-in included, one
step at a time on plain tensors, and takes nothing that the service made.
``dtype`` is the precision of the simulation (virtual times, η, the
window, the moments and the offset); the benchmark's control runs it in
``torch.bfloat16``.
"""
from __future__ import annotations

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35
_GOLDEN = 0x9E3779B9
_STEP_C = 0x27D4EB2F
_TRIAL_C = 0x165667B1
_PE_C = 0xD3A2646C
_W0_C = 0x68E31DA4
_W1_C = 0xB5297A4D

#: Fields of a sweep record, in ``SweepRecord`` order after (L, n_v, delta).
RECORD_FIELDS = ("u", "u_err", "w2", "w2_err", "w", "wa", "spread", "rate",
                 "rate_err")


def _mix(h):
    """murmur3 fmix32 on uint32 values: Python ints, or int64 tensors."""
    h = h ^ (h >> 16)
    h = (h * _C1) & MASK32
    h = h ^ (h >> 13)
    h = (h * _C2) & MASK32
    h = h ^ (h >> 16)
    return h


def decode(w0, w1, n_v: int, dtype):
    """(is_left, is_right, eta): site = w0 mod n_v, η = -log of word 1."""
    site = torch.remainder(w0, n_v)
    u = (w1 >> 8).to(torch.float32) * 2.0**-24
    x = u + 2.0**-25
    eta = (-torch.log(x.to(torch.float64))).to(dtype)
    return site == 0, site == (n_v - 1), eta


def update(tau, is_left, is_right, eta, base, delta_col, *, rd_mode: bool,
           border_both: bool):
    """Causality rule Eq. (1), window rule Eq. (3) on ``base``, update."""
    left = torch.roll(tau, 1, dims=-1)
    right = torch.roll(tau, -1, dims=-1)
    if rd_mode:
        causal_ok = torch.ones_like(tau, dtype=torch.bool)
    elif border_both:
        ok = (tau <= left) & (tau <= right)
        causal_ok = torch.where(is_left | is_right, ok, True)
    else:
        causal_ok = (torch.where(is_left, tau <= left, True)
                     & torch.where(is_right, tau <= right, True))
    upd = causal_ok & (tau <= delta_col + base)
    return tau + torch.where(upd, eta, 0.0), upd


def moments(tau, upd) -> dict:
    """Per-ring partial sums of one post-update state."""
    s = tau.sum(dim=-1)
    mean = s / tau.shape[-1]
    return dict(ucount=upd.to(tau.dtype).sum(dim=-1), min=tau.amin(dim=-1),
                max=tau.amax(dim=-1), sum=s, sumsq=(tau * tau).sum(dim=-1),
                sumabs=(tau - mean[..., None]).abs().sum(dim=-1))


def step_stats(m: dict, offset, L: int) -> dict:
    """The per-step observables the reduction reads, from the moments."""
    inv_l = 1.0 / L
    mean = m["sum"] * inv_l
    return dict(utilization=m["ucount"] * inv_l,
                w2=m["sumsq"] * inv_l - mean * mean, wa=m["sumabs"] * inv_l,
                gvt=m["min"] + offset, max_dev=m["max"] - mean,
                min_dev=mean - m["min"])


def _kahan_add(total, comp, x):
    y = x - comp
    t = total + y
    comp = (t - total) - y
    return t, comp


def _advance(state, n_steps, *, record, seed, trial, pe_c, delta_col, L, n_v,
             k_fuse, stale, rd_mode, border_both):
    """One engine call: ``n_steps`` in chunks of K, a rebase after each."""
    tau, off, comp, step = state
    K = max(1, min(k_fuse, n_steps))
    n_chunks, rem = divmod(n_steps, K)
    planes = []
    for k in [K] * n_chunks + ([rem] if rem else []):
        gvt0 = torch.amin(tau, dim=-1, keepdim=True)
        for s in range(step, step + k):
            # counter_words(seed, s, trial, pe): the seed and step terms are
            # one value a step, the trial term one a row
            h = _mix(_mix(seed ^ _GOLDEN) ^ ((s * _STEP_C) & MASK32))
            h = _mix(_mix(h ^ trial) ^ pe_c)
            is_l, is_r, eta = decode(_mix(h ^ _W0_C), _mix(h ^ _W1_C), n_v,
                                     tau.dtype)
            base = gvt0 if stale else torch.amin(tau, dim=-1, keepdim=True)
            tau, upd = update(tau, is_l, is_r, eta, base, delta_col,
                              rd_mode=rd_mode, border_both=border_both)
            if record:
                planes.append(step_stats(moments(tau, upd), off, L))
        shift = torch.amin(tau, dim=-1)
        tau = tau - shift[:, None]
        off, comp = _kahan_add(off, comp, shift)
        step += k
    return (tau, off, comp, step), planes


def run_rows(*, L: int, n_v: int, k_fuse: int, window: str, seed: int,
             burn_in: int, n_steps: int, trials, deltas, device,
             dtype=torch.float32, rd_mode: bool = False,
             border_both: bool = False, block_elems: int = 1 << 24) -> dict:
    """Burn in ``burn_in`` steps from a flat start, then record ``n_steps``.

    Rows are rings on the counter stream of ``seed`` at the given trial
    indices, each with its own Δ (``inf``: unconstrained), in blocks of at
    most ``block_elems`` PEs.  Returns ``{field: (n_steps, B) float32
    numpy}`` for the fields the reduction reads.
    """
    if window not in ("exact", "stale"):
        raise ValueError(f"window must be exact or stale, got {window!r}")
    trials = np.asarray(trials, np.int64)
    deltas = np.asarray(deltas, np.float64)
    B = trials.size
    rows = max(1, block_elems // L)
    pe_c = (torch.arange(L, device=device)[None, :] * _PE_C) & MASK32
    kw = dict(seed=int(seed) & MASK32, pe_c=pe_c, L=L, n_v=n_v, k_fuse=k_fuse,
              stale=window == "stale", rd_mode=rd_mode,
              border_both=border_both)
    out = []
    for b0 in range(0, B, rows):
        t = torch.as_tensor(trials[b0:b0 + rows], device=device) & MASK32
        trial = ((t * _TRIAL_C) & MASK32)[:, None]
        dcol = torch.as_tensor(deltas[b0:b0 + rows], device=device).to(
            dtype)[:, None]
        b = t.shape[0]
        z = torch.zeros((b,), dtype=dtype, device=device)
        state = (torch.zeros((b, L), dtype=dtype, device=device), z,
                 z.clone(), 0)
        if burn_in:
            state, _ = _advance(state, burn_in, record=False, trial=trial,
                                delta_col=dcol, **kw)
        _, planes = _advance(state, n_steps, record=True, trial=trial,
                             delta_col=dcol, **kw)
        out.append({f: torch.stack([p[f] for p in planes]).float().cpu()
                    .numpy() for f in planes[0]})
    return {f: np.concatenate([o[f] for o in out], axis=1) for f in out[0]}


def steady_start(n_steps: int, steady_frac: float = 0.5) -> int:
    """First step of the steady-state measurement window."""
    if not 0.0 < steady_frac <= 1.0:
        raise ValueError(f"steady_frac must be in (0, 1], got {steady_frac}")
    return min(n_steps - 1, int(round(n_steps * (1.0 - steady_frac))))


def progress_rate(g: np.ndarray, t0: int = 0) -> np.ndarray:
    """Least-squares slope d(GVT)/dt of a (T, B) series over [t0, T)."""
    g = g[t0:]
    t = np.arange(g.shape[0], dtype=g.dtype)
    t_mean = t.mean()
    cov = ((t[:, None] - t_mean) * (g - g.mean(axis=0))).mean(axis=0)
    return cov / ((t - t_mean) ** 2).mean()


def sweep_reduce(stats: dict, n_windows: int, replicas: int,
                 steady_frac: float = 0.5) -> dict:
    """Per-Δ steady-state estimates of (T, n_windows * replicas) stats."""
    u = stats["utilization"]
    T = u.shape[0]
    if u.shape[1] != n_windows * replicas:
        raise ValueError(f"stats rows {u.shape[1]} != n_windows*replicas "
                         f"({n_windows}*{replicas})")
    t0 = steady_start(T, steady_frac)

    def per_window(x):
        return x[t0:].mean(axis=0).reshape(n_windows, replicas)

    def mean_err(x):
        m = x.mean(axis=1)
        e = (x.std(axis=1, ddof=1) / np.sqrt(replicas) if replicas > 1
             else np.zeros_like(m))
        return m, e

    u_w, u_e = mean_err(per_window(u))
    w2_w, w2_e = mean_err(per_window(stats["w2"]))
    r_w, r_e = mean_err(progress_rate(stats["gvt"], t0).reshape(n_windows,
                                                               replicas))
    return {"u": u_w, "u_err": u_e, "w2": w2_w, "w2_err": w2_e,
            "w": np.sqrt(per_window(stats["w2"])).mean(axis=1),
            "wa": mean_err(per_window(stats["wa"]))[0],
            "spread": per_window(stats["max_dev"]
                                 + stats["min_dev"]).mean(axis=1),
            "rate": r_w, "rate_err": r_e}


def request_rows(deltas, replicas: int):
    """A request's rows: window-major, replica-inner, trial = w R + r."""
    trials = np.arange(len(deltas) * replicas, dtype=np.int64)
    return trials, np.repeat(np.asarray(deltas, np.float64), replicas)


def records(stats: dict, deltas, replicas: int,
            steady_frac: float = 0.5) -> list[dict]:
    """One record a Δ of a request, from its rows' (T, B) stats."""
    red = sweep_reduce({f: np.ascontiguousarray(a) for f, a in stats.items()},
                       len(deltas), replicas, steady_frac)
    return [{"delta": float(d), **{f: float(red[f][w]) for f in RECORD_FIELDS}}
            for w, d in enumerate(deltas)]
