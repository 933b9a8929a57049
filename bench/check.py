"""The comparison that decides ``correct``.

Once the window has closed, a round is drawn from the run's seed, and the
responses to that round's new requests (duplicates included) are compared
with the plain reference, with every response of the next round that
extends one of them (the burned-state cache's path).  The reference is
the module under ``bench/reference/`` that the cell's configuration names
(``"reference"``; ``pdes.py`` where it names none), which a configuration
with physics of its own brings with it (``load_reference``).  It
recomputes each request from its spec and its seed alone, each (L, N_V)
point of its grid in turn, numbered as the service numbers them.  A
point's rows on one counter stream with the same burn-in and physics are
computed together with other requests' over the union of their rows, for
their longest length: a shorter request is a prefix of it whenever every
length is a whole number of chunks.  On a grid of several N_V
values one of them is compared at each ring length, drawn from the run's
seed and the same in every request of the run: every ring length, and so
every tier of the kernels and every slab of the state cache, is checked
in each run, every point over runs, and the reference stays shorter than
the window.

Two numbers are compared, each against the cell's limit:

* ``exact_fields_differ``: record fields that depend only on exact
  arithmetic (counts of updates and minima: ``u``, ``u_err``, ``rate``,
  ``rate_err``) and are not bit for bit the reference's.  Limit 0.
* ``max_rel_gap``: the widest relative gap of any record field, the sums
  (``w2``, ``wa``, ``spread`` and what derives from them) included,
  which the kernels add up in another order than plain PyTorch.

A missing answer, or a record of another point or Δ than the reference's
in its place, reads ``inf`` in both.
"""
from __future__ import annotations

import functools
import importlib.util
import itertools
import math
import pathlib

import numpy as np
import torch

from . import traffic

EXACT_FIELDS = ("u", "u_err", "rate", "rate_err")
#: The reference of a configuration that names none.
DEFAULT_REFERENCE = "pdes"
#: What a reference module exports to the harness.
REFERENCE_EXPORTS = ("request_rows", "run_rows", "records", "RECORD_FIELDS")
BENCH = pathlib.Path(__file__).resolve().parent


@functools.cache
def load_reference(bench: pathlib.Path = BENCH,
                   name: str = DEFAULT_REFERENCE):
    """The reference module ``<bench>/reference/<name>.py``, loaded once.

    It exports ``REFERENCE_EXPORTS``, as ``pdes.py`` does:
    ``request_rows(deltas, replicas)``, a request's (trials, Δs);
    ``run_rows(*, L, n_v, k_fuse, window, seed, burn_in, n_steps, trials,
    deltas, device, dtype, rd_mode, border_both, **spec)``, their stats;
    ``records(stats, deltas, replicas, steady_frac)``, one dict a Δ; and
    ``RECORD_FIELDS``, the fields compared.
    """
    path = pathlib.Path(bench) / "reference" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no reference {name!r}: {path} is not a file")
    mod_spec = importlib.util.spec_from_file_location(
        f"bench.reference.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    missing = [k for k in REFERENCE_EXPORTS if not hasattr(mod, k)]
    if missing:
        raise ValueError(f"reference {name!r} lacks {missing}")
    return mod


def sample(log: list, seed: int) -> list:
    """The entries to compare: a round drawn from ``seed`` (its
    extensions of the round before left out), and the entries of the next
    round that extend it."""
    if not log:
        return []
    rng = np.random.default_rng([int(seed) % 2**64, 7])
    r = int(rng.integers(0, max(1, len(log) - 1)))
    picked = [e for e in log[r] if "extends" not in e["request"]]
    if r + 1 < len(log):
        picked += [e for e in log[r + 1] if "extends" in e["request"]]
    return picked


def drawn(config: dict, seed: int):
    """Indices, in the service's order, of the grid's points a run of
    ``seed`` compares: one N_V value at each ring length, drawn from the
    seed; every point (None) where the configuration has one N_V."""
    Ls, n_vs = traffic.grid(config)
    if len(n_vs) == 1:
        return None
    rng = np.random.default_rng([int(seed) % 2**64, 11])
    return {i * len(n_vs) + int(rng.choice(len(n_vs), 1)[0])
            for i in range(len(Ls))}


def points(q: dict, keep=None) -> list:
    """A request's ``(L, n_v, trial base)`` points in the service's order:
    L outer, N_V inner, each point's trials after the previous point's;
    only those whose index is in ``keep``, where it is given."""
    n = len(q["deltas"]) * q["replicas"]
    return [(L, n_v, i * n) for i, (L, n_v) in
            enumerate(itertools.product(q["Ls"], q["n_vs"]))
            if keep is None or i in keep]


def kept(records, q: dict, keep=None):
    """An answer's records at the points in ``keep`` (all where it is
    None); an answer of another length than its request's grid, as it
    came, so that it reads ``inf``."""
    n = len(q["deltas"])
    if records is None or keep is None or \
            len(records) != n * len(q["Ls"]) * len(q["n_vs"]):
        return records
    return [r for k, r in enumerate(records) if k // n in keep]


def _frozen(v):
    """A JSON value with its lists as tuples, so that it hashes."""
    return tuple(map(_frozen, v)) if isinstance(v, list) else v


def _stream_key(q: dict, L: int, n_v: int):
    """Requests share a reference run only where every term of their
    physics (the configuration's ``spec`` too) and their stream match."""
    k = q["k_fuse"]
    return (L, n_v, q["window"], k, q["seed"], q["burn_in"], q["rd_mode"],
            q["border_both"], 0 if q["n_steps"] % k == 0 else q["n_steps"]
            ) + tuple(sorted((f, _frozen(v))
                             for f, v in traffic.extra(q).items()))


def reference_records(requests: list, device, dtype=torch.float32,
                      keep=None, reference=None) -> list:
    """The reference's records of each request (a list of dicts each, its
    points' in turn; only the points in ``keep``, where it is given), by
    the module ``reference`` (``load_reference()`` where it is None)."""
    ref = load_reference() if reference is None else reference
    groups: dict = {}
    for i, q in enumerate(requests):
        for p, (L, n_v, base) in enumerate(points(q, keep)):
            groups.setdefault(_stream_key(q, L, n_v), []).append((i, p, base))
    out = [{} for _ in requests]
    for (L, n_v, *_), members in groups.items():
        qs = [requests[i] for i, _, _ in members]
        union: dict = {}
        cols = []
        for q, (_, _, base) in zip(qs, members):
            trials, deltas = ref.request_rows(q["deltas"], q["replicas"])
            cols.append([union.setdefault((int(base + t), float(d)),
                                          len(union))
                         for t, d in zip(trials, deltas)])
        q0 = qs[0]
        stats = ref.run_rows(
            L=L, n_v=n_v, k_fuse=q0["k_fuse"],
            window=q0["window"], seed=q0["seed"], burn_in=q0["burn_in"],
            n_steps=max(q["n_steps"] for q in qs),
            trials=[t for t, _ in union], deltas=[d for _, d in union],
            device=device, dtype=dtype, rd_mode=q0["rd_mode"],
            border_both=q0["border_both"], **traffic.extra(q0))
        for (i, p, _), q, c in zip(members, qs, cols):
            mine = {f: a[:q["n_steps"], c] for f, a in stats.items()}
            out[i][p] = [dict(L=L, n_v=n_v, **r) for r in ref.records(
                mine, q["deltas"], q["replicas"], q["steady_frac"])]
    return [[r for p in sorted(recs) for r in recs[p]] for recs in out]


def compare(answers: list, refs: list, reference=None) -> dict:
    """The compared numbers of answers (lists of record dicts, or None for
    an answer that never came or is an error) against the reference's
    (the fields of ``reference``, ``load_reference()`` where it is None)."""
    fields = (load_reference() if reference is None
              else reference).RECORD_FIELDS
    gap, differ = 0.0, 0
    for got, want in zip(answers, refs):
        if got is None or len(got) != len(want):
            return {"max_rel_gap": math.inf, "exact_fields_differ": math.inf}
        for g, w in zip(got, want):
            if any(g[k] != w[k] for k in ("L", "n_v", "delta")):
                return {"max_rel_gap": math.inf,
                        "exact_fields_differ": math.inf}
            for f in fields:
                a, b = g[f], w[f]
                if a == b or (math.isnan(a) and math.isnan(b)):
                    continue
                differ += f in EXACT_FIELDS
                rel = abs(a - b) / abs(b) if b else math.inf
                gap = max(gap, rel if rel == rel else math.inf)
    return {"max_rel_gap": gap, "exact_fields_differ": differ}


def judge(numbers: dict, limits: dict) -> bool:
    """True when every number is within its limit (NaN never is)."""
    return all(numbers[k] <= limits[k] for k in limits)
