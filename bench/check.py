"""The comparison that decides ``correct``.

Once the window has closed, a round is drawn from the run's seed, and the
responses to that round's new requests (duplicates included) are compared
with the plain reference (``bench/reference/pdes.py``), with every response
of the next round that extends one of them (the burned-state cache's
path).  The reference recomputes each request from its spec and its seed
alone.  Requests on one counter stream with the same burn-in are computed together
over the union of their rows, for their longest length: a shorter request
is a prefix of it whenever every length is a whole number of chunks.

Two numbers are compared, each against the cell's limit:

* ``exact_fields_differ``: record fields that depend only on exact
  arithmetic (counts of updates and minima: ``u``, ``u_err``, ``rate``,
  ``rate_err``) and are not bit for bit the reference's.  Limit 0.
* ``max_rel_gap``: the widest relative gap of any record field, the sums
  (``w2``, ``wa``, ``spread`` and what derives from them) included,
  which the kernels add up in another order than plain PyTorch.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import pdes as ref

EXACT_FIELDS = ("u", "u_err", "rate", "rate_err")


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


def _stream_key(q: dict):
    k = q["k_fuse"]
    return (tuple(q["Ls"]), tuple(q["n_vs"]), q["window"], k, q["seed"],
            q["burn_in"], q["rd_mode"], q["border_both"],
            0 if q["n_steps"] % k == 0 else q["n_steps"])


def reference_records(requests: list, device, dtype=torch.float32) -> list:
    """The reference's records of each request (a list of dicts each)."""
    groups: dict = {}
    for i, q in enumerate(requests):
        groups.setdefault(_stream_key(q), []).append(i)
    out = [None] * len(requests)
    for idx in groups.values():
        qs = [requests[i] for i in idx]
        union: dict = {}
        cols = []
        for q in qs:
            trials, deltas = ref.request_rows(q["deltas"], q["replicas"])
            cols.append([union.setdefault((int(t), float(d)), len(union))
                         for t, d in zip(trials, deltas)])
        q0 = qs[0]
        if len(q0["Ls"]) != 1 or len(q0["n_vs"]) != 1:
            raise ValueError("the reference takes one (L, n_v) a request")
        stats = ref.run_rows(
            L=q0["Ls"][0], n_v=q0["n_vs"][0], k_fuse=q0["k_fuse"],
            window=q0["window"], seed=q0["seed"], burn_in=q0["burn_in"],
            n_steps=max(q["n_steps"] for q in qs),
            trials=[t for t, _ in union], deltas=[d for _, d in union],
            device=device, dtype=dtype, rd_mode=q0["rd_mode"],
            border_both=q0["border_both"])
        for i, q, c in zip(idx, qs, cols):
            mine = {f: a[:q["n_steps"], c] for f, a in stats.items()}
            out[i] = ref.records(mine, q["deltas"], q["replicas"],
                                 q["steady_frac"])
    return out


def compare(answers: list, refs: list) -> dict:
    """The compared numbers of answers (lists of record dicts, or None for
    an answer that never came or is an error) against the reference's."""
    gap, differ = 0.0, 0
    for got, want in zip(answers, refs):
        if got is None or len(got) != len(want):
            return {"max_rel_gap": math.inf, "exact_fields_differ": math.inf}
        for g, w in zip(got, want):
            if g["delta"] != w["delta"]:
                return {"max_rel_gap": math.inf,
                        "exact_fields_differ": math.inf}
            for f in ref.RECORD_FIELDS:
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
