"""The benchmark's one traffic generator: rounds of sweep requests as data.

Three data files define what a cell sends, and this module reads them:

* the configuration, ``bench/configs/<config>.json``: the deployment (ring
  size ``L`` and volume load ``n_v``, or a grid of them, the lists ``Ls``
  and ``n_vs``; fuse depth ``k_fuse``, the physics flags, ``steady_frac``)
  and its Δ menu, ``deltas``.  A request asks for every point of the
  grid;
* the mix, ``bench/mixes/<traffic>.json``: the engine path (``backend``,
  ``window``) and one round's requests, one entry a requester, of four
  kinds::

      {"requester": "alice", "deltas": "a"}              a named Δ set
      {"requester": "erin", "draw": {"from": "menu", "count": 2}}
                                                          Δs drawn at random
      {"requester": "carol", "same_as": "alice"}         a duplicate
      {"requester": "dave", "extends": "alice", "steps_factor": 2}
                        the previous round's request, measured longer

* the cell, ``bench/cells/<workload>.json``: the sizes (``replicas`` per
  Δ, ``burn_in``, ``n_steps``) and the Δ sets the mix names, each drawn
  from the configuration's menu.

A configuration may also carry ``spec``, further ``WindowSweep`` fields as
JSON values (a deployment's own physics), which every request of it
carries, and ``reference``, the plain reference its answers are compared
with (``check.load_reference``).

Every round has a stream seed of its own and draws its Δs from a generator
seeded by (run seed, round), so one seed always gives the same rounds.  A
request is a plain dict of ``WindowSweep`` fields (``SPEC_FIELDS``, then
the configuration's ``spec``) plus ``requester`` (and ``extends``, the
requester of the previous round it extends).
"""
from __future__ import annotations

import math

import numpy as np

#: ``WindowSweep`` fields of a request dict that the harness sets, in the
#: spec's order.
SPEC_FIELDS = ("Ls", "n_vs", "deltas", "replicas", "n_steps", "burn_in",
               "backend", "window", "k_fuse", "rd_mode", "border_both",
               "steady_frac", "seed")
#: Keys of a request dict that are not ``WindowSweep`` fields.
REQUEST_KEYS = ("requester", "extends")
#: Top-level keys a configuration may carry; any other is refused, so that
#: a misspelt key cannot run the default physics unseen.
CONFIG_KEYS = frozenset({
    "name", "about", "source", "guarantees", "reduced", "cuts", "assumed",
    "L", "n_v", "Ls", "n_vs", "k_fuse", "rd_mode", "border_both",
    "steady_frac", "deltas", "window", "state_cache_rows", "dtype", "spec",
    "reference"})


def as_delta(x) -> float:
    """A Δ as the data files spell it: a number, or ``"inf"``."""
    return math.inf if x == "inf" else float(x)


def grid(config: dict) -> tuple:
    """A configuration's ``(Ls, n_vs)``: its grid's lists, or its one
    point's ``L`` and ``n_v`` as lists of one."""
    if ("L" in config) == ("Ls" in config):
        raise ValueError("a configuration names L and n_v, or Ls and n_vs")
    if "L" in config:
        return [int(config["L"])], [int(config["n_v"])]
    Ls, n_vs = ([int(x) for x in config[k]] for k in ("Ls", "n_vs"))
    if len(set(Ls)) < len(Ls) or len(set(n_vs)) < len(n_vs):
        raise ValueError(f"a grid's Ls {Ls} and n_vs {n_vs} are lists of "
                         "distinct values")
    return Ls, n_vs


def spec_extra(config: dict) -> dict:
    """A configuration's further ``WindowSweep`` fields, its ``spec``;
    refused where one names a field the harness sets itself."""
    spec = config.get("spec", {})
    if not isinstance(spec, dict):
        raise ValueError(f"a configuration's spec is an object of "
                         f"WindowSweep fields, got {spec!r}")
    clash = sorted(set(spec) & set(SPEC_FIELDS + REQUEST_KEYS))
    if clash:
        raise ValueError(f"a configuration's spec names {clash}, which the "
                         f"harness sets itself ({', '.join(SPEC_FIELDS)})")
    return spec


def check_config(config: dict) -> None:
    """Refuse a configuration with a key no reader knows, or a ``spec``
    that names a field the harness sets."""
    unknown = sorted(set(config) - CONFIG_KEYS)
    if unknown:
        raise ValueError(f"a configuration has unknown keys {unknown}; "
                         f"known: {sorted(CONFIG_KEYS)}")
    spec_extra(config)


def extra(q: dict) -> dict:
    """A request's ``WindowSweep`` fields beyond ``SPEC_FIELDS``: its
    configuration's ``spec``."""
    return {k: v for k, v in q.items()
            if k not in SPEC_FIELDS and k not in REQUEST_KEYS}


def _rng(seed: int, r: int, warm: bool) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, r, int(warm)])


def _delta_set(name: str, cell: dict, menu: list) -> list:
    out = [as_delta(x) for x in cell["deltas"][name]]
    missing = [d for d in out if d not in menu]
    if missing:
        raise ValueError(f"Δ set {name!r} has {missing}, not in the "
                         f"configuration's menu {menu}")
    return out


def rounds(config: dict, mix: dict, cell: dict, seed: int, *,
           warm: bool = False):
    """Yield round after round of request dicts, without end.

    ``warm`` gives the set-up's rounds: another stream, and the cut depth
    of one chunk (a burn-in of one chunk where the cell burns in at all),
    at the cell's own rows and chunk.
    """
    menu = [as_delta(x) for x in config["deltas"]]
    k = int(config["k_fuse"])
    burn = int(cell["burn_in"])
    steps = int(cell["n_steps"])
    if warm:
        burn, steps = (k if burn else 0), k
    Ls, n_vs = grid(config)
    spec = spec_extra(config)
    fields = SPEC_FIELDS + tuple(spec)
    common = dict(spec, Ls=Ls, n_vs=n_vs, replicas=int(cell["replicas"]),
                  burn_in=burn, backend=mix["backend"],
                  window=mix["window"], k_fuse=k,
                  rd_mode=bool(config["rd_mode"]),
                  border_both=bool(config["border_both"]),
                  steady_frac=float(config["steady_frac"]))
    prev: dict = {}
    r = 0
    while True:
        rng = _rng(seed, r, warm)
        stream = int(rng.integers(0, 2**32))
        cur: dict = {}
        out = []
        for entry in mix["requests"]:
            who = entry["requester"]
            if "deltas" in entry:
                q = dict(common, deltas=_delta_set(entry["deltas"], cell,
                                                   menu),
                         n_steps=steps, seed=stream)
            elif "draw" in entry:
                pool = _delta_set(entry["draw"]["from"], cell, menu)
                pick = rng.choice(len(pool), size=int(entry["draw"]["count"]),
                                  replace=False)
                q = dict(common, deltas=[pool[i] for i in sorted(pick)],
                         n_steps=steps, seed=stream)
            elif "same_as" in entry:
                q = dict(cur[entry["same_as"]])
            elif "extends" in entry:
                base = prev.get(entry["extends"])
                if base is None:          # the first round has none
                    continue
                q = dict(base, n_steps=base["n_steps"]
                         * int(entry["steps_factor"]),
                         extends=entry["extends"])
            else:
                raise ValueError(f"mix entry {entry} has no known kind")
            q = {f: q[f] for f in fields} | (
                {"extends": q["extends"]} if "extends" in q else {})
            cur[who] = q
            out.append(dict(q, requester=who))
        yield out
        prev = cur
        r += 1


def rows(q: dict) -> int:
    """Rows a request asks for: its Δs times its replicas at each point."""
    return len(q["deltas"]) * q["replicas"] * len(q["Ls"]) * len(q["n_vs"])


def pe_steps(q: dict) -> int:
    """PE-steps a request asks for, burn-in included: each point's rows
    times its ring length, summed over the grid."""
    return (sum(q["Ls"]) * len(q["n_vs"]) * len(q["deltas"]) * q["replicas"]
            * (q["burn_in"] + q["n_steps"]))
