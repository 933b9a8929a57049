"""Burned-in-state cache: skip re-burning rows the service has seen before.

A copy of ``repro.service.state_cache`` (numpy only), with the same npz
format and ``CACHE_FORMAT_VERSION``: a cache saved by either package loads
in the other.  The service converts rows between torch and numpy at its
boundary.

The burn-in phase dominates a sweep's cost (hundreds to thousands of steps
against a few hundred measured), and it is *deterministic*: a row's burned
state is a pure function of ``(stream_key, trial, Δ)`` — the compat fields
that pin the trajectory (``CompatKey.stream_key``, which includes the burn
length) plus the row coordinate.  Because every ensemble row is an
independent ring, rows can be burned in any grouping and reassembled
freely, so the cache works at *row* granularity: a later pass burns only
its cache-missing rows in a sub-pass and splices the rest in, bit-identical
to burning everything from scratch (asserted in tests/test_torch_service.py).

Reuse shows up across requests (two users sweeping overlapping Δ grids, a
longer ``n_steps`` follow-up) — and, via :meth:`StateCache.save`/
:meth:`StateCache.load`, across *processes*: ``--state-cache PATH`` on the
service CLI resumes from the burned rows an earlier run paid for, with
responses bit-identical to an uninterrupted run.

LRU-bounded in *rows* (one row holds an ``(L,)`` float32 ring + the Kahan
offset pair), so the bound tracks actual memory: ``max_rows * (L + 2) * 4``
bytes per ring size.  ``hits``/``misses``/``evictions`` counters make
cache thrash under ``max_rows`` pressure observable (all three are
surfaced in ``ServiceStats`` and the CLI summary line).
"""
from __future__ import annotations

import io
import json
import os
from collections import OrderedDict

import numpy as np

__all__ = ["StateCache", "CACHE_FORMAT_VERSION"]

#: on-disk format version of :meth:`StateCache.save`; bumped on layout
#: changes.  ``load`` refuses (returns 0, cache untouched) on mismatch.
CACHE_FORMAT_VERSION = 1


class StateCache:
    """Row-granular LRU of burned-in states.

    Keys are ``stream_key + (trial, delta)`` tuples (hashable); values are
    ``(tau_row (L,), offset, offset_comp)`` float32 numpy copies — host
    memory, detached from any device buffer.
    """

    def __init__(self, max_rows: int = 65536):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        self.max_rows = max_rows
        self._rows: OrderedDict[tuple, tuple] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.saves = 0              # successful save() calls
        self.loads = 0              # load() calls that restored >= 1 row
        self.restored_rows = 0      # rows brought back across processes
        self.dirty = False          # rows added since the last save/load

    def __len__(self) -> int:
        return len(self._rows)

    def get(self, key: tuple):
        """The cached ``(tau_row, offset, comp)`` or None; refreshes LRU."""
        try:
            self._rows.move_to_end(key)
        except KeyError:
            self.misses += 1
            return None
        self.hits += 1
        return self._rows[key]

    def put(self, key: tuple, tau_row, offset, comp) -> None:
        self._rows[key] = (np.array(tau_row, np.float32, copy=True),
                           np.float32(offset), np.float32(comp))
        self._rows.move_to_end(key)
        self.dirty = True
        while len(self._rows) > self.max_rows:
            self._rows.popitem(last=False)
            self.evictions += 1

    def put_batch(self, keys, tau, offset, comp) -> None:
        """Cache rows ``i -> keys[i]`` of a burned batch state."""
        tau = np.asarray(tau)
        offset = np.asarray(offset)
        comp = np.asarray(comp)
        for i, key in enumerate(keys):
            self.put(key, tau[i], offset[i], comp[i])

    # -- cross-process persistence ----------------------------------------

    def save(self, path) -> int:
        """Persist every cached row to ``path`` (npz + key manifest).

        Atomic (written to ``path + ".tmp"`` then renamed) and versioned.
        Rows are grouped by ring length (keys with different ``L`` coexist
        in one cache) and stored in LRU order, oldest first, so a reloaded
        cache evicts in the same order the live one would have.  Returns
        the number of rows written.

        Key components are JSON-serialized; ``Δ = inf`` round-trips via
        Python's ``Infinity`` literal extension, and every component type
        the service uses (str / int / float / bool) survives exactly.
        """
        groups: dict[int, list] = {}            # ring length -> [(key, val)]
        for key, val in self._rows.items():     # OrderedDict: LRU order
            groups.setdefault(int(val[0].shape[0]), []).append((key, val))
        manifest = {"format": CACHE_FORMAT_VERSION,
                    "groups": [{"L": L, "keys": [list(k) for k, _ in rows]}
                               for L, rows in groups.items()]}
        arrays = {"manifest": np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)}
        for gi, (L, rows) in enumerate(groups.items()):
            arrays[f"tau_{gi}"] = np.stack([v[0] for _, v in rows])
            arrays[f"off_{gi}"] = np.asarray([v[1] for _, v in rows],
                                             np.float32)
            arrays[f"comp_{gi}"] = np.asarray([v[2] for _, v in rows],
                                              np.float32)
        tmp = f"{path}.tmp"
        buf = io.BytesIO()
        np.savez_compressed(buf, **arrays)
        with open(tmp, "wb") as fh:
            fh.write(buf.getvalue())
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
        self.dirty = False
        self.saves += 1
        return len(self._rows)

    def load(self, path) -> int:
        """Restore rows saved by :meth:`save`; returns rows restored.

        Corruption-tolerant by contract: a missing file, truncated/garbage
        bytes, a bad manifest, mismatched array shapes, or a format-version
        mismatch all return 0 and leave the cache exactly as it was — a
        damaged cache file degrades to a cold start, never to a crash
        (restarting cleanly *is* the daemon's recovery path).  Restored
        rows keep their saved LRU order and count as neither hits nor
        misses; rows already in the cache keep their (fresher) live value.
        """
        try:
            with np.load(path) as npz:
                manifest = json.loads(bytes(npz["manifest"]).decode())
                if manifest.get("format") != CACHE_FORMAT_VERSION:
                    return 0
                restored = []
                for gi, group in enumerate(manifest["groups"]):
                    L = int(group["L"])
                    keys = [tuple(k) for k in group["keys"]]
                    tau = np.asarray(npz[f"tau_{gi}"], np.float32)
                    off = np.asarray(npz[f"off_{gi}"], np.float32)
                    comp = np.asarray(npz[f"comp_{gi}"], np.float32)
                    if tau.shape != (len(keys), L) or \
                            off.shape != (len(keys),) or \
                            comp.shape != (len(keys),):
                        return 0
                    restored.extend(
                        (k, (tau[i].copy(), off[i], comp[i]))
                        for i, k in enumerate(keys))
        except Exception:
            return 0
        # restored rows enter colder than any live row (live values are
        # fresher), keeping their saved LRU order among themselves
        merged: OrderedDict[tuple, tuple] = OrderedDict()
        n = 0
        for key, val in restored:
            if key not in self._rows:
                merged[key] = val
                n += 1
        for key, val in self._rows.items():
            merged[key] = val
        self._rows = merged
        while len(self._rows) > self.max_rows:
            self._rows.popitem(last=False)
            self.evictions += 1
        if n:
            self.loads += 1
            self.restored_rows += n
        return n
