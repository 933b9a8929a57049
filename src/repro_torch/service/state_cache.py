"""Burned-in-state cache: skip re-burning rows the service has seen before.

A port of ``repro.service.state_cache``, with the same LRU, the same
counters and the same npz format and ``CACHE_FORMAT_VERSION``: a cache
saved by either package loads in the other.

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
offset pair), one order over every key.  ``hits``/``misses``/``evictions``
count exactly as ``repro``'s do under the same calls (all three are
surfaced in ``ServiceStats`` and the CLI summary line).

Two tiers hold the rows.  The device tier keeps, per ring length L, one
slab of rows on the cache's ``device`` (τ ``(n, L)``, offset and comp
``(n,)``, float32), grown by doubling up to ``capacity(L) = min(max_rows,
budget_bytes // (4 (L + 2)))``; a hit there is spliced into a pass by
device gathers.  Rows past a slab's capacity are demoted to the host tier
(numpy rows, one copy down each); a host-tier hit crosses up once and is
promoted.  ``budget_bytes`` decides placement only: which rows hit, miss
or are evicted does not depend on it.  ``bytes_to_host`` and
``bytes_to_device`` count what crosses between the tiers (demotions,
``save``; promotions), ``device_hits``, ``promotions`` and ``demotions``
the rows.
"""
from __future__ import annotations

import io
import json
import os
from collections import OrderedDict

import numpy as np
import torch

from ..obs.trace import span_on

__all__ = ["StateCache", "CACHE_FORMAT_VERSION"]

#: on-disk format version of :meth:`StateCache.save`; bumped on layout
#: changes.  ``load`` refuses (returns 0, cache untouched) on mismatch.
CACHE_FORMAT_VERSION = 1


def index_on(idx, device: torch.device) -> torch.Tensor:
    """Row indices as an int64 tensor on ``device``.

    On a card the list goes up from pinned memory without blocking the
    host, so building an index never waits for the kernels queued ahead.
    """
    t = torch.tensor(idx, dtype=torch.int64,
                     pin_memory=device.type == "cuda")
    return t.to(device, non_blocking=True)


def _row_bytes(L: int) -> int:
    return 4 * (L + 2)


class _Slab:
    """The device tier of one ring length: rows in the slots of three
    arrays, and which key holds which slot."""

    def __init__(self, L: int, capacity: int, device: torch.device):
        self.capacity = capacity
        self.arrays = (torch.empty((0, L), dtype=torch.float32, device=device),
                       torch.empty((0,), dtype=torch.float32, device=device),
                       torch.empty((0,), dtype=torch.float32, device=device))
        self.slots: dict[tuple, int] = {}
        self.free: list[int] = []

    def take(self, n: int) -> list[int]:
        """``n`` free slots, growing the arrays (doubling, up to capacity)."""
        short = n - len(self.free)
        if short > 0:
            size = self.arrays[0].shape[0]
            grown = min(self.capacity, max(size + short, 2 * size))
            new = tuple(a.new_empty((grown,) + tuple(a.shape[1:]))
                        for a in self.arrays)
            for dst, src in zip(new, self.arrays):
                dst[:size] = src
            self.arrays = new
            self.free.extend(range(size, grown))
        slots = self.free[:n]
        del self.free[:n]
        return slots


class StateCache:
    """Row-granular LRU of burned-in states, on a device in front of the host.

    Keys are ``stream_key + (trial, delta)`` tuples (hashable); a row is
    ``(tau_row (L,), offset, offset_comp)`` in float32.

    Args:
      max_rows: the LRU bound, in rows, over both tiers.
      device: where the device tier lives (the service's device).
      budget_bytes: bytes of device memory each ring length's slab may
        hold; None is unbounded (on the CPU the device is the host).
    """

    def __init__(self, max_rows: int = 65536, *, device="cpu",
                 budget_bytes: int | None = None):
        if max_rows < 1:
            raise ValueError("max_rows must be >= 1")
        if budget_bytes is not None and budget_bytes < 0:
            raise ValueError("budget_bytes must be >= 0 or None")
        self.max_rows = max_rows
        self.device = torch.device(device)
        self.budget_bytes = budget_bytes
        self.tracer = None          # spans of the crossings go here
        self._rows: OrderedDict[tuple, int] = OrderedDict()   # key -> L
        self._host: dict[tuple, tuple] = {}       # key -> numpy row
        self._slabs: dict[int, _Slab] = {}        # L -> device tier
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.device_hits = 0        # hits served from the device tier
        self.promotions = 0         # rows moved host -> device tier
        self.demotions = 0          # rows moved device -> host tier
        self.bytes_to_host = 0      # demotions and save()
        self.bytes_to_device = 0    # host-tier rows brought up
        self.saves = 0              # successful save() calls
        self.loads = 0              # load() calls that restored >= 1 row
        self.restored_rows = 0      # rows brought back across processes
        self.dirty = False          # rows added since the last save/load

    def __len__(self) -> int:
        return len(self._rows)

    def capacity(self, L: int) -> int:
        """Rows of ring length ``L`` the device tier holds at most."""
        if self.budget_bytes is None:
            return self.max_rows
        return min(self.max_rows, self.budget_bytes // _row_bytes(L))

    def _slab(self, L: int) -> _Slab:
        slab = self._slabs.get(L)
        if slab is None:
            slab = self._slabs[L] = _Slab(L, self.capacity(L), self.device)
        return slab

    def _span(self, name: str):
        return span_on(self.tracer, name, cat="service")

    # -- lookups -----------------------------------------------------------

    def lookup(self, keys) -> list[bool]:
        """Whether each key is cached; counts and refreshes as ``get``."""
        found = []
        for key in keys:
            try:
                self._rows.move_to_end(key)
            except KeyError:
                self.misses += 1
                found.append(False)
                continue
            self.hits += 1
            slab = self._slabs.get(self._rows[key])
            if slab is not None and key in slab.slots:
                self.device_hits += 1
            found.append(True)
        return found

    def get(self, key: tuple):
        """The cached ``(tau_row, offset, comp)`` as tensors on the cache's
        device (copies), or None; refreshes LRU."""
        if not self.lookup([key])[0]:
            return None
        L = self._rows[key]
        out = (torch.empty((1, L), dtype=torch.float32, device=self.device),
               torch.empty((1,), dtype=torch.float32, device=self.device),
               torch.empty((1,), dtype=torch.float32, device=self.device))
        self.gather([key], [0], *out)
        return tuple(a[0] for a in out)

    def gather(self, keys, dest, tau, offset, comp) -> None:
        """Copy cached rows ``keys[i]`` into rows ``dest[i]`` of ``tau``,
        ``offset`` and ``comp`` (on the cache's device).

        Device-tier rows come by one ``index_select`` per array; host-tier
        rows cross up once, land in the output, and are promoted.  Counts
        nothing: :meth:`lookup` counted the hits.
        """
        if not keys:
            return
        slab = self._slab(tau.shape[1])
        on_dev = [i for i, k in enumerate(keys) if k in slab.slots]
        if on_dev:
            src = index_on([slab.slots[keys[i]] for i in on_dev], self.device)
            dst = index_on([dest[i] for i in on_dev], self.device)
            for out, arr in zip((tau, offset, comp), slab.arrays):
                out.index_copy_(0, dst, arr.index_select(0, src))
        up = [i for i, k in enumerate(keys) if k not in slab.slots]
        if not up:
            return
        ukeys = [keys[i] for i in up]
        with self._span("state_cache.to_device"):
            rows = [self._host[k] for k in ukeys]
            got = (torch.as_tensor(np.stack([r[0] for r in rows]),
                                   device=self.device),
                   torch.as_tensor(np.array([r[1] for r in rows], np.float32),
                                   device=self.device),
                   torch.as_tensor(np.array([r[2] for r in rows], np.float32),
                                   device=self.device))
            self.bytes_to_device += len(ukeys) * _row_bytes(tau.shape[1])
            dst = index_on([dest[i] for i in up], self.device)
            for out, arr in zip((tau, offset, comp), got):
                out.index_copy_(0, dst, arr)
        self._place(slab, ukeys, got, promoted=True, pinned=set(keys))

    # -- puts ----------------------------------------------------------------

    def put(self, key: tuple, tau_row, offset, comp) -> None:
        self.put_batch([key], *(
            torch.as_tensor(a, dtype=torch.float32,
                            device=self.device).reshape(1, -1)
            for a in (tau_row, offset, comp)))

    def put_batch(self, keys, tau, offset, comp) -> None:
        """Cache rows ``i -> keys[i]`` of a burned batch state (copies).

        The LRU moves and evicts as ``repro``'s row by row; the surviving
        rows then go to the device tier in one ``index_copy_`` per array,
        the oldest demoted where the slab is full.
        """
        if not len(keys):
            return
        arrays = (torch.as_tensor(tau, dtype=torch.float32,
                                  device=self.device),
                  torch.as_tensor(offset, dtype=torch.float32,
                                  device=self.device).reshape(-1),
                  torch.as_tensor(comp, dtype=torch.float32,
                                  device=self.device).reshape(-1))
        L = arrays[0].shape[1]
        for key in keys:
            if key in self._rows:
                self._free(key, self._rows[key])
            self._rows[key] = L
            self._rows.move_to_end(key)
            while len(self._rows) > self.max_rows:
                self._free(*self._rows.popitem(last=False))
                self.evictions += 1
        self.dirty = True
        last = {k: i for i, k in enumerate(keys)}     # a repeat: last wins
        kept = sorted((i, k) for k, i in last.items() if k in self._rows)
        rows = [i for i, _ in kept]
        if rows != list(range(len(rows))):
            idx = index_on(rows, self.device)
            arrays = tuple(a.index_select(0, idx) for a in arrays)
        self._place(self._slab(L), [k for _, k in kept], arrays,
                    promoted=False)

    def _free(self, key: tuple, L: int) -> None:
        """Release a row's storage in whichever tier holds it."""
        slab = self._slabs.get(L)
        if slab is not None and key in slab.slots:
            slab.free.append(slab.slots.pop(key))
        else:
            self._host.pop(key, None)

    def _place(self, slab: _Slab, keys, arrays, promoted: bool,
               pinned=frozenset()) -> None:
        """Give ``keys`` (newest last, rows of ``arrays`` on the device)
        device slots, as many as the slab holds, demoting its least
        recently used rows outside ``pinned`` to make room; the rest go to
        (or, promoted, stay in) the host tier."""
        n = min(len(keys), slab.capacity)
        room = slab.capacity - len(slab.slots)
        if n > room:
            old = []
            for key in self._rows:                # LRU order, oldest first
                if key in slab.slots and key not in pinned:
                    old.append(key)
                    if len(old) == n - room:
                        break
            if old:
                self._demote(slab, old)
            n = min(n, room + len(old))
        rest = len(keys) - n
        if rest and not promoted:
            with self._span("state_cache.to_host"):
                self._to_host(keys[:rest], tuple(a[:rest] for a in arrays))
        if not n:
            return
        slots = slab.take(n)
        idx = index_on(slots, self.device)
        for dst, src in zip(slab.arrays, arrays):
            dst.index_copy_(0, idx, src[rest:])
        for key, slot in zip(keys[rest:], slots):
            slab.slots[key] = slot
            if promoted:
                del self._host[key]
        if promoted:
            self.promotions += n

    def _demote(self, slab: _Slab, keys) -> None:
        with self._span("state_cache.to_host"):
            idx = index_on([slab.slots[k] for k in keys], self.device)
            self._to_host(keys, tuple(a.index_select(0, idx)
                                      for a in slab.arrays))
        for key in keys:
            slab.free.append(slab.slots.pop(key))

    def _to_host(self, keys, arrays) -> None:
        tau, off, comp = (a.cpu().numpy() for a in arrays)
        for i, key in enumerate(keys):
            self._host[key] = (tau[i].copy(), off[i], comp[i])
        self.demotions += len(keys)
        self.bytes_to_host += len(keys) * _row_bytes(tau.shape[1])

    # -- cross-process persistence ----------------------------------------

    def save(self, path) -> int:
        """Persist every cached row to ``path`` (npz + key manifest).

        Atomic (written to ``path + ".tmp"`` then renamed) and versioned.
        Rows are grouped by ring length (keys with different ``L`` coexist
        in one cache) and stored in LRU order, oldest first, so a reloaded
        cache evicts in the same order the live one would have.  Device-tier
        rows come down in one gather per ring length.  Returns the number
        of rows written.

        Key components are JSON-serialized; ``Δ = inf`` round-trips via
        Python's ``Infinity`` literal extension, and every component type
        the service uses (str / int / float / bool) survives exactly.
        """
        groups: dict[int, list] = {}            # ring length -> [key]
        for key, L in self._rows.items():       # OrderedDict: LRU order
            groups.setdefault(L, []).append(key)
        manifest = {"format": CACHE_FORMAT_VERSION,
                    "groups": [{"L": L, "keys": [list(k) for k in keys]}
                               for L, keys in groups.items()]}
        arrays = {"manifest": np.frombuffer(
            json.dumps(manifest).encode(), dtype=np.uint8)}
        for gi, (L, keys) in enumerate(groups.items()):
            tau = np.empty((len(keys), L), np.float32)
            off = np.empty((len(keys),), np.float32)
            comp = np.empty((len(keys),), np.float32)
            slab = self._slabs.get(L)
            on_dev = [] if slab is None else \
                [i for i, k in enumerate(keys) if k in slab.slots]
            if on_dev:
                idx = index_on([slab.slots[keys[i]] for i in on_dev],
                               self.device)
                for out, arr in zip((tau, off, comp), slab.arrays):
                    out[on_dev] = arr.index_select(0, idx).cpu().numpy()
                self.bytes_to_host += len(on_dev) * _row_bytes(L)
            for i, key in enumerate(keys):
                if key in self._host:
                    tau[i], off[i], comp[i] = self._host[key]
            arrays[f"tau_{gi}"] = tau
            arrays[f"off_{gi}"] = off
            arrays[f"comp_{gi}"] = comp
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
        """Restore rows saved by :meth:`save` into the host tier; returns
        rows restored (each is promoted on its first hit).

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
                        (k, L, (tau[i].copy(), off[i], comp[i]))
                        for i, k in enumerate(keys))
        except Exception:
            return 0
        # restored rows enter colder than any live row (live values are
        # fresher), keeping their saved LRU order among themselves
        merged: OrderedDict[tuple, int] = OrderedDict()
        n = 0
        for key, L, row in restored:
            if key not in self._rows:
                merged[key] = L
                self._host[key] = row
                n += 1
        merged.update(self._rows)
        self._rows = merged
        while len(self._rows) > self.max_rows:
            self._free(*self._rows.popitem(last=False))
            self.evictions += 1
        if n:
            self.loads += 1
            self.restored_rows += n
        return n
