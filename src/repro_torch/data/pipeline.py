"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

Batches are a pure function of (seed, step) via the counter-based event
stream (``core.events``), so recovery replays batch t bit for bit after a
restart (``train/fault.py``), and a batch equals the reference's: the
words are the same hash, and the Zipf map runs in numpy float64 as the
reference's does.  The token stream is Zipf-like over the vocab with a
shifted-label LM objective.  A background-thread prefetcher overlaps host
batch assembly with device compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

import numpy as np
import torch

from ..core.events import counter_bits
from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_alpha: float = 1.1


def _zipf_map(u: np.ndarray, vocab: int, alpha: float) -> np.ndarray:
    """Map uniform [0,1) to bounded-Zipf ranks over [0, vocab).

    Inverse CDF of p(r) ∝ r^-alpha on r ∈ [1, V] (continuous approximation):
    r = (1 + u·(V^{1-α} − 1))^{1/(1-α)}.
    """
    one_m_a = 1.0 - alpha
    r = (1.0 + u * (vocab ** one_m_a - 1.0)) ** (1.0 / one_m_a)
    return np.clip(r - 1.0, 0, vocab - 1).astype(np.int32)


def make_batch(cfg: DataConfig, step: int, device=None) -> dict:
    """Batch t as a pure function of (seed, step): ``tokens`` and shifted
    ``labels``, (global_batch, seq_len) int64 on ``device`` (``None`` =
    the GPU), equal to the reference's int32 values."""
    bits = counter_bits(
        cfg.seed, step, torch.arange(cfg.global_batch)[:, None],
        torch.arange(cfg.seq_len + 1)[None, :])
    u = bits[..., 0].numpy().astype(np.float64) / 2.0**32
    toks = torch.from_numpy(_zipf_map(u, cfg.vocab_size, cfg.zipf_alpha)
                            .astype(np.int64))
    dev = resolve_device(device)
    return {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}


class Prefetcher:
    """Background-thread batch prefetch with a bounded queue."""

    def __init__(self, cfg: DataConfig, start_step: int = 0, depth: int = 2,
                 device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        s = self._step
        while not self._stop.is_set():
            try:
                self._q.put(make_batch(self.cfg, s, self.device), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __next__(self):
        return self._q.get()

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2)
