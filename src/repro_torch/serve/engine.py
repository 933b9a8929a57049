"""Batched serving engine with Δ-window lane synchronization (port of
``repro.serve.engine``).

Continuous batching: B decode lanes advance token-by-token; lanes finish and
are refilled from a request queue.  The Δ-window rule (paper Eq. (3)) bounds
how far any lane's *virtual completion time* may run ahead of the slowest
lane before the engine forces a flush — bounding head-of-line blocking and
the per-lane KV/state retention.

The engine drives any model exposing ``prefill``/``decode_step`` and
owning its parameters (``models.DecoderModel``), so it takes no params
argument.  The lane gate is ``DeltaScheduler.offer``, whose admission
predicate is the shared :func:`repro_torch.service.scheduler.window_admission`.

As in the reference, prompts are left-padded with token 0 and no mask
hides the pads (ROADMAP, queue C, C7), and decode runs on from the padded
prompt length into a cache of that length (C6).  There is no jit: a step
copies its ``(n,)`` next tokens to the host once, where the reference
reads each lane's token on its own; the tokens are the same.
"""
from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..distributed.delta_sync import DeltaScheduler, DeltaSyncConfig


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray          # (S,) int32
    max_new_tokens: int = 32


@dataclasses.dataclass
class Result:
    uid: int
    tokens: list


class ServeEngine:
    """``ServeEngine(model, *, batch_lanes, max_len, delta, seed,
    device=None)``: serves ``model`` on ``device`` (``None`` = the GPU),
    moving the model there."""

    def __init__(self, model, *, batch_lanes: int, max_len: int,
                 delta: float = 64.0, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.lanes = batch_lanes
        self.max_len = max_len
        self.queue: deque[Request] = deque()
        self.results: dict[int, Result] = {}
        self.scheduler = DeltaScheduler(
            DeltaSyncConfig(n_workers=batch_lanes, delta=delta, seed=seed))

    def submit(self, req: Request):
        self.queue.append(req)

    def _prefill_batch(self, reqs):
        S = max(len(r.prompt) for r in reqs)
        toks = np.zeros((len(reqs), S), np.int64)
        for i, r in enumerate(reqs):
            toks[i, S - len(r.prompt):] = r.prompt      # left-pad
        batch = {"tokens": torch.as_tensor(toks, device=self.device)}
        logits, cache = self.model.prefill(batch)
        return logits, cache, S

    def run(self, max_steps: int = 10_000):
        """Drain the queue; returns {uid: Result}."""
        while self.queue:
            reqs = [self.queue.popleft()
                    for _ in range(min(self.lanes, len(self.queue)))]
            logits, cache, pos0 = self._prefill_batch(reqs)
            n = len(reqs)
            tok = torch.argmax(logits, -1)[:, None]
            out = [[t] for t in tok[:, 0].tolist()]
            done = np.zeros(n, bool)
            budget = np.array([r.max_new_tokens for r in reqs])
            for step in range(min(self.max_len - pos0 - 1, max_steps)):
                # Δ-window lane gate: lanes too far ahead idle this round
                mask = self.scheduler.offer()[:n]
                logits, cache = self.model.decode_step(cache, tok, pos0 + step)
                nxt = torch.argmax(logits, -1)[:, None]
                tok = torch.where(
                    torch.as_tensor(mask, device=self.device)[:, None], nxt,
                    tok)
                nxt_host = nxt[:, 0].cpu().numpy()    # the step's one copy
                for i in range(n):
                    if mask[i] and not done[i]:
                        out[i].append(int(nxt_host[i]))
                        if len(out[i]) >= budget[i]:
                            done[i] = True
                if done.all():
                    break
            for r, toks in zip(reqs, out):
                self.results[r.uid] = Result(r.uid, toks)
        return self.results

    @property
    def lane_utilization(self) -> float:
        return self.scheduler.utilization
