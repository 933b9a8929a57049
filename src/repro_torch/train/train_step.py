"""Train/serve step factories with microbatching (port of
``repro.train.train_step``).

The port's model owns its parameters, so the training state holds the
module's own tensors: ``state = {"params", "opt": {"m", "v", "count"},
"step"}`` with ``state["params"]`` the module's parameter tree, which
``train_step`` updates in place.  The step runs on one device: a
``Parallelism`` (the reference's ``par``) belongs to A14.
"""
from __future__ import annotations

import torch

from ..models import build_model
from ..optim import adamw
from ..optim.adamw import AdamWConfig
from ..tree import tree_leaves

from typing import TYPE_CHECKING
if TYPE_CHECKING:  # hints only
    from ..configs.base import ModelConfig


def _single_device(par) -> None:
    if par is not None:
        raise NotImplementedError(
            "the port trains on one device; sharded steps (par) come with "
            "the sharding rules (ROADMAP, queue A, A14)")


def _split(batch: dict, n: int, i: int) -> dict:
    """Microbatch ``i`` of ``n``: rows ``[i·B/n, (i+1)·B/n)`` of every
    entry (the reference's reshape to ``(n, B/n, ...)``)."""
    out = {}
    for k, a in batch.items():
        if a.shape[0] % n:
            raise ValueError(f"batch {k} of {a.shape[0]} rows does not split "
                             f"into {n} microbatches")
        m = a.shape[0] // n
        out[k] = a[i * m:(i + 1) * m]
    return out


def make_train_step(cfg: ModelConfig, par=None,
                    opt_cfg: AdamWConfig = AdamWConfig(), *, device=None,
                    seed: int = 0):
    """Returns ``(model, train_step)``; ``train_step(state, batch) ->
    (state, metrics)``.

    The model is built on ``device`` (``None`` = the GPU) from generator
    seed ``seed``.  Gradient accumulation over ``cfg.microbatches`` splits
    the batch's leading dim: each microbatch's gradient is added as
    ``acc += g.float() / n`` from zero, in order, as the reference's scan
    adds it; the loss and metrics are the microbatches' means.
    """
    _single_device(par)
    model = build_model(cfg, device=device, seed=seed)
    n_micro = cfg.microbatches

    def grads_of(batch):
        leaves = list(model.trainable_leaves().values())
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state, batch):
        params = state["params"]
        if params["embed"]["table"] is not model.params["embed"]["table"]:
            raise ValueError("state['params'] is not this model's parameter "
                             "tree (use init_train_state(model))")
        if n_micro == 1:
            loss, metrics, grads = grads_of(batch)
        else:
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in tree_leaves(params)]
            losses, metricses = [], []
            for i in range(n_micro):
                loss_i, m_i, g = grads_of(_split(batch, n_micro, i))
                for a, gi in zip(acc, g):
                    a.add_(gi.float() / n_micro)
                losses.append(loss_i)
                metricses.append(m_i)
            grads = acc
            loss = torch.mean(torch.stack(losses))
            metrics = {k: torch.mean(torch.stack([m[k] for m in metricses]))
                       for k in metricses[0]}
        grads = _like(params, iter(grads))
        params, new_opt, opt_metrics = adamw.update(grads, state["opt"],
                                                    params, opt_cfg)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return model, train_step


def _like(tree, leaves):
    """``leaves`` (an iterator, in the tree's leaf order) as a tree shaped
    like ``tree``."""
    if isinstance(tree, dict):
        return {k: _like(tree[k], leaves) for k in sorted(tree)}
    return next(leaves)


def init_train_state(model) -> dict:
    """The training state of ``model``: its own parameter tree, zero
    moments and count, step 0."""
    params = model.params.as_dict(lambda t: t)
    return {"params": params, "opt": adamw.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=model.device)}


def make_prefill_step(cfg: ModelConfig, par=None, *, device=None,
                      seed: int = 0):
    """``(model, prefill)``; ``prefill(batch) -> (logits, cache)`` reads the
    model's own parameters."""
    _single_device(par)
    model = build_model(cfg, device=device, seed=seed)
    return model, model.prefill


def make_decode_step(cfg: ModelConfig, par=None, *, device=None,
                     seed: int = 0):
    """``(model, decode)``; ``decode(cache, tokens, pos) -> (logits,
    cache)`` reads the model's own parameters and writes the cache in
    place."""
    _single_device(par)
    model = build_model(cfg, device=device, seed=seed)
    return model, model.decode_step
