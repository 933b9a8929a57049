"""Train/serve step factories with sharding and microbatching (port of
``repro.train.train_step``).

The port's model owns its parameters, so the training state holds the
module's own tensors: ``state = {"params", "opt": {"m", "v", "count"},
"step"}`` with ``state["params"]`` the module's parameter tree, which
``train_step`` updates in place.

With a ``Parallelism`` (``par``), the model is built with
``make_constrain(par, cfg.n_heads)`` and its parameters are distributed
as DTensors by ``param_pspecs`` (every rank builds the same parameters
from the seed and keeps its shard); the moments take the parameters'
placements (``state_pspecs``).  The steps take the same global batch on
every rank, plain tensors, and shard them by ``batch_pspecs`` (a decode
cache by ``cache_pspecs``); they run under DTensor's implicit
replication, so a plain tensor made inside the model (positions, masks,
zeros) joins the DTensors as a replicated one.  Metrics come back as
plain tensors.
"""
from __future__ import annotations

import contextlib

import torch
from torch import nn

from ..distributed.sharding import (Parallelism, batch_pspecs, cache_pspecs,
                                    distribute, make_constrain,
                                    param_pspecs, param_shardings,
                                    to_shardings)
from ..models import build_model
from ..models.sharded import is_dt, replicate
from ..optim import adamw
from ..optim.adamw import AdamWConfig
from ..tree import tree_leaves, tree_map

from typing import TYPE_CHECKING
if TYPE_CHECKING:  # hints only
    from ..configs.base import ModelConfig


def _build(cfg: ModelConfig, par, device, seed):
    """The model of ``cfg``; under ``par`` with its parameters sharded."""
    if par is None:
        return build_model(cfg, device=device, seed=seed)
    if not isinstance(par, Parallelism):
        raise TypeError(f"par must be a Parallelism, not "
                        f"{type(par).__name__}")
    model = build_model(cfg, make_constrain(par, cfg.n_heads),
                        device=device, seed=seed)
    shard_params(model, par)
    return model


def shard_params(model, par: Parallelism) -> None:
    """Replace every parameter of ``model.params`` by its shard, a DTensor
    ``nn.Parameter`` placed by ``param_pspecs``."""
    shardings = param_shardings(model.params.as_dict(lambda t: t), par)

    def walk(mod, sh):
        for k, p in list(mod._parameters.items()):
            setattr(mod, k, nn.Parameter(distribute(p.detach(), sh[k]),
                                         requires_grad=p.requires_grad))
        for k, m in mod._modules.items():
            walk(m, sh[k])
    walk(model.params, shardings)
    model._compute = None


def _spmd(par):
    """The context a sharded step runs in: DTensor's implicit replication
    of plain tensors."""
    if par is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def shard_batch(batch: dict, par: Parallelism) -> dict:
    """A global batch of plain tensors (the same on every rank) as
    DTensors placed by ``batch_pspecs``; DTensors pass as they are."""
    plain = {k: v for k, v in batch.items() if not is_dt(v)}
    sh = to_shardings(batch_pspecs(plain, par), par.mesh)
    return {k: distribute(v, sh[k]) if k in sh else v
            for k, v in batch.items()}


def shard_cache(cache: dict, par: Parallelism) -> dict:
    """A decode cache of plain tensors as DTensors placed by
    ``cache_pspecs``; DTensor leaves pass as they are."""
    sh = to_shardings(cache_pspecs(cache, par), par.mesh)
    return tree_map(lambda a, s: a if is_dt(a) else distribute(a, s),
                    cache, sh)


def _plain(t):
    """A metric as a plain tensor (a DTensor's whole value)."""
    return t.full_tensor() if is_dt(t) else t


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
    model = _build(cfg, par, device, seed)
    n_micro = cfg.microbatches

    def grads_of(batch):
        leaves = list(model.trainable_leaves().values())
        if par is not None:
            batch = shard_batch(batch, par)
        loss, metrics = model.loss(batch)
        grads = torch.autograd.grad(replicate(loss), leaves,
                                    materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(state, batch):
        with _spmd(par):
            state, metrics = step(state, batch)
        return state, {k: _plain(v) for k, v in metrics.items()}

    def step(state, batch):
        params = state["params"]
        if params["embed"]["table"] is not model.params["embed"]["table"]:
            raise ValueError("state['params'] is not this model's parameter "
                             "tree (use init_train_state(model))")
        if n_micro == 1:
            loss, metrics, grads = grads_of(batch)
        else:
            acc = [torch.zeros_like(p, dtype=torch.float32)
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


def state_pspecs(state, par: Parallelism):
    """Spec tree of a training state: the moments take the parameters'
    specs, the count and the step are replicated."""
    pp = param_pspecs(state["params"], par)
    return {
        "params": pp,
        "opt": {"m": pp, "v": pp, "count": ()},
        "step": (),
    }


def make_prefill_step(cfg: ModelConfig, par=None, *, device=None,
                      seed: int = 0):
    """``(model, prefill)``; ``prefill(batch) -> (logits, cache)`` reads the
    model's own parameters (under ``par``: batch sharded by
    ``batch_pspecs``)."""
    model = _build(cfg, par, device, seed)
    if par is None:
        return model, model.prefill

    def prefill(batch, **kw):
        with _spmd(par):
            return model.prefill(shard_batch(batch, par), **kw)
    return model, prefill


def make_decode_step(cfg: ModelConfig, par=None, *, device=None,
                     seed: int = 0):
    """``(model, decode)``; ``decode(cache, tokens, pos) -> (logits,
    cache)`` reads the model's own parameters and writes the cache in
    place (under ``par``: a plain cache is first placed by
    ``cache_pspecs``, the tokens by ``batch_pspecs``)."""
    model = _build(cfg, par, device, seed)
    if par is None:
        return model, model.decode_step

    def decode(cache, tokens, pos):
        with _spmd(par):
            tokens = shard_batch({"tokens": tokens}, par)["tokens"]
            return model.decode_step(shard_cache(cache, par), tokens, pos)
    return model, decode
