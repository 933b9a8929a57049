"""AdamW with decoupled weight decay, global-norm clipping, mixed precision
(port of ``repro.optim.adamw``).

Trees are nested dicts of tensors.  The arithmetic and its order are the
reference's, in fp32; the moments keep the parameters' dtype (fp32 by
default, bf16 where the config's ``param_dtype`` is).  ``update`` writes
the new parameters and moments in place, into the tensors it was given
(a module's own parameters), under ``torch.no_grad()``.  Weight decay is
chosen by the leaf's ``jax.tree_util.keystr`` path, as the reference
chooses it (``tree.keystr``).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..tree import tree_leaves, tree_leaves_with_path, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def lr_schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup -> cosine decay to min_lr_frac * peak (fp32)."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.peak_lr * torch.clamp(warm, max=1.0) * cos


def _decayable(path: str) -> bool:
    """Weight decay applies to matrices, not to norms/biases/1-d params.
    ``path`` is a ``keystr``, e.g. ``"['layers']['attn']['wq']"``; the tag
    ``'b`` matches every key that starts with ``b``."""
    for tag in ("scale", "bias", "A_log", "dt_bias", "'D'", "'b"):
        if tag in path:
            return False
    return True


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32, summed leaf by
    leaf in the reference's order."""
    sq = None
    for g in tree_leaves(tree):
        term = torch.sum(torch.square(g.float()))
        sq = term if sq is None else sq + term
    return torch.sqrt(sq)


def init(params) -> dict:
    """Zero moments of the parameters' shapes and dtypes, and the count."""
    def z(p):
        return torch.zeros_like(p, requires_grad=False)
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(z, params), "v": tree_map(z, params),
            "count": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def update(grads, opt_state, params, cfg: AdamWConfig):
    """One AdamW step, in place: the leaves of ``params`` and of
    ``opt_state``'s ``m`` and ``v`` are overwritten.  Returns
    ``(params, new_opt_state, metrics)``; the count is a new tensor."""
    count = opt_state["count"] + 1
    lr = lr_schedule(cfg, count)
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    bc1 = 1 - torch.pow(cfg.b1, count.float())
    bc2 = 1 - torch.pow(cfg.b2, count.float())
    flat = zip(tree_leaves_with_path(params), tree_leaves(grads),
               tree_leaves(opt_state["m"]), tree_leaves(opt_state["v"]))
    for (path, p), g, m, v in flat:
        g = g.float() * scale
        m32 = m.float() * cfg.b1 + (1 - cfg.b1) * g
        v32 = v.float() * cfg.b2 + (1 - cfg.b2) * g * g
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if _decayable(path):
            step = step + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * step)
        m.copy_(m32)
        v.copy_(v32)
    new_state = {"m": opt_state["m"], "v": opt_state["v"], "count": count}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
