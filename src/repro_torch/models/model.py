"""Model factory: family -> model class, plus the pure-SSM decoder (port of
``repro.models.model``).

``build_model`` builds all five families: ``dense`` and ``moe``
(``DecoderModel``), ``ssm`` (``SSMModel``), ``hybrid`` (``HybridModel``)
and ``encdec`` (``EncDecModel``).
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from ..launch.cost import scan
from .encdec import EncDecModel
from .hybrid import HybridModel
from .layers import embed_init, embed_lookup
from .ssm import ssm_apply, ssm_decode_step, ssm_init
from .transformer import (Constrain, DecoderModel, LMModule, _at, _dt, _noop,
                          _norm, _norm_init, _remat, _unstack)

if TYPE_CHECKING:  # hints only
    from ..configs.base import ModelConfig


class SSMModel(LMModule):
    """Attention-free Mamba2 decoder (mamba2-130m family).

    ``params["layers"]["ssm"]["in_proj"]`` is ``(n_layers, d, proj_out)``.
    The compute copy follows the reference's cast of the stacked tree, so
    the per-layer ``A_log``, ``D``, ``dt_bias``, ``norm_scale`` and
    ``conv_b`` (2-D once stacked) are in the compute dtype too.
    """

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        pd = _dt(cfg.param_dtype)
        lead = (cfg.n_layers,)
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
            "layers": {"norm": _norm_init(cfg, pd, gen.device, lead),
                       "ssm": ssm_init(gen, cfg.ssm, pd, lead)},
            "final_norm": _norm_init(cfg, pd, gen.device),
        }

    def _layer_views(self, tree):
        return _unstack(tree["layers"], (self.cfg.n_layers,))

    def loss(self, batch):
        """``batch["tokens"]``, ``batch["labels"]`` (B, S) -> (loss,
        {"nll"}), differentiable in the module's parameters."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, layers = self._live()
        x = self.constrain(embed_lookup(params["embed"], batch["tokens"], cd),
                           "act")

        def body(x, p):
            p = self._view(p)
            h, _ = ssm_apply(_norm(x, p["norm"], cfg), p["ssm"], cfg.ssm, cd)
            return self.constrain(x + h, "act")

        body = _remat(body, cfg.remat)
        x, _ = scan(lambda i, x: (body(x, layers[i]), None), x, len(layers),
                    xs=layers)
        x = _norm(x, params["final_norm"], cfg)
        loss = self._ce(x, params["embed"]["table"], batch)
        return loss, {"nll": loss}

    def init_cache(self, batch_size: int):
        cfg = self.cfg
        s = cfg.ssm
        return {
            "ssm": torch.zeros((cfg.n_layers, batch_size, s.n_heads,
                                s.head_dim, s.d_state), device=self.device),
            "conv": torch.zeros((cfg.n_layers, batch_size, s.d_conv - 1,
                                 s.conv_dim), dtype=_dt(cfg.compute_dtype),
                                device=self.device),
        }

    @torch.no_grad()
    def prefill(self, batch):
        """``batch["tokens"]`` (B, S) -> (last logits (B, V) fp32, cache)."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, layers = self._cast()
        x = embed_lookup(params["embed"], batch["tokens"], cd)

        def layer(i, x):
            p = self._view(layers[i])
            h, c = ssm_apply(_norm(x, p["norm"], cfg), p["ssm"], cfg.ssm, cd)
            return x + h, c

        x, caches = scan(layer, x, len(layers))
        x = _norm(x, params["final_norm"], cfg)
        cache = {k: torch.stack([c[k] for c in caches]) for k in ("ssm", "conv")}
        return self._logits_f32(x[:, -1], params["embed"]["table"]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) ints.  Writes ``cache`` in place; returns
        (logits (B, V) fp32, cache).  ``pos`` is unused (no positions)."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, layers = self._cast()
        x = embed_lookup(params["embed"], tokens, cd)[:, 0]    # (B, d)

        def layer(i, x):
            p = self._view(layers[i])
            h, c = ssm_decode_step(_norm(x, p["norm"], cfg), _at(cache, i),
                                   p["ssm"], cfg.ssm, cd)
            cache["ssm"][i], cache["conv"][i] = c["ssm"], c["conv"]
            return x + h, None

        x, _ = scan(layer, x, len(layers))
        x = _norm(x, params["final_norm"], cfg)
        # the product in the compute dtype, widened after (as the reference)
        logits = (x @ params["embed"]["table"].T).float()
        return logits[:, :cfg.vocab_size], cache


_FAMILIES = {
    "dense": DecoderModel,
    "moe": DecoderModel,
    "ssm": SSMModel,
    "hybrid": HybridModel,
    "encdec": EncDecModel,
}


def build_model(cfg: ModelConfig, constrain: Constrain = _noop, *,
                device=None, seed: int = 0):
    """The model of ``cfg.family`` with parameters drawn on ``device``
    (``None`` = the GPU) from generator seed ``seed``."""
    if cfg.family not in _FAMILIES:
        raise KeyError(f"unknown model family {cfg.family!r}")
    return _FAMILIES[cfg.family](cfg, constrain, device=device, seed=seed)
