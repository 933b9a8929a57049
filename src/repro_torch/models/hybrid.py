"""Hybrid SSM + shared-attention model (zamba2 family; port of
``repro.models.hybrid``).

Backbone: a stack of Mamba2 blocks.  After every ``hybrid_period`` SSM layers
a *shared* transformer block (one weight set reused at every application, as
in Zamba/Zamba2) runs on ``proj([hidden ; original_embedding])`` — the concat
re-injects the token embedding at depth, per the Zamba design; the block's
delta (its attention+FFN contribution) is added back to the residual stream.
The released model's per-application LoRA deltas are simplified away, as in
the reference.
"""
from __future__ import annotations

import torch

from ..launch.cost import scan
from .layers import dense_init, embed_init, embed_lookup
from .sharded import write_at
from .ssm import ssm_apply, ssm_decode_step, ssm_init
from .transformer import (LMModule, _at, _dt, _layer_prefill, _norm,
                          _norm_init, _remat, _rope, _unstack, layer_decode,
                          layer_init)


class HybridModel(LMModule):
    """``params["ssm_layers"]`` is stacked on ``(n_shared, hybrid_period)``;
    ``params["shared"]`` is one (unstacked) transformer layer, applied once
    a group on ``params["shared_in"]``'s projection of ``[x ; emb0]``.

    The cache is ``{"ssm": {"ssm", "conv"} (n_shared, hybrid_period, B,
    ...), "k", "v" (n_shared, B, S, KH, hd)}``.
    """

    STACKED = ("ssm_layers",)

    @property
    def n_shared(self) -> int:
        return self.cfg.n_layers // self.cfg.hybrid_period

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        pd = _dt(cfg.param_dtype)
        lead = (self.n_shared, cfg.hybrid_period)
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
            "ssm_layers": {"norm": _norm_init(cfg, pd, gen.device, lead),
                           "ssm": ssm_init(gen, cfg.ssm, pd, lead)},
            "shared": layer_init(gen, cfg, pd),               # one weight set
            "shared_in": dense_init(gen, 2 * cfg.d_model, (cfg.d_model,), pd),
            "final_norm": _norm_init(cfg, pd, gen.device),
        }

    def _layer_views(self, tree):
        """Per group: its ``hybrid_period`` SSM layers' parameters."""
        R = self.cfg.hybrid_period
        layers = _unstack(tree["ssm_layers"], (self.n_shared, R))
        return [layers[g * R:(g + 1) * R] for g in range(self.n_shared)]

    def init_cache(self, batch_size: int, max_len: int):
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        s = cfg.ssm
        G, R, B = self.n_shared, cfg.hybrid_period, batch_size
        dev = self.device
        kv = (G, B, max_len, cfg.n_kv_heads, cfg.head_dim)
        return {
            "ssm": {
                "ssm": torch.zeros((G, R, B, s.n_heads, s.head_dim, s.d_state),
                                   device=dev),
                "conv": torch.zeros((G, R, B, s.d_conv - 1, s.conv_dim),
                                    dtype=cd, device=dev),
            },
            "k": torch.zeros(kv, dtype=cd, device=dev),
            "v": torch.zeros(kv, dtype=cd, device=dev),
        }

    def _shared_in(self, params, x, emb0):
        # placed as the activations are: on the 512-rank mesh the shared
        # block's gradient otherwise reaches this product sequence-sharded,
        # flattened into a strided shard that DTensor cannot multiply
        return self.constrain(torch.cat([x, emb0], dim=-1)
                              @ params["shared_in"], "act")

    # ---- train ----
    def loss(self, batch):
        """``batch["tokens"]``, ``batch["labels"]`` (B, S) -> (loss,
        {"nll"}), differentiable in the module's parameters."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, groups = self._live()
        x = self.constrain(embed_lookup(params["embed"], batch["tokens"], cd),
                           "act")
        emb0 = x
        rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None, :])

        def group_body(x, group):
            for pj in map(self._view, group):
                h, _ = ssm_apply(_norm(x, pj["norm"], cfg), pj["ssm"], cfg.ssm,
                                 cd)
                x = self.constrain(x + h, "act")
            xin = self._shared_in(params, x, emb0)
            out, _, _, _ = _layer_prefill(xin, params["shared"], cfg,
                                          kind="full", constrain=self.constrain,
                                          rope=rope)
            return self.constrain(x + (out - xin), "act")

        body = _remat(group_body, cfg.remat)
        x, _ = scan(lambda g, x: (body(x, groups[g]), None), x, len(groups),
                    xs=groups)
        x = _norm(x, params["final_norm"], cfg)
        loss = self._ce(x, params["embed"]["table"], batch)
        return loss, {"nll": loss}

    @torch.no_grad()
    def prefill(self, batch):
        """``batch["tokens"]`` (B, S) -> (last logits (B, V) fp32, cache);
        the cache's K/V are S long."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, groups = self._cast()
        x = embed_lookup(params["embed"], batch["tokens"], cd)
        emb0 = x
        S = x.shape[1]
        rope = _rope(cfg, torch.arange(S, device=x.device)[None, :])

        def block(g, x):
            group = groups[g]

            def member(j, x):
                pj = self._view(group[j])
                h, c = ssm_apply(_norm(x, pj["norm"], cfg), pj["ssm"], cfg.ssm,
                                 cd)
                return x + h, c

            x, caches = scan(member, x, len(group))
            xin = self._shared_in(params, x, emb0)
            out, _, k, v = _layer_prefill(xin, params["shared"], cfg,
                                          kind="full", constrain=self.constrain,
                                          rope=rope)
            return x + (out - xin), (caches, k, v)

        x, blocks = scan(block, x, len(groups))
        ssm_caches = [c for caches, _, _ in blocks for c in caches]
        ks = [k for _, k, _ in blocks]
        vs = [v for _, _, v in blocks]
        x = _norm(x, params["final_norm"], cfg)
        lead = (self.n_shared, cfg.hybrid_period)
        cache = {
            "ssm": {n: torch.stack([c[n] for c in ssm_caches]).reshape(
                *lead, *ssm_caches[0][n].shape) for n in ("ssm", "conv")},
            "k": torch.stack(ks), "v": torch.stack(vs)}
        return self._logits_f32(x[:, -1], params["embed"]["table"]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) ints; pos: this token's position.  Writes ``cache``
        in place (the K/V slot clamped as ``transformer.cache_slot`` says);
        returns (logits (B, V) fp32, cache)."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, groups = self._cast()
        pos = int(pos)
        x = embed_lookup(params["embed"], tokens, cd)       # (B,1,d)
        emb0 = x                                            # this token's
        rope = _rope(cfg, torch.full((1, 1), pos, device=x.device))
        ssm_cache = cache["ssm"]

        def block(g, x):
            # the members run in full: the reference's rule may shard the
            # conv cache's member axis, so which rank writes depends on j
            for j, pj in enumerate(map(self._view, groups[g])):
                h, c = ssm_decode_step(_norm(x, pj["norm"], cfg)[:, 0],
                                       _at(ssm_cache, g, j), pj["ssm"],
                                       cfg.ssm, cd)
                write_at(ssm_cache["ssm"], (g, j), c["ssm"])
                write_at(ssm_cache["conv"], (g, j), c["conv"])
                x = x + h[:, None, :]
            xin = self._shared_in(params, x, emb0)
            out, _, _ = layer_decode(xin, params["shared"], cfg, cache["k"][g],
                                     cache["v"][g], pos, kind="full",
                                     constrain=self.constrain, rope=rope)
            return x + (out - xin), None

        x, _ = scan(block, x, len(groups))
        x = _norm(x, params["final_norm"], cfg)
        return self._logits_f32(x[:, 0], params["embed"]["table"]), cache
