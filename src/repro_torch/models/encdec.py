"""Encoder-decoder transformer (whisper family; port of
``repro.models.encdec``).

The audio frontend (log-mel + conv downsampling) is a stub, as in the
reference: the batch carries precomputed frame embeddings (B, S_enc, d).
Encoder: bidirectional self-attention + sinusoidal positions.
Decoder: causal self-attention (KV cache for decode), cross-attention to the
encoder output (cross K/V computed once at prefill), learned positions.

Decode clamps where ``lax.dynamic_update_slice_in_dim`` and
``lax.dynamic_slice_in_dim`` clamp in the reference, explicitly: the
self-attention cache slot at ``max_len - 1`` (``transformer.cache_slot``,
which also lets the attention see every slot once ``pos + 1 > max_len``)
and the learned position at ``pos_table_len - 1`` (``layers.dslice``).
"""
from __future__ import annotations

import torch

from ..launch.cost import scan
from .attention import decode_attention
from .flash import flash_attention
from .layers import (dslice, embed_init, embed_lookup, mlp, mlp_init,
                     sinusoidal_positions)
from .sharded import local_heads, whole, write_slot
from .transformer import (LMModule, _dt, _norm, _norm_init, _qkv, _remat,
                          _unstack, _wo, attn_init, cache_slot)


def _cross_kv(enc, p, cfg, cd, constrain):
    def w(n):
        return whole(p[n].to(cd), -1)
    k = torch.einsum("bsd,dhk->bshk", enc, w("wk"))
    v = torch.einsum("bsd,dhk->bshk", enc, w("wv"))
    if cfg.qkv_bias:
        k, v = k + w("bk"), v + w("bv")
    return constrain(k, "kv_heads"), constrain(v, "kv_heads")


def _cross_q(x, p, cfg, cd):
    q = torch.einsum("bsd,dhk->bshk", x, whole(p["wq"].to(cd), -1))
    return q + p["bq"].to(cd) if cfg.qkv_bias else q


def _flash(q, k, v, causal, cfg):
    """Flash attention, under DTensor on each rank's rows and heads."""
    return local_heads(
        lambda q, k, v: flash_attention(q, k, v, causal, None, None,
                                        cfg.q_block, cfg.k_block, 0),
        q, k, v)


def _cross_apply(x, kc, vc, p, cfg, cd, constrain):
    out = _flash(_cross_q(x, p, cfg, cd), kc, vc, False, cfg)
    return torch.einsum("bshk,hkd->bsd", out, _wo(p, cd))


def _cross_decode(x, kc, vc, p, cfg, cd):
    n = kc.shape[1]
    out = local_heads(lambda q, k, v: decode_attention(q, k, v, n),
                      _cross_q(x, p, cfg, cd), kc, vc)
    return torch.einsum("bshk,hkd->bsd", out, _wo(p, cd))


class EncDecModel(LMModule):
    """``params["enc_layers"]`` and ``params["dec_layers"]`` are stacked on
    ``(encoder_layers,)`` and ``(n_layers,)``; a decoder layer adds
    ``ln_x`` and ``xattn`` (cross-attention) to a transformer layer.

    The cache is ``{"k", "v" (n_layers, B, max_len, KH, hd), "xk", "xv"
    (n_layers, B, S_enc, KH, hd)}``.
    """

    STACKED = ("enc_layers", "dec_layers")

    def _init_tree(self, gen: torch.Generator) -> dict:
        cfg = self.cfg
        pd = _dt(cfg.param_dtype)
        dev = gen.device

        def layer(lead, cross):
            p = {"ln1": _norm_init(cfg, pd, dev, lead),
                 "attn": attn_init(gen, cfg, pd, lead=lead)}
            if cross:
                p["ln_x"] = _norm_init(cfg, pd, dev, lead)
                p["xattn"] = attn_init(gen, cfg, pd, lead=lead)
            p["ln2"] = _norm_init(cfg, pd, dev, lead)
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, pd,
                                gated=cfg.gated_mlp, bias=True, lead=lead)
            return p

        pos = torch.randn((cfg.pos_table_len, cfg.d_model), generator=gen,
                          device=dev)
        return {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
            "pos_table": (pos * 0.01).to(pd),
            "enc_layers": layer((cfg.encoder_layers,), cross=False),
            "enc_norm": _norm_init(cfg, pd, dev),
            "dec_layers": layer((cfg.n_layers,), cross=True),
            "final_norm": _norm_init(cfg, pd, dev),
        }

    def _layer_views(self, tree):
        """``(encoder layers, decoder layers)``."""
        return (_unstack(tree["enc_layers"], (self.cfg.encoder_layers,)),
                _unstack(tree["dec_layers"], (self.cfg.n_layers,)))

    # ---- encoder ----
    def _encode(self, params, enc_layers, enc_embeddings, remat="none"):
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        x = enc_embeddings.to(cd)
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model, cd,
                                     x.device)[None]
        x = self.constrain(x, "act")

        def body(x, p):
            p = self._view(p)
            h = _norm(x, p["ln1"], cfg)
            q, k, v = _qkv(h, p["attn"], cfg, cd, self.constrain, None)
            h = _flash(q, k, v, False, cfg)
            h = torch.einsum("bshk,hkd->bsd", h, _wo(p["attn"], cd))
            x = self.constrain(x + h, "act")
            h = mlp(_norm(x, p["ln2"], cfg), p["mlp"], cfg.act, cd,
                    constrain=lambda t: self.constrain(t, "act_ff"))
            return self.constrain(x + h, "act")

        body = _remat(body, remat)
        x, _ = scan(lambda i, x: (body(x, enc_layers[i]), None), x,
                    len(enc_layers), xs=enc_layers)
        return _norm(x, params["enc_norm"], cfg)

    @torch.no_grad()
    def encode(self, enc_embeddings):
        """The encoder's output (B, S_enc, d) of frame embeddings."""
        params, (enc_layers, _) = self._cast()
        return self._encode(params, enc_layers, enc_embeddings)

    # ---- decoder trunk (train) ----
    def _dec_embed(self, params, tokens, cd, pos0=0):
        """Token embeddings plus the learned positions ``pos0`` onward."""
        x = embed_lookup(params["embed"], tokens, cd)
        S = tokens.shape[1]
        return x + params["pos_table"].to(cd)[pos0:pos0 + S][None]

    def loss(self, batch):
        """batch: enc_embeddings (B,S_enc,d), tokens (B,S), labels (B,S).
        Returns (loss, {"nll"}), differentiable in the module's
        parameters."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, (enc_layers, dec_layers) = self._live()
        enc = self._encode(params, enc_layers, batch["enc_embeddings"],
                           cfg.remat)
        x = self.constrain(self._dec_embed(params, batch["tokens"], cd), "act")

        def body(x, p):
            p = self._view(p)
            h = _norm(x, p["ln1"], cfg)
            q, k, v = _qkv(h, p["attn"], cfg, cd, self.constrain, None)
            h = _flash(q, k, v, True, cfg)
            h = torch.einsum("bshk,hkd->bsd", h, _wo(p["attn"], cd))
            x = self.constrain(x + h, "act")
            kc, vc = _cross_kv(enc, p["xattn"], cfg, cd, self.constrain)
            h = _cross_apply(_norm(x, p["ln_x"], cfg), kc, vc, p["xattn"],
                             cfg, cd, self.constrain)
            x = self.constrain(x + h, "act")
            h = mlp(_norm(x, p["ln2"], cfg), p["mlp"], cfg.act, cd,
                    constrain=lambda t: self.constrain(t, "act_ff"))
            return self.constrain(x + h, "act")

        body = _remat(body, cfg.remat)
        x, _ = scan(lambda i, x: (body(x, dec_layers[i]), None), x,
                    len(dec_layers), xs=dec_layers)
        x = _norm(x, params["final_norm"], cfg)
        loss = self._ce(x, params["embed"]["table"], batch)
        return loss, {"nll": loss}

    # ---- serve ----
    def init_cache(self, batch_size: int, max_len: int, enc_len: int):
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)

        def kv(s):
            return torch.zeros((cfg.n_layers, batch_size, s, cfg.n_kv_heads,
                                cfg.head_dim), dtype=cd, device=self.device)
        return {"k": kv(max_len), "v": kv(max_len),
                "xk": kv(enc_len), "xv": kv(enc_len)}

    @torch.no_grad()
    def prefill(self, batch, max_decode_len: int = 256):
        """Encode ``batch["enc_embeddings"]`` and seed the cross K/V; the
        decoder starts empty (autoregressive from BOS), so the logits are
        zeros."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, (enc_layers, dec_layers) = self._cast()
        enc = self._encode(params, enc_layers, batch["enc_embeddings"])
        B = enc.shape[0]
        cache = self.init_cache(B, max_decode_len, 0)
        _, cross = scan(lambda i, _: (None, _cross_kv(
            enc, self._view(dec_layers[i]["xattn"]), cfg, cd,
            self.constrain)), None, len(dec_layers))
        cache["xk"] = torch.stack([kv[0] for kv in cross])
        cache["xv"] = torch.stack([kv[1] for kv in cross])
        logits = torch.zeros((B, cfg.vocab_size), device=enc.device)
        return logits, cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) ints; pos: this token's position.  Writes the
        self-attention cache in place; returns (logits (B, V) fp32, cache)."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, (_, dec_layers) = self._cast()
        pos = int(pos)
        x = embed_lookup(params["embed"], tokens, cd)
        x = x + dslice(params["pos_table"], pos, 1, 0)[None]
        x = self.constrain(x, "act")
        slot, eff_pos, _ = cache_slot(pos, cache["k"].shape[2], None)

        def layer(i, x):
            p = self._view(dec_layers[i])
            ck, cv = cache["k"][i], cache["v"][i]
            h = _norm(x, p["ln1"], cfg)
            q, k, v = _qkv(h, p["attn"], cfg, cd, self.constrain, None)
            write_slot(ck, slot, k[:, 0])
            write_slot(cv, slot, v[:, 0])
            h = local_heads(lambda q, k, v: decode_attention(q, k, v, eff_pos),
                            q, ck, cv)
            h = torch.einsum("bshk,hkd->bsd", h, _wo(p["attn"], cd))
            x = x + h
            h = _cross_decode(_norm(x, p["ln_x"], cfg), cache["xk"][i],
                              cache["xv"][i], p["xattn"], cfg, cd)
            x = x + h
            h = mlp(_norm(x, p["ln2"], cfg), p["mlp"], cfg.act, cd)
            return x + h, None

        x, _ = scan(layer, x, len(dec_layers))
        x = _norm(x, params["final_norm"], cfg)
        return self._logits_f32(x[:, 0], params["embed"]["table"]), cache
