"""Decoder-only transformer: init / prefill / decode (port of
``repro.models.transformer``, the serving half).

``DecoderModel`` is an ``nn.Module`` that owns its parameters.  They keep
the reference's tree and layouts (``wq (d,H,hd)``, ``wo (H,hd,d)``, layers
stacked on a leading ``(n_groups, group_size)`` axis), so carrying JAX's
weights across is a copy (``bridge.lm_params_from_numpy``) and the einsums
use the reference's subscripts.  Heterogeneous layer patterns (gemma-2
local/global alternation) are the static ``layer_group`` tuple: the loop
runs over groups and unrolls each group's members with their kinds.

The reference casts every fp32 matrix to the compute dtype inside every
call; the module makes that cast once per parameter set and device and
keeps the compute-dtype copy (same bits).  Sharding is injected via a
``constrain(x, kind)`` hook, a no-op here, so model code stays
mesh-agnostic.  ``loss`` and its chunked cross-entropy come with the
training slice (ROADMAP, queue A, A13c).
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, Callable

import torch
from torch import nn

from ..device import resolve_device
from .attention import (blockwise_attention, decode_attention,
                        packed_causal_attention, swa_attention)
from .flash import flash_attention
from .layers import (einsum_f32, embed_init, embed_lookup, layernorm,
                     layernorm_init, mlp, mlp_init, rmsnorm, rmsnorm_init,
                     rope_angles, rope_rotate, _he)
from .moe import moe_apply, moe_init

if TYPE_CHECKING:  # hints only
    from ..configs.base import ModelConfig

Constrain = Callable[[torch.Tensor, str], torch.Tensor]


def _noop(x, kind):
    return x


def _dt(name: str):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def _norm_init(cfg: ModelConfig, dtype, device, lead=()):
    return (rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init)(
        cfg.d_model, dtype, device, lead)


def _norm(x, p, cfg: ModelConfig):
    fn = rmsnorm if cfg.norm == "rmsnorm" else layernorm
    return fn(x, p, cfg.norm_eps)


# ---------------------------------------------------------------------------
# attention sub-block
# ---------------------------------------------------------------------------


def attn_init(gen, cfg: ModelConfig, dtype, d_model=None, lead=()):
    d = d_model or cfg.d_model
    H, KH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {
        "wq": _he(gen, (d, H, hd), dtype, lead=lead),
        "wk": _he(gen, (d, KH, hd), dtype, lead=lead),
        "wv": _he(gen, (d, KH, hd), dtype, lead=lead),
        "wo": _he(gen, (H, hd, d), dtype, 1.0 / math.sqrt(H * hd), lead),
    }
    if cfg.qkv_bias:
        for n, heads in (("bq", H), ("bk", KH), ("bv", KH)):
            p[n] = torch.zeros((*lead, heads, hd), dtype=dtype,
                               device=gen.device)
    return p


def _qkv(x, p, cfg: ModelConfig, cd, constrain, rope=None):
    """q, k, v of ``x``; ``rope`` is ``layers.rope_angles``' (cos, sin)."""
    def w(n):
        return p[n].to(cd)
    q = torch.einsum("bsd,dhk->bshk", x, w("wq"))
    k = torch.einsum("bsd,dhk->bshk", x, w("wk"))
    v = torch.einsum("bsd,dhk->bshk", x, w("wv"))
    if cfg.qkv_bias:
        q, k, v = q + w("bq"), k + w("bk"), v + w("bv")
    if rope is not None:
        q = rope_rotate(q, *rope)
        k = rope_rotate(k, *rope)
    return constrain(q, "heads"), constrain(k, "kv_heads"), constrain(v, "kv_heads")


def _rope(cfg: ModelConfig, positions):
    return rope_angles(positions, cfg.head_dim, cfg.rope_theta) \
        if cfg.rope_theta else None


def _attend(q, k, v, cfg: ModelConfig, kind, causal):
    S = q.shape[1]
    window = cfg.window if kind == "local" else None
    if cfg.attn_impl == "flash":
        return flash_attention(q, k, v, causal, window, cfg.attn_softcap,
                               cfg.q_block, cfg.k_block, 0)
    if not causal:
        return blockwise_attention(q, k, v, causal=False,
                                   softcap=cfg.attn_softcap,
                                   q_block=cfg.q_block, k_block=cfg.k_block)
    if window is not None and S > 2 * window:
        return swa_attention(q, k, v, window=window, softcap=cfg.attn_softcap,
                             q_block=cfg.q_block)
    if cfg.attn_impl == "packed" and window is None:
        return packed_causal_attention(q, k, v, softcap=cfg.attn_softcap,
                                       q_block=cfg.q_block, k_block=cfg.k_block)
    return blockwise_attention(q, k, v, causal=True, window=window,
                               softcap=cfg.attn_softcap,
                               q_block=cfg.q_block, k_block=cfg.k_block)


def _attn_prefill(x, p, cfg: ModelConfig, *, kind, constrain, rope,
                  causal=True):
    """Self-attention for train/prefill: ``(out, k, v)``, k/v rope'd."""
    cd = x.dtype
    x = constrain(x, "attn_in")
    q, k, v = _qkv(x, p, cfg, cd, constrain, rope)
    out = constrain(_attend(q, k, v, cfg, kind, causal), "heads")
    return torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd)), k, v


def attn_apply(x, p, cfg: ModelConfig, *, kind: str, constrain: Constrain,
               positions=None, causal=True):
    """Self-attention for train/prefill.  kind: full | local."""
    if positions is None and cfg.rope_theta:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = _rope(cfg, positions) if positions is not None else None
    return _attn_prefill(x, p, cfg, kind=kind, constrain=constrain, rope=rope,
                         causal=causal)[0]


def cache_slot(pos: int, Sc: int, window) -> tuple[int, int, object]:
    """Where decode at ``pos`` writes its K/V in a cache of ``Sc`` slots,
    and the ``(pos, window)`` its attention reads with.

    A SWA layer whose cache is exactly the window is a ring: slot
    ``pos % window``.  Otherwise the slot is ``pos`` clamped to ``Sc - 1``,
    as ``lax.dynamic_update_slice_in_dim`` clamps its start in the
    reference: past the cache's end every step overwrites the last slot,
    and the attention sees the whole cache as valid (a reference defect
    the port reproduces; ROADMAP, queue C, C6).
    """
    if window is not None and Sc == window:
        return pos % window, min(pos + 1, window), None
    return min(pos, Sc - 1), pos + 1, window


def attn_decode(x, p, cfg: ModelConfig, cache_k, cache_v, pos, *, kind: str,
                constrain: Constrain, rope=None):
    """One-token self-attention.  x: (B,1,d); caches (B,Sc,KH,hd); pos int.

    SWA layers use a ring buffer of width == cache length; full layers insert
    at ``pos`` (clamped, see ``cache_slot``).  The caches are updated in
    place.  Returns (out (B,1,d), cache_k, cache_v).
    """
    cd = x.dtype
    if rope is None and cfg.rope_theta:
        rope = _rope(cfg, torch.full((1, 1), pos, device=x.device))
    q, k, v = _qkv(x, p, cfg, cd, constrain, rope)
    window = cfg.window if kind == "local" else None
    slot, eff_pos, eff_window = cache_slot(pos, cache_k.shape[1], window)
    cache_k[:, slot] = k[:, 0]
    cache_v[:, slot] = v[:, 0]
    out = decode_attention(q, cache_k, cache_v, eff_pos, window=eff_window,
                           softcap=cfg.attn_softcap)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(cd))
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# decoder layer (dense or MoE ffn)
# ---------------------------------------------------------------------------


def layer_init(gen, cfg: ModelConfig, dtype, lead=()):
    dev = gen.device
    p = {
        "ln1": _norm_init(cfg, dtype, dev, lead),
        "attn": attn_init(gen, cfg, dtype, lead=lead),
        "ln2": _norm_init(cfg, dtype, dev, lead),
    }
    if cfg.moe is not None:
        p["moe"] = moe_init(gen, cfg.d_model, cfg.d_ff, cfg.moe, dtype,
                            gated=cfg.gated_mlp, lead=lead)
        if cfg.moe.dense_residual:
            p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                                gated=cfg.gated_mlp, lead=lead)
    else:
        p["mlp"] = mlp_init(gen, cfg.d_model, cfg.d_ff, dtype,
                            gated=cfg.gated_mlp, lead=lead)
    if cfg.post_norms:
        p["ln1_post"] = _norm_init(cfg, dtype, dev, lead)
        p["ln2_post"] = _norm_init(cfg, dtype, dev, lead)
    return p


def _ffn(x, p, cfg: ModelConfig, constrain: Constrain):
    """Dense MLP and/or MoE; returns (y, aux_losses)."""
    zero = torch.zeros((), device=x.device)
    aux = {"lb_loss": zero, "z_loss": zero}
    y = torch.zeros_like(x)
    if cfg.moe is not None:
        ym, aux_m = moe_apply(
            x, p["moe"], cfg.moe, act=cfg.act, compute_dtype=x.dtype,
            constrain_hidden=lambda h: constrain(h, "moe_hidden"),
            constrain_in=lambda h: constrain(h, "moe_in"),
            constrain_out=lambda h: constrain(h, "moe_out"))
        y = y + ym
        aux = {"lb_loss": aux_m["lb_loss"], "z_loss": aux_m["z_loss"]}
        if cfg.moe.dense_residual:
            y = y + mlp(x, p["mlp"], cfg.act, x.dtype,
                        constrain=lambda h: constrain(h, "act_ff"))
    else:
        y = mlp(x, p["mlp"], cfg.act, x.dtype,
                constrain=lambda h: constrain(h, "act_ff"))
    return y, aux


def _layer_prefill(x, p, cfg: ModelConfig, *, kind, constrain, rope):
    """``layer_apply`` that also returns the layer's rope'd k, v."""
    h, k, v = _attn_prefill(_norm(x, p["ln1"], cfg), p["attn"], cfg,
                            kind=kind, constrain=constrain, rope=rope)
    if cfg.post_norms:
        h = _norm(h, p["ln1_post"], cfg)
    x = constrain(x + h, "act")
    h, aux = _ffn(_norm(x, p["ln2"], cfg), p, cfg, constrain)
    if cfg.post_norms:
        h = _norm(h, p["ln2_post"], cfg)
    return constrain(x + h, "act"), aux, k, v


def layer_apply(x, p, cfg: ModelConfig, *, kind: str, constrain: Constrain,
                positions=None):
    if positions is None and cfg.rope_theta:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = _rope(cfg, positions) if positions is not None else None
    x, aux, _, _ = _layer_prefill(x, p, cfg, kind=kind, constrain=constrain,
                                  rope=rope)
    return x, aux


def layer_decode(x, p, cfg: ModelConfig, ck, cv, pos, *, kind: str,
                 constrain: Constrain, rope=None):
    h, ck, cv = attn_decode(_norm(x, p["ln1"], cfg), p["attn"], cfg, ck, cv,
                            pos, kind=kind, constrain=constrain, rope=rope)
    if cfg.post_norms:
        h = _norm(h, p["ln1_post"], cfg)
    x = x + h
    h, _ = _ffn(_norm(x, p["ln2"], cfg), p, cfg, constrain)
    if cfg.post_norms:
        h = _norm(h, p["ln2_post"], cfg)
    return x + h, ck, cv


# ---------------------------------------------------------------------------
# parameter trees as modules
# ---------------------------------------------------------------------------


def _as_module(tree: dict) -> nn.Module:
    """Nested dicts of tensors as nested ``ModuleDict``s whose leaves are
    ``ParameterDict``s, with the tree's keys."""
    if all(isinstance(v, torch.Tensor) for v in tree.values()):
        return nn.ParameterDict(
            {k: nn.Parameter(v, requires_grad=False) for k, v in tree.items()})
    return nn.ModuleDict({k: _as_module(v) for k, v in tree.items()})


def _as_tree(mod: nn.Module, fn) -> dict:
    """The module tree back as nested dicts, ``fn`` applied to every leaf."""
    return {k: _as_tree(v, fn) if isinstance(v, nn.ModuleDict)
            else {n: fn(t) for n, t in v.items()} for k, v in mod.items()}


# ---------------------------------------------------------------------------
# decoder-only model
# ---------------------------------------------------------------------------


class DecoderModel(nn.Module):
    """Decoder-only LM (dense / SWA / MoE families).

    ``DecoderModel(cfg, device=None, seed=0)`` draws its parameters on
    ``device`` (``None`` = the GPU) from a ``torch.Generator`` seeded with
    ``seed``; ``bridge.lm_params_from_numpy`` loads JAX's instead.
    ``params`` holds the reference's tree (``params["layers"]["attn"]
    ["wq"]`` is ``(n_groups, group_size, d, H, hd)``).
    """

    def __init__(self, cfg: ModelConfig, constrain: Constrain = _noop, *,
                 device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.constrain = constrain
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.params = _as_module(self._init_tree(gen))
        self._compute = None        # (key, tree, layer views): see _cast

    # ---- init ----
    def _init_tree(self, gen: torch.Generator) -> dict:
        """A fresh parameter tree (nested dicts) from ``gen``, on its
        device: the reference's distributions, not its bits."""
        cfg = self.cfg
        pd = _dt(cfg.param_dtype)
        lead = (cfg.n_groups, cfg.group_size)
        params = {
            "embed": embed_init(gen, cfg.vocab_size, cfg.d_model, pd),
            "layers": layer_init(gen, cfg, pd, lead),
            "final_norm": _norm_init(cfg, pd, gen.device),
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = embed_init(gen, cfg.vocab_size, cfg.d_model, pd)
        return params

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def compute_params(self) -> dict:
        """The parameter tree as the compute reads it: fp32 leaves of more
        than one axis (of the stacked tree) in the compute dtype, the rest
        as they are (the reference's cast)."""
        return self._cast()[0]

    def _cast(self):
        """``(compute tree, layer views)``: made once and kept; made again
        when a parameter has moved or was written in place (its storage or
        version counter changed)."""
        leaves = list(self.params.parameters())
        key = tuple((t.data_ptr(), t._version, t.dtype) for t in leaves)
        if self._compute is None or self._compute[0] != key:
            cd = _dt(self.cfg.compute_dtype)
            self._compute = None        # free the old copy before the new
            tree = _as_tree(self.params, lambda a: a.detach().to(cd)
                            if a.dtype == torch.float32 and a.ndim > 1
                            else a.detach())
            self._compute = (key, tree, self._layer_views(tree))
        return self._compute[1:]

    def _layer_views(self, tree):
        """Per layer (group g, member j): (kind, g, j, params of the layer)."""
        cfg = self.cfg

        def at(t, g, j):
            return {k: at(v, g, j) if isinstance(v, dict) else v[g, j]
                    for k, v in t.items()}
        return [(kind, g, j, at(tree["layers"], g, j))
                for g in range(cfg.n_groups)
                for j, kind in enumerate(cfg.layer_group)]

    # ---- shared pieces ----
    def _embed_in(self, params, batch, cd):
        cfg = self.cfg
        if cfg.input_mode == "embeddings" and "embeddings" in batch:
            return batch["embeddings"].to(cd)
        return embed_lookup(params["embed"], batch["tokens"], cd,
                            scale_by_sqrt_d=cfg.embed_scale)

    def _out_table(self, params):
        return params["embed" if self.cfg.tie_embeddings else "lm_head"]["table"]

    def _logits(self, params, x):
        """fp32 logits of ``x (B, d)`` over the vocabulary, soft-capped."""
        cfg = self.cfg
        logits = einsum_f32("bd,vd->bv", x, self._out_table(params))
        logits = logits[..., :cfg.vocab_size]
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    # ---- serve ----
    def cache_spec(self, batch_size: int, max_len: int):
        """The empty KV cache (per layer kind: SWA ring or full), on the
        model's device."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        caches = {}
        for j, kind in enumerate(cfg.layer_group):
            span = min(cfg.window, max_len) if kind == "local" and cfg.window \
                else max_len
            caches[f"k{j}"] = torch.zeros(
                (cfg.n_groups, batch_size, span, cfg.n_kv_heads, cfg.head_dim),
                dtype=cd, device=self.device)
            caches[f"v{j}"] = torch.zeros_like(caches[f"k{j}"])
        return caches

    @torch.no_grad()
    def prefill(self, batch):
        """Full-sequence forward + cache seeding.  ``batch`` holds
        ``tokens`` (B, S) or ``embeddings`` (B, S, d) on the model's device.
        Returns (last_logits (B, V) fp32, cache)."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, layers = self._cast()
        x = self._embed_in(params, batch, cd)
        S = x.shape[1]
        rope = _rope(cfg, torch.arange(S, device=x.device)[None, :])
        spans = {j: min(cfg.window, S) if kind == "local" and cfg.window
                 else S for j, kind in enumerate(cfg.layer_group)}
        slabs = {f"{c}{j}": [] for j in spans for c in "kv"}
        for kind, _, j, pj in layers:
            x, _, k, v = _layer_prefill(x, pj, cfg, kind=kind,
                                        constrain=self.constrain, rope=rope)
            slabs[f"k{j}"].append(k[:, S - spans[j]:])
            slabs[f"v{j}"].append(v[:, S - spans[j]:])
        cache = {name: torch.stack(s) for name, s in slabs.items()}
        x = _norm(x, params["final_norm"], cfg)
        return self._logits(params, x[:, -1]), cache

    @torch.no_grad()
    def decode_step(self, cache, tokens, pos: int):
        """tokens: (B, 1) ints; pos: the position of this token.

        Writes this token's K/V into ``cache`` in place.  Returns
        (logits (B, V) fp32, cache).
        """
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, layers = self._cast()
        pos = int(pos)
        x = embed_lookup(params["embed"], tokens, cd,
                         scale_by_sqrt_d=cfg.embed_scale)
        x = self.constrain(x, "act")
        rope = _rope(cfg, torch.full((1, 1), pos, device=x.device))
        for kind, g, j, pj in layers:
            x, _, _ = layer_decode(x, pj, cfg, cache[f"k{j}"][g],
                                   cache[f"v{j}"][g], pos, kind=kind,
                                   constrain=self.constrain, rope=rope)
        x = _norm(x, params["final_norm"], cfg)
        return self._logits(params, x[:, 0]), cache
