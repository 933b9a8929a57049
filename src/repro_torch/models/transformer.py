"""Decoder-only transformer: init / prefill / decode (port of
``repro.models.transformer``, the serving half).

``DecoderModel`` is an ``nn.Module`` that owns its parameters; its base
``LMModule``, shared by every model class of the port, holds them and
their compute-dtype copy.  They keep the reference's tree and layouts
(``wq (d,H,hd)``, ``wo (H,hd,d)``, layers stacked on a leading
``(n_groups, group_size)`` axis), so carrying JAX's weights across is a
copy (``bridge.lm_params_from_numpy``) and the einsums
use the reference's subscripts.  Heterogeneous layer patterns (gemma-2
local/global alternation) are the static ``layer_group`` tuple: the loop
runs over groups and unrolls each group's members with their kinds.

The reference casts every fp32 matrix to the compute dtype inside every
call; the module makes that cast once per parameter set and device and
keeps the compute-dtype copy (same bits).  Sharding is injected via a
``constrain(x, kind)`` hook: a no-op on one device; under a
``Parallelism`` the parameters and activations are DTensors, ``constrain``
redistributes them by role (``distributed/sharding.py``) and
``models/sharded.py`` holds the ops DTensor cannot place alone.

Training (``loss``) casts inside autograd on every call instead
(``LMModule._live``), so the gradients reach the module's own fp32
parameters; the per-layer body runs under ``_remat``'s policy and the
cross-entropy in ``chunked_ce``'s slices.
"""
from __future__ import annotations

import functools
import math
from typing import TYPE_CHECKING, Callable

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from ..launch.cost import scan
from ..tree import tree_leaves_with_path
from .attention import (blockwise_attention, decode_attention,
                        packed_causal_attention, swa_attention)
from .flash import flash_attention
from .layers import (einsum_f32, embed_init, embed_lookup, layernorm,
                     layernorm_init, mlp, mlp_init, rmsnorm, rmsnorm_init,
                     rope_angles, rope_rotate, _he)
from .moe import moe_apply, moe_init
from .sharded import is_dt, local_heads, local_rows, whole, write_slot

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
    """q, k, v of ``x``; ``rope`` is ``layers.rope_angles``' (cos, sin).

    The decode profile shards a projection over ``head_dim`` when its
    heads do not divide TP; under DTensor that dim is gathered for the
    product (a reshape of a sharded ``head_dim`` has no rule)."""
    def w(n):
        return whole(p[n].to(cd), -1)
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
    """Attention by the config's implementation; under DTensor on each
    rank's own rows and heads (``sharded.local_heads``)."""
    return local_heads(lambda q, k, v: _attend_local(q, k, v, cfg, kind,
                                                     causal), q, k, v)


def _attend_local(q, k, v, cfg: ModelConfig, kind, causal):
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
    return torch.einsum("bshk,hkd->bsd", out, _wo(p, cd)), k, v


def _wo(p, cd):
    """The attention output projection ``(H, hd, d)`` in ``cd``, its
    ``head_dim`` gathered where the decode profile shards it."""
    return whole(p["wo"].to(cd), -2)


def attn_prefill_kv(x, p, cfg: ModelConfig, cd, constrain, positions):
    """K/V for cache seeding (rope pre-applied)."""
    rope = _rope(cfg, positions) if positions is not None else None
    _, k, v = _qkv(x, p, cfg, cd, constrain, rope)
    return k, v


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
    write_slot(cache_k, slot, k[:, 0])
    write_slot(cache_v, slot, v[:, 0])
    out = local_heads(
        lambda q, ck, cv: decode_attention(q, ck, cv, eff_pos,
                                           window=eff_window,
                                           softcap=cfg.attn_softcap),
        q, cache_k, cache_v)
    out = torch.einsum("bshk,hkd->bsd", out, _wo(p, cd))
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
# chunked cross-entropy (never materializes (B, S, V)) and remat
# ---------------------------------------------------------------------------


def _chunk_nll(h_c, t, y_c, V, cap, constrain):
    """``(sum of the nll, valid labels)`` of one ``(B, c)`` slice; label
    ``-1`` is a pad.  Vocab-sharded logits (the reference's ``"logits"``
    role) are gathered over the vocabulary, and the log-sum-exp and the
    label pick run on each rank's rows (``sharded.whole``,
    ``local_rows``)."""
    logits = whole(constrain(einsum_f32("bsd,vd->bsv", h_c, t), "logits"),
                   -1)
    nll = local_rows(lambda lg, y: _row_nll(lg[..., :V], y, cap),
                     (logits, y_c), out_shape=tuple(y_c.shape))
    valid = y_c >= 0
    nll = torch.where(valid, nll, 0.0)
    return torch.sum(nll), torch.sum(valid)


def _row_nll(logits, y, cap):
    """Per token ``logsumexp(logits) - logits[y]`` (soft-capped first)."""
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1,
                          torch.clamp(y, min=0)[..., None].long())[..., 0]
    return lse - picked


def chunked_ce(h, table, labels, cfg: ModelConfig, constrain: Constrain):
    """h: (B,S,d); table: (Vp, d) output embedding; labels (B,S) (-1 = pad).

    Returns (sum_nll, n_valid).  Computed in ``cfg.ce_chunk`` slices, each
    under ``torch.utils.checkpoint``, so the peak logits memory is
    (B, chunk, V) fp32: the backward recomputes a slice's logits.
    """
    B, S, d = h.shape
    c = min(cfg.ce_chunk, S)
    if S % c:
        raise ValueError(f"chunked_ce: S = {S} is no multiple of the chunk "
                         f"{c}")
    t = table.to(h.dtype)

    def chunk(i, carry):
        part = ckpt.checkpoint(_chunk_nll, h[:, i * c:(i + 1) * c], t,
                               labels[:, i * c:(i + 1) * c], cfg.vocab_size,
                               cfg.final_softcap, constrain,
                               use_reentrant=False)
        return (carry[0] + part[0], carry[1] + part[1]), None

    (nll, n), _ = scan(chunk, (torch.zeros((), device=h.device),
                               torch.zeros((), dtype=torch.int64,
                                           device=h.device)), S // c)
    return nll, n


def _unbatched_product(op, args) -> bool:
    """An ``aten`` product without batch dimensions: ``mm``/``addmm``, or
    the ``bmm`` of batch 1 that ``torch.einsum`` lowers such a contraction
    to."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default):
        return True
    return op is aten.bmm.default and args[0].shape[0] == 1


def _dots_policy(ctx, op, *args, **kwargs):
    """Save what JAX's ``checkpoint_dots_with_no_batch_dims`` saves (the
    products without batch dimensions); recompute the rest."""
    if _unbatched_product(op, args):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` under the config's remat policy: ``none`` keeps every
    activation, ``full`` recomputes the body in the backward (keeping its
    inputs), ``dots`` keeps the unbatched products' outputs only."""
    if policy == "none":
        return fn
    if policy == "full":
        return functools.partial(ckpt.checkpoint, fn, use_reentrant=False)
    if policy == "dots":
        return functools.partial(
            ckpt.checkpoint, fn, use_reentrant=False,
            context_fn=functools.partial(
                ckpt.create_selective_checkpoint_contexts, _dots_policy))
    raise ValueError(policy)


# ---------------------------------------------------------------------------
# parameter trees as modules
# ---------------------------------------------------------------------------


class ParamTree(nn.Module):
    """A nested dict of tensors as a module, under the tree's keys: a dict
    is a submodule, a tensor a (trainable) parameter; ``tree[key]`` reads
    either."""

    def __init__(self, tree: dict):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def __getitem__(self, key: str):
        return getattr(self, key)

    def as_dict(self, fn) -> dict:
        """The tree as nested dicts, ``fn`` applied to every leaf."""
        out = {k: fn(t) for k, t in self._parameters.items()}
        out.update((k, m.as_dict(fn)) for k, m in self._modules.items())
        return out


def _at(tree: dict, *idx) -> dict:
    """Every leaf of a nested dict indexed at ``idx`` (one layer of a
    stacked tree, as views)."""
    return {k: _at(v, *idx) if isinstance(v, dict) else v[idx]
            for k, v in tree.items()}


def _stack_whole(v, n_lead: int):
    """A stacked leaf with its ``n_lead`` layer axes unsharded.  Only a
    DTensor can be sharded there: the reference's rule for a 3-D ``wo``
    (heads, head_dim, d) also takes a stacked 2-D MLP ``wo`` (layers, f,
    d) and shards its layer axis over TP; the layers are gathered before
    they are split apart (``unbind`` has no rule for a sharded dim)."""
    for d in range(n_lead):
        v = whole(v, d)
    return v


def _unstack(tree: dict, lead: tuple) -> list:
    """The layers of a tree stacked on the ``lead`` axes, row-major, as
    views: one ``unbind`` a leaf, whose gradient is one ``stack`` (where
    indexing layer by layer would build a full-size zero tensor per layer
    in the backward)."""
    n = math.prod(lead)
    parts = {k: _unstack(v, lead) if isinstance(v, dict) else
             _stack_whole(v, len(lead)).reshape(
                 n, *v.shape[len(lead):]).unbind(0)
             for k, v in tree.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


class LMModule(nn.Module):
    """A language model that owns its parameters.

    ``Model(cfg, device=None, seed=0)`` draws the parameter tree of
    ``_init_tree`` on ``device`` (``None`` = the GPU) from a
    ``torch.Generator`` seeded with ``seed``; ``bridge.lm_params_from_numpy``
    loads JAX's instead.  ``params`` holds the reference's tree, layers
    stacked on leading axes.  The compute reads ``_cast()``: the tree in
    the compute dtype, made once, with ``_layer_views``' per-layer views
    of it.
    """

    def __init__(self, cfg: ModelConfig, constrain: Constrain = _noop, *,
                 device=None, seed: int = 0):
        super().__init__()
        self.cfg = cfg
        self.constrain = constrain
        dev = resolve_device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.params = ParamTree(self._init_tree(gen))
        self._compute = None        # (key, tree, layer views): see _cast

    def _init_tree(self, gen: torch.Generator) -> dict:
        """A fresh parameter tree (nested dicts) from ``gen``, on its
        device: the reference's distributions, not its bits."""
        raise NotImplementedError

    def _layer_views(self, tree: dict):
        """The compute tree's layers, as the forward passes walk them."""
        raise NotImplementedError

    @property
    def device(self) -> torch.device:
        return self.params["embed"]["table"].device

    def compute_params(self) -> dict:
        """The parameter tree as the compute reads it: fp32 leaves of more
        than one axis (of the stacked tree) in the compute dtype, the rest
        as they are (the reference's cast)."""
        return self._cast()[0]

    def _cast(self):
        """``(compute tree, layer views)`` for serving: detached, made once
        and kept; made again when a parameter has moved or was written in
        place (its storage or version counter changed), as an optimizer
        step writes it."""
        leaves = list(self.params.parameters())
        key = tuple((id(t._local_tensor) if is_dt(t) else t.data_ptr(),
                     t._version, t.dtype) for t in leaves)
        if self._compute is None or self._compute[0] != key:
            self._compute = None        # free the old copy before the new
            tree = self._top_view(
                self.params.as_dict(self._cast_leaf(detach=True)))
            self._compute = (key, tree, self._layer_views(tree))
        return self._compute[1:]

    def _live(self):
        """``(compute tree, layer views)`` for training: ``_cast``'s rule,
        applied inside autograd on every call, so the gradients flow back
        to the fp32 parameters.  Nothing is kept."""
        tree = self._top_view(
            self.params.as_dict(self._cast_leaf(detach=False)))
        return tree, self._layer_views(tree)

    #: top-level keys of the parameter tree that hold layers stacked on
    #: leading axes: gathered a layer at a time (``_view``)
    STACKED = ("layers",)

    def _view(self, tree):
        """A parameter (sub)tree as the compute reads it: under a
        ``Parallelism`` each leaf gathered over the FSDP axis
        (``constrain``'s ``"param"`` role), ZeRO-3's gather on use; on one
        device the tree itself.  The model views each layer's parameters
        inside its (rematerialized) body, so one layer's are gathered at a
        time."""
        if isinstance(tree, dict):
            return {k: self._view(v) for k, v in tree.items()}
        return self.constrain(tree, "param")

    def _top_view(self, tree):
        """``_view`` of every top-level subtree but the stacked layers."""
        return {k: v if k in self.STACKED else self._view(v)
                for k, v in tree.items()}

    def _cast_leaf(self, *, detach: bool):
        """The reference's cast: fp32 leaves of more than one axis (of the
        stacked tree) to the compute dtype, the rest as they are."""
        cd = _dt(self.cfg.compute_dtype)

        def cast(a):
            a = a.detach() if detach else a
            return a.to(cd) if a.dtype == torch.float32 and a.ndim > 1 else a
        return cast

    def _ce(self, h, table, batch):
        """Mean next-token loss of the final hidden states ``h``."""
        nll, n = chunked_ce(h, table, batch["labels"], self.cfg,
                            self.constrain)
        return nll / torch.clamp(n, min=1)

    def trainable_leaves(self) -> dict:
        """``{keystr path: parameter}`` in the reference's leaf order (the
        sorted key paths of ``jax.tree_util``), e.g. ``"['layers']['attn']
        ['wq']"``: what the optimizer and the checkpoint key on."""
        return dict(tree_leaves_with_path(self.params.as_dict(lambda t: t)))

    def _logits_f32(self, x, table):
        """fp32 logits of ``x (B, d)`` against ``table``, the product in
        fp32 (the reference's ``preferred_element_type``); vocab-sharded
        ones gathered before the slice to the vocabulary."""
        return whole(einsum_f32("bd,vd->bv", x, table),
                     -1)[:, :self.cfg.vocab_size]


# ---------------------------------------------------------------------------
# decoder-only model
# ---------------------------------------------------------------------------


class DecoderModel(LMModule):
    """Decoder-only LM (dense / SWA / MoE families).

    ``params["layers"]["attn"]["wq"]`` is ``(n_groups, group_size, d, H,
    hd)``.
    """

    # ---- init ----
    def _init_tree(self, gen: torch.Generator) -> dict:
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

    def _layer_views(self, tree):
        """Per layer (group g, member j): (kind, g, j, params of the layer)."""
        cfg = self.cfg
        layers = _unstack(tree["layers"], (cfg.n_groups, cfg.group_size))
        return [(kind, g, j, layers[g * cfg.group_size + j])
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
        logits = self._logits_f32(x, self._out_table(params))
        if cfg.final_softcap is not None:
            logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
        return logits

    # ---- train ----
    def loss(self, batch):
        """batch: tokens/embeddings + labels (-1 ignored), on the model's
        device.  Returns (loss, metrics), differentiable in the module's
        parameters: nll + 0.01·lb + 0.001·z, the MoE aux losses summed
        over the layers and divided by ``n_layers``."""
        cfg = self.cfg
        cd = _dt(cfg.compute_dtype)
        params, layers = self._live()
        x = self.constrain(self._embed_in(params, batch, cd), "act")
        rope = _rope(cfg, torch.arange(x.shape[1], device=x.device)[None, :])

        def group_body(x, group):
            aux_sum = torch.zeros((2,), device=x.device)
            for kind, pj in group:
                x, aux, _, _ = _layer_prefill(x, self._view(pj), cfg,
                                              kind=kind,
                                              constrain=self.constrain,
                                              rope=rope)
                aux_sum = aux_sum + torch.stack([aux["lb_loss"],
                                                 aux["z_loss"]])
            return x, aux_sum

        body = _remat(group_body, cfg.remat)
        groups = [[(kind, pj) for kind, gg, _, pj in layers if gg == g]
                  for g in range(cfg.n_groups)]
        x, auxes = scan(lambda g, x: body(x, groups[g]), x, cfg.n_groups,
                        xs=groups)
        aux = torch.sum(torch.stack(auxes), dim=0)
        x = _norm(x, params["final_norm"], cfg)
        loss = self._ce(x, self._out_table(params), batch)
        lb, z = aux[0] / cfg.n_layers, aux[1] / cfg.n_layers
        total = loss + 0.01 * lb + 0.001 * z
        return total, {"nll": loss, "lb_loss": lb, "z_loss": z}

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

        def layer(i, x):
            kind, _, j, pj = layers[i]
            x, _, k, v = _layer_prefill(x, self._view(pj), cfg, kind=kind,
                                        constrain=self.constrain,
                                        rope=rope)
            return x, (k[:, S - spans[j]:], v[:, S - spans[j]:])

        x, kvs = scan(layer, x, len(layers), key=lambda i: layers[i][0])
        for (_, _, j, _), (k, v) in zip(layers, kvs):
            slabs[f"k{j}"].append(k)
            slabs[f"v{j}"].append(v)
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

        def layer(i, x):
            kind, g, j, pj = layers[i]
            x, _, _ = layer_decode(x, self._view(pj), cfg, cache[f"k{j}"][g],
                                   cache[f"v{j}"][g], pos, kind=kind,
                                   constrain=self.constrain, rope=rope)
            return x, None

        x, _ = scan(layer, x, len(layers), key=lambda i: layers[i][0])
        x = _norm(x, params["final_norm"], cfg)
        return self._logits(params, x[:, 0]), cache
