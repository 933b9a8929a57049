"""Mixture-of-Experts FFN: top-k routing with per-sequence capacity dispatch
(port of ``repro.models.moe``, forward).

Dispatch/combine are *token-local per batch row* (gather/scatter against an
(E, C) slot table built from a cumulative-position router), so no token
ever crosses a batch row.  The router runs in fp32.  Slot positions come
from a stable argsort and ``searchsorted``, as the reference computes
them; tokens past an expert's capacity land in the overflow column and
are combined from a zero row.

Aux losses: switch-style load-balance loss and router z-loss.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .layers import act_fn, dense_init
from .sharded import experts_local, local_rows


class MoESpec(NamedTuple):
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    dense_residual: bool = False  # arctic: parallel dense FFN branch


def moe_init(gen, d, f, spec: MoESpec, dtype, gated=True, lead=()):
    E = spec.n_experts
    scale = 1.0 / math.sqrt(d)

    def normal(*shape):
        return torch.randn((*lead, *shape), generator=gen, device=gen.device)

    p = {
        "router": dense_init(gen, d, (E,), torch.float32, lead=lead),
        "wi": (normal(E, d, f) * scale).to(dtype),
        "wo": (normal(E, f, d) / math.sqrt(f)).to(dtype),
    }
    if gated:
        p["wg"] = (normal(E, d, f) * scale).to(dtype)
    return p


def capacity(seq_len: int, spec: MoESpec) -> int:
    return max(1, math.ceil(seq_len * spec.top_k * spec.capacity_factor
                            / spec.n_experts))


def top_k(x, k):
    """``lax.top_k`` over the last axis: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(x, params, spec: MoESpec, *, act="silu",
              compute_dtype=torch.bfloat16, constrain_hidden=None,
              constrain_in=None, constrain_out=None):
    """x: (B, S, d) -> (out (B, S, d), aux dict with lb_loss / z_loss).

    Routing and slot assignment are per batch row; tokens beyond an expert's
    capacity are dropped (standard switch behavior, capacity_factor slack).
    Under DTensor the routing, the dispatch and the combine run on each
    rank's own rows (``sharded.local_rows``): they index by computed slots,
    which DTensor has no rule for; the router product, the aux losses and
    the expert FFN are DTensor ops.
    """
    B, S, d = x.shape
    E, k = spec.n_experts, spec.top_k
    C = capacity(S, spec)

    def w(n):
        return params[n].to(compute_dtype)

    logits = x.float() @ params["router"].float()
    probs = torch.softmax(logits, dim=-1)
    routed = {}

    def route(lg):
        top_vals, top_idx = top_k(lg, k)                       # (B,S,k)
        routed["gate"] = torch.softmax(top_vals, dim=-1)       # renormalized
        routed["e_flat"], routed["slot"], routed["keep"] = _slots(
            top_idx, E, C)
        return torch.nn.functional.one_hot(top_idx[..., 0], E).float()

    # ---- aux losses (computed on the full router distribution) ----
    me = torch.mean(probs, dim=(0, 1))                             # (E,)
    assign_onehot = local_rows(route, logits, out_shape=(B, S, E))
    ce = torch.mean(assign_onehot, dim=(0, 1))            # top-1 share
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    expert_in = local_rows(lambda xl: _dispatch(xl, routed, E, C), x,
                           out_shape=(B, E, C, d))                 # (B,E,C,d)
    if constrain_in is not None:
        expert_in = constrain_in(expert_in)

    # ---- expert FFN (batched over E) ----
    expert_in, back = experts_local(expert_in, w("wi"))
    h = torch.einsum("becd,edf->becf", expert_in, w("wi"))
    h = act_fn(act)(h)
    if "wg" in params:
        h = h * torch.einsum("becd,edf->becf", expert_in, w("wg"))
    if constrain_hidden is not None:
        h = constrain_hidden(h)
    out_e = back(torch.einsum("becf,efd->becd", h, w("wo")))      # (B,E,C,d)
    if constrain_out is not None:
        out_e = constrain_out(out_e)

    out = local_rows(lambda ol: _combine(ol, routed, S, k), out_e,
                     out_shape=(B, S, d))
    keep = routed["keep"]
    aux = {"lb_loss": lb_loss, "z_loss": z_loss,
           "drop_frac": 1.0 - torch.mean(keep.float())}
    return out, aux


def _slots(top_idx, E, C):
    """``(e_flat, slot, keep)`` of the top-k choices ``(B, S, k)``: each
    (token, k)'s expert, its position within that expert (the overflow
    slot ``C`` past the capacity) and whether it fits."""
    B, S, k = top_idx.shape
    dev = top_idx.device
    e_flat = top_idx.reshape(B, S * k)                             # token-major
    order = torch.argsort(e_flat, dim=-1, stable=True)             # (B,S*k)
    sorted_e = torch.gather(e_flat, -1, order)
    experts = torch.arange(E, device=dev).expand(B, E).contiguous()
    starts = torch.searchsorted(sorted_e, experts, side="left")    # (B,E)
    pos_sorted = torch.arange(S * k, device=dev)[None, :] - torch.gather(
        starts, -1, sorted_e)
    inv_order = torch.argsort(order, dim=-1)
    slot = torch.gather(pos_sorted, -1, inv_order)
    keep = slot < C
    slot = torch.where(keep, slot, C)                              # overflow slot
    return e_flat, slot, keep


def _dispatch(x, routed, E, C):
    """``(B, E, C, d)`` expert inputs: the (E, C+1) slot table of source
    tokens, rows gathered from ``x`` (a zero row for empty slots)."""
    B, S, d = x.shape
    e_flat, slot = routed["e_flat"], routed["slot"]
    k = e_flat.shape[1] // S
    dev = x.device
    tok_idx = torch.arange(S, device=dev).repeat_interleave(k).expand(B, S * k)
    table = torch.full((B, E * (C + 1)), S, dtype=torch.int64, device=dev)
    table.scatter_(1, e_flat * (C + 1) + slot, tok_idx)   # S -> the zero row
    table = table.view(B, E, C + 1)
    xp = torch.cat([x, torch.zeros((B, 1, d), dtype=x.dtype, device=dev)],
                   dim=1)                                          # zero pad row
    src = table[..., :C].reshape(B, E * C, 1).expand(B, E * C, d)
    return torch.gather(xp, 1, src).view(B, E, C, d)


def _combine(out_e, routed, S, k):
    """``(B, S, d)``: each assignment's expert output gathered back,
    weighted by its gate (0 when dropped) and summed over the k choices."""
    B, E, C, d = out_e.shape
    e_flat, slot, keep = routed["e_flat"], routed["slot"], routed["keep"]
    out_flat = torch.cat(
        [out_e, torch.zeros((B, E, 1, d), dtype=out_e.dtype,
                            device=out_e.device)],
        dim=2).reshape(B, E * (C + 1), d)
    gather_idx = e_flat * (C + 1) + slot                           # (B,S*k)
    vals = torch.gather(out_flat, 1, gather_idx[..., None].expand(-1, -1, d))
    vals = vals * (routed["gate"].reshape(B, S * k, 1)
                   * keep[..., None]).to(vals.dtype)
    return vals.reshape(B, S, k, d).sum(dim=2)
