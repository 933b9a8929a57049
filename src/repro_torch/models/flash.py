"""Flash attention with a hand-written backward (port of
``repro.models.flash``).

The reference is a ``jax.custom_vjp`` over a block loop in plain XLA ops,
not a Pallas kernel, so its port is the same q/k tile loop in plain
PyTorch.  The forward is an online softmax per q block over kv blocks, in
fp32, and returns the log-sum-exp rows.  The backward recomputes the
tiles in the reference's two passes, so nothing of size O(S²) is kept:

* pass A: per q block -> dq (inner loop over kv blocks);
* pass B: per kv block -> dk, dv (inner loop over q blocks).

Both support causal masking, sliding windows (O(S·window) via the slab),
GQA, gemma-2 logit soft-capping and a ``q_offset``.  ``FlashAttention``
is the ``torch.autograd.Function`` that joins them; it saves only
``(q, k, v, out, lse)``.  ``flash_attention`` goes through it only when an
input needs a gradient; otherwise it is the forward alone.

The tile loops run through ``launch.cost.scan``: plain loops, except in a
dry run on fake tensors, where a tile is counted once for all (every tile
runs the same ops on the same shapes: the causal mask is a select on
every tile, not a skip).
"""
from __future__ import annotations

import torch

from ..launch.cost import scan
from .attention import NEG_INF
from .layers import dslice, einsum_f32


def _mask(qpos, kpos, causal, window):
    m = torch.ones(torch.broadcast_shapes(qpos.shape, kpos.shape),
                   dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos >= kpos
    if window is not None:
        m &= kpos > qpos - window
    return m


def _scores(qblk, kblk, scale, softcap):
    """(B,qb,KH,G,D) x (B,kb,KH,D) -> f32 (B,KH,G,qb,kb); returns (s, gate)
    where gate is d(s)/d(s_hat) for the softcap chain (None if no cap)."""
    s = einsum_f32("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
    if softcap is None:
        return s, None
    t = torch.tanh(s / softcap)
    return softcap * t, 1.0 - t * t


def _geometry(q, k, causal, window, q_block, k_block):
    """The block shapes both passes share: ``(B, Sq, H, D, Sk, KH, G, qb,
    kb, use_slab, slab)``."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    KH = k.shape[2]
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    qb = min(q_block, Sq)
    kb = min(k_block, Sk)
    if Sq % qb:
        raise ValueError(f"flash attention: Sq = {Sq} must be at most "
                         f"q_block = {q_block} or a multiple of it")
    use_slab = window is not None and causal and Sk > window + qb
    slab = min(Sk, -(-(window + qb) // kb) * kb) if use_slab else Sk
    return B, Sq, H, D, Sk, KH, H // KH, qb, kb, use_slab, slab


def flash_forward(q, k, v, causal=True, window=None, softcap=None,
                  q_block=512, k_block=512, q_offset=0):
    """``(out (B,Sq,H,D), lse (B,KH,G,Sq) fp32)``.

    ``Sq`` must be at most ``q_block`` or a multiple of it (the reference
    fails in a reshape otherwise).  As in the reference, a kv length that
    is no multiple of the k block leaves its tail unread.
    """
    B, Sq, H, D, Sk, KH, G, qb, kb, use_slab, slab = _geometry(
        q, k, causal, window, q_block, k_block)
    nq = Sq // qb
    scale = D ** -0.5
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, KH, G, D)
    nk = slab // kb
    masked = causal or window is not None     # skip the selects when all-True
    iq = torch.arange(qb, device=q.device)
    ik = torch.arange(kb, device=q.device)

    def q_block(qi, _):
        qblk = qg[:, qi * qb:(qi + 1) * qb]
        if use_slab:
            start = max(0, min(q_offset + (qi + 1) * qb - slab, Sk - slab))
        else:
            start = 0

        def kv_tile(kj, carry):
            m, lsum, acc = carry
            k0 = start + kj * kb
            kblk = dslice(k, k0, kb, 1)
            vblk = dslice(v, k0, kb, 1)
            s, _ = _scores(qblk, kblk, scale, softcap)
            if masked:
                qpos = q_offset + qi * qb + iq[:, None]
                kpos = k0 + ik[None, :]
                msk = _mask(qpos, kpos, causal, window)
                s = torch.where(msk, s, NEG_INF)
                m2 = torch.amax(s, dim=-1)
                p = torch.where(msk, torch.exp(s - m2[..., None]), 0.0)
            else:
                m2 = torch.amax(s, dim=-1)
                p = torch.exp(s - m2[..., None])
            l2 = torch.sum(p, dim=-1)
            pv = einsum_f32("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk)
            m_new = torch.maximum(m, m2)
            a1, a2 = torch.exp(m - m_new), torch.exp(m2 - m_new)
            return (m_new, lsum * a1 + l2 * a2,
                    acc * a1[..., None] + pv * a2[..., None]), None

        m = torch.full((B, KH, G, qb), NEG_INF, dtype=acc_dt, device=q.device)
        lsum = torch.zeros((B, KH, G, qb), dtype=acc_dt, device=q.device)
        acc = torch.zeros((B, KH, G, qb, D), dtype=acc_dt, device=q.device)
        (m, lsum, acc), _ = scan(kv_tile, (m, lsum, acc), nk)
        o = acc / torch.clamp(lsum, min=1e-37)[..., None]
        lse = m + torch.log(torch.clamp(lsum, min=1e-37))
        return None, (o.permute(0, 3, 1, 2, 4).reshape(B, qb, H, D).to(
            q.dtype), lse)

    _, blocks = scan(q_block, None, nq)
    outs, lses = zip(*blocks)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)


def flash_backward(q, k, v, out, lse, dout, causal=True, window=None,
                   softcap=None, q_block=512, k_block=512, q_offset=0):
    """``(dq, dk, dv)`` of ``flash_forward``'s ``out`` under the cotangent
    ``dout``, from the saved ``(q, k, v, out, lse)`` (the reference's
    ``_bwd``, op for op).

    ``delta = Σ_d dout·out`` is taken in fp32 from ``out`` as the forward
    returned it (in q's dtype); dq and dk are scaled once, at the end.
    """
    B, Sq, H, D, Sk, KH, G, qb, kb, use_slab, slab = _geometry(
        q, k, causal, window, q_block, k_block)
    nq, nk_full = Sq // qb, Sk // kb
    scale = D ** -0.5
    acc_dt = torch.promote_types(q.dtype, torch.float32)
    qg = q.reshape(B, Sq, KH, G, D)
    dog = dout.reshape(B, Sq, KH, G, D)
    og = out.reshape(B, Sq, KH, G, D)
    delta = torch.einsum("bshgd,bshgd->bhgs", dog.to(acc_dt), og.to(acc_dt))
    nk = slab // kb if use_slab else nk_full
    masked = causal or window is not None
    iq = torch.arange(qb, device=q.device)
    ik = torch.arange(kb, device=q.device)

    def tile_grads(qblk, kblk, vblk, lse_blk, delta_blk, do_blk, qpos, kpos):
        """Recompute p; return (ds_hat (B,KH,G,qb,kb), p)."""
        s, gate = _scores(qblk, kblk, scale, softcap)
        if masked:
            msk = _mask(qpos, kpos, causal, window)
            p = torch.where(msk, torch.exp(s - lse_blk[..., None]), 0.0)
        else:
            p = torch.exp(s - lse_blk[..., None])
        dp = einsum_f32("bqhgd,bkhd->bhgqk", do_blk, vblk)
        ds = p * (dp - delta_blk[..., None])
        if gate is not None:
            ds = ds * gate
        return ds, p

    # ---- pass A: dq per q block ----
    def dq_block(qi, _):
        qblk = qg[:, qi * qb:(qi + 1) * qb]
        do_blk = dog[:, qi * qb:(qi + 1) * qb]
        lse_blk = lse[..., qi * qb:(qi + 1) * qb]
        delta_blk = delta[..., qi * qb:(qi + 1) * qb]
        start = max(0, min(q_offset + (qi + 1) * qb - slab, Sk - slab)) \
            if use_slab else 0

        def kv_tile(kj, dq):
            k0 = start + kj * kb
            kblk = dslice(k, k0, kb, 1)
            vblk = dslice(v, k0, kb, 1)
            qpos = q_offset + qi * qb + iq[:, None]
            kpos = k0 + ik[None, :]
            ds, _ = tile_grads(qblk, kblk, vblk, lse_blk, delta_blk, do_blk,
                               qpos, kpos)
            return dq + einsum_f32("bhgqk,bkhd->bqhgd", ds.to(kblk.dtype),
                                   kblk), None

        dq = torch.zeros((B, qb, KH, G, D), dtype=acc_dt, device=q.device)
        dq, _ = scan(kv_tile, dq, nk)
        return None, (dq * scale).to(q.dtype)

    _, dqs = scan(dq_block, None, nq)
    dq = torch.cat(dqs, dim=1).reshape(B, Sq, H, D)

    # ---- pass B: dk, dv per kv block ----
    # q range attending to kv block j: [j*kb, j*kb + window + qb) for SWA,
    # else all q blocks (masked).
    if use_slab:
        q_slab = min(Sq, -(-(window + kb) // qb) * qb)      # ceil; edges masked
    else:
        q_slab = Sq
    nq_b = q_slab // qb

    def dkv_block(kj, _):
        k0 = kj * kb
        kblk = k[:, k0:k0 + kb]
        vblk = v[:, k0:k0 + kb]
        qstart = max(0, min(k0 - q_offset, Sq - q_slab)) if use_slab else 0

        def q_tile(qi, carry):
            dk, dv = carry
            qpos0 = qstart + qi * qb
            qblk = dslice(qg, qpos0, qb, 1)
            do_blk = dslice(dog, qpos0, qb, 1)
            lse_blk = dslice(lse, qpos0, qb, 3)
            delta_blk = dslice(delta, qpos0, qb, 3)
            qpos = q_offset + qpos0 + iq[:, None]
            kpos = k0 + ik[None, :]
            ds, p = tile_grads(qblk, kblk, vblk, lse_blk, delta_blk, do_blk,
                               qpos, kpos)
            return (dk + einsum_f32("bhgqk,bqhgd->bkhd", ds.to(qblk.dtype),
                                    qblk),
                    dv + einsum_f32("bhgqk,bqhgd->bkhd", p.to(do_blk.dtype),
                                    do_blk)), None

        dk = torch.zeros((B, kb, KH, D), dtype=acc_dt, device=q.device)
        dv = torch.zeros((B, kb, KH, D), dtype=acc_dt, device=q.device)
        (dk, dv), _ = scan(q_tile, (dk, dv), nq_b)
        return None, ((dk * scale).to(k.dtype), dv.to(v.dtype))

    _, dkvs = scan(dkv_block, None, nk_full)
    dks, dvs = zip(*dkvs)
    dk = torch.cat(dks, dim=1)
    dv = torch.cat(dvs, dim=1)
    if dk.shape[1] < Sk:        # the unread tail (Sk no multiple of kb)
        pad = (0, 0, 0, 0, 0, Sk - dk.shape[1])
        dk = torch.nn.functional.pad(dk, pad)
        dv = torch.nn.functional.pad(dv, pad)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``flash_forward`` with ``flash_backward`` as its gradient; saves
    only ``(q, k, v, out, lse)``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_block, k_block,
                q_offset):
        out, lse = flash_forward(q, k, v, causal, window, softcap, q_block,
                                 k_block, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = (causal, window, softcap, q_block, k_block, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, out, lse, dout, *ctx.opts)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    q_block=512, k_block=512, q_offset=0):
    """q: (B,Sq,H,D); k/v: (B,Sk,KH,D) -> (B,Sq,H,D).  Differentiable in
    q, k and v through ``FlashAttention`` when one of them requires a
    gradient; otherwise the forward alone, as the serve path calls it."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window, softcap,
                                    q_block, k_block, q_offset)
    return flash_forward(q, k, v, causal, window, softcap, q_block, k_block,
                         q_offset)[0]
