"""Flash attention, forward (port of ``repro.models.flash._fwd``).

The reference is a ``jax.custom_vjp`` over a block loop in plain XLA ops,
not a Pallas kernel, so its port is the same q/k tile loop in plain
PyTorch: per q block, an online softmax over kv blocks, in fp32.  It
supports causal masking, sliding windows (O(S·window) via the slab), GQA,
gemma-2 logit soft-capping and a ``q_offset``, and also returns the
log-sum-exp rows the backward will need.  The backward (``_bwd``) and a
``torch.autograd.Function`` come with the training slice (ROADMAP, queue
A, A13c).
"""
from __future__ import annotations

import torch

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
    """(B,qb,KH,G,D) x (B,kb,KH,D) -> f32 (B,KH,G,qb,kb)."""
    s = einsum_f32("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
    if softcap is None:
        return s
    return softcap * torch.tanh(s / softcap)


def flash_attention(q, k, v, causal=True, window=None, softcap=None,
                    q_block=512, k_block=512, q_offset=0):
    """q: (B,Sq,H,D); k/v: (B,Sk,KH,D) -> (B,Sq,H,D)."""
    return flash_forward(q, k, v, causal, window, softcap, q_block, k_block,
                         q_offset)[0]


def flash_forward(q, k, v, causal=True, window=None, softcap=None,
                  q_block=512, k_block=512, q_offset=0):
    """``(out (B,Sq,H,D), lse (B,KH,G,Sq) fp32)``.

    ``Sq`` must be at most ``q_block`` or a multiple of it (the reference
    fails in a reshape otherwise).  As in the reference, a kv length that
    is no multiple of the k block leaves its tail unread.
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    KH = k.shape[2]
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    G = H // KH
    qb = min(q_block, Sq)
    kb = min(k_block, Sk)
    if Sq % qb:
        raise ValueError(f"flash attention: Sq = {Sq} must be at most "
                         f"q_block = {q_block} or a multiple of it")
    nq = Sq // qb
    scale = D ** -0.5
    qg = q.reshape(B, Sq, KH, G, D)
    use_slab = window is not None and causal and Sk > window + qb
    slab = min(Sk, -(-(window + qb) // kb) * kb) if use_slab else Sk
    nk = slab // kb
    masked = causal or window is not None     # skip the selects when all-True
    iq = torch.arange(qb, device=q.device)
    ik = torch.arange(kb, device=q.device)
    outs, lses = [], []
    for qi in range(nq):
        qblk = qg[:, qi * qb:(qi + 1) * qb]
        if use_slab:
            start = max(0, min(q_offset + (qi + 1) * qb - slab, Sk - slab))
        else:
            start = 0
        m = torch.full((B, KH, G, qb), NEG_INF, device=q.device)
        lsum = torch.zeros((B, KH, G, qb), device=q.device)
        acc = torch.zeros((B, KH, G, qb, D), device=q.device)
        for kj in range(nk):
            k0 = start + kj * kb
            kblk = dslice(k, k0, kb, 1)
            vblk = dslice(v, k0, kb, 1)
            s = _scores(qblk, kblk, scale, softcap)
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
            m, lsum, acc = (m_new, lsum * a1 + l2 * a2,
                         acc * a1[..., None] + pv * a2[..., None])
        o = acc / torch.clamp(lsum, min=1e-37)[..., None]
        lses.append(m + torch.log(torch.clamp(lsum, min=1e-37)))
        outs.append(o.permute(0, 3, 1, 2, 4).reshape(B, qb, H, D).to(q.dtype))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=-1)
