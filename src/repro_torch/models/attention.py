"""Attention: blockwise (flash-style) training/prefill paths + KV-cache decode
(port of ``repro.models.attention``).

Three training/prefill implementations, selected by config:

* ``blockwise``  — online-softmax over (q-block × kv-block) tiles.
  Causal/window masking is applied per tile; fully-masked tiles still cost
  FLOPs.
* ``packed``     — causal-exact variant: only tiles with ki <= qi are
  evaluated (a static lower-triangular tile schedule).
* ``swa``        — sliding-window: per q-block, a (window + q_block)-wide kv
  slab is sliced, making FLOPs O(S·window) instead of O(S²).

All paths support GQA (q heads grouped over kv heads), attention-logit
soft-capping (gemma-2), and bidirectional mode (whisper encoder).  Scores
and the probability-value product are fp32, as the reference's
``preferred_element_type`` asks; masked scores are ``NEG_INF`` and every
tile's softmax is the reference's online one, op for op.
"""
from __future__ import annotations

import torch

from .layers import dslice, einsum_f32

NEG_INF = -1.0e30


def _tile_attn(qblk, kblk, vblk, mask, scale, cap):
    """One online-softmax tile.  qblk: (B, qb, KH, G, D); k/v: (B, kb, KH, D).

    Returns (row_max (B,KH,G,qb), p_sum, pv (B,KH,G,qb,D)) in f32.
    """
    s = einsum_f32("bqhgd,bkhd->bhgqk", qblk, kblk) * scale
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    s = torch.where(mask, s, NEG_INF)
    m = torch.amax(s, dim=-1)
    p = torch.where(mask, torch.exp(s - m[..., None]), 0.0)
    pv = einsum_f32("bhgqk,bkhd->bhgqd", p.to(vblk.dtype), vblk)
    return m, torch.sum(p, dim=-1), pv


def _merge(m, lsum, acc, m2, l2, pv):
    m_new = torch.maximum(m, m2)
    a1 = torch.exp(m - m_new)
    a2 = torch.exp(m2 - m_new)
    return m_new, lsum * a1 + l2 * a2, acc * a1[..., None] + pv * a2[..., None]


def _finish(lsum, acc, B, qb, KH, G, D, dtype):
    out = acc / torch.clamp(lsum, min=1e-37)[..., None]    # (B,KH,G,qb,D)
    return out.permute(0, 3, 1, 2, 4).reshape(B, qb, KH * G, D).to(dtype)


def _grouped(q, k):
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    if H % KH:
        raise ValueError(f"{H} query heads do not group over {KH} kv heads")
    return q.reshape(B, Sq, KH, H // KH, D), H // KH


def _carry(B, KH, G, qb, D, device):
    return (torch.full((B, KH, G, qb), NEG_INF, device=device),
            torch.zeros((B, KH, G, qb), device=device),
            torch.zeros((B, KH, G, qb, D), device=device))


def _blocks(Sq, qb, what):
    if Sq % qb:
        raise ValueError(f"{what}: Sq = {Sq} must be at most the q block or "
                         f"a multiple of it (q block {qb})")
    return Sq // qb


def blockwise_attention(
    q, k, v, *, causal=True, window=None, softcap=None,
    q_block=512, k_block=512, q_offset=0,
):
    """Masked blockwise attention.  q: (B,Sq,H,D), k/v: (B,Sk,KH,D).

    ``q_offset``: global position of q[0] (for prefill continuation).
    Sequence lengths must be multiples of the block sizes (configs ensure it).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qb, kb = min(q_block, Sq), min(k_block, Sk)
    nq, nk = _blocks(Sq, qb, "blockwise_attention"), Sk // kb
    qg, G = _grouped(q, k)
    KH = k.shape[2]
    scale = D ** -0.5
    iq = torch.arange(qb, device=q.device)
    ik = torch.arange(kb, device=q.device)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi * qb:(qi + 1) * qb]
        m, lsum, acc = _carry(B, KH, G, qb, D, q.device)
        for ki in range(nk):
            kblk = dslice(k, ki * kb, kb, 1)
            vblk = dslice(v, ki * kb, kb, 1)
            qpos = q_offset + qi * qb + iq[:, None]
            kpos = ki * kb + ik[None, :]
            mask = torch.ones((qb, kb), dtype=torch.bool, device=q.device)
            if causal:
                mask &= qpos >= kpos
            if window is not None:
                mask &= kpos > qpos - window
            m, lsum, acc = _merge(m, lsum, acc, *_tile_attn(
                qblk, kblk, vblk, mask, scale, softcap))
        outs.append(_finish(lsum, acc, B, qb, KH, G, D, q.dtype))
    return torch.cat(outs, dim=1)


def packed_causal_attention(
    q, k, v, *, softcap=None, q_block=512, k_block=512,
):
    """Causal attention evaluating only tiles with ki <= qi (exact FLOPs).

    Requires Sq == Sk (self-attention prefill/training).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    if Sq != Sk:
        raise ValueError("packed path is for self-attention (Sq == Sk)")
    qb, kb = min(q_block, Sq), min(k_block, Sk)
    if qb != kb:
        raise ValueError("packed path uses square tiles")
    n = Sq // qb
    qg, G = _grouped(q, k)
    KH = k.shape[2]
    scale = D ** -0.5
    iq = torch.arange(qb, device=q.device)
    ik = torch.arange(kb, device=q.device)
    out = torch.zeros((B, Sq, H, D), dtype=q.dtype, device=q.device)
    for qi in range(n):         # row-major lower-triangular tile schedule
        qblk = dslice(qg, qi * qb, qb, 1)
        m, lsum, acc = _carry(B, KH, G, qb, D, q.device)
        for ki in range(qi + 1):
            kblk = dslice(k, ki * kb, kb, 1)
            vblk = dslice(v, ki * kb, kb, 1)
            if qi == ki:
                mask = iq[:, None] >= ik[None, :]
            else:
                mask = torch.ones((qb, kb), dtype=torch.bool, device=q.device)
            m, lsum, acc = _merge(m, lsum, acc, *_tile_attn(
                qblk, kblk, vblk, mask, scale, softcap))
        out[:, qi * qb:(qi + 1) * qb] = _finish(lsum, acc, B, qb, KH, G, D,
                                                q.dtype)
    return out


def swa_attention(
    q, k, v, *, window, softcap=None, q_block=512, q_offset=0,
):
    """Sliding-window causal attention with O(S·window) FLOPs.

    Per q block, slices a (window + q_block)-wide kv slab ending at the
    block's last row.  Assumes Sq == Sk (training/prefill).
    """
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qb = min(q_block, Sq)
    nq = _blocks(Sq, qb, "swa_attention")
    slab = min(Sk, window + qb)
    qg, G = _grouped(q, k)
    KH = k.shape[2]
    scale = D ** -0.5
    iq = torch.arange(qb, device=q.device)
    ik = torch.arange(slab, device=q.device)
    outs = []
    for qi in range(nq):
        qblk = qg[:, qi * qb:(qi + 1) * qb]
        q_end = q_offset + (qi + 1) * qb            # one past last q position
        start = max(0, min(q_end - slab, Sk - slab))
        kblk = k[:, start:start + slab]
        vblk = v[:, start:start + slab]
        qpos = q_offset + qi * qb + iq[:, None]
        kpos = start + ik[None, :]
        mask = (qpos >= kpos) & (kpos > qpos - window)
        _, lsum, pv = _tile_attn(qblk, kblk, vblk, mask, scale, softcap)
        outs.append(_finish(lsum, pv, B, qb, KH, G, D, q.dtype))
    return torch.cat(outs, dim=1)


def decode_attention(
    q, k_cache, v_cache, pos, *, window=None, softcap=None,
):
    """Single-token decode vs a (possibly window-limited) KV cache.

    q: (B, 1, H, D); caches: (B, S_cache, KH, D); pos: an int or a (B,)
    tensor, the current position (number of valid cache entries,
    *including* this step's token already inserted by the caller).
    """
    B, _, H, D = q.shape
    Sk = k_cache.shape[1]
    qg, G = _grouped(q, k_cache)
    scale = D ** -0.5
    s = einsum_f32("bqhgd,bkhd->bhgqk", qg, k_cache) * scale
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    kpos = torch.arange(Sk, device=q.device)
    pos_b = pos.reshape(-1, 1) if isinstance(pos, torch.Tensor) else int(pos)
    valid = kpos[None, :] < pos_b                     # (B or 1, Sk)
    if window is not None:
        valid &= kpos[None, :] > pos_b - 1 - window   # last `window` entries
    s = torch.where(valid[:, None, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    p = p / torch.sum(p, dim=-1, keepdim=True)
    out = einsum_f32("bhgqk,bkhd->bhgqd", p.to(v_cache.dtype), v_cache)
    return out.permute(0, 3, 1, 2, 4).reshape(B, 1, H, D).to(q.dtype)


def attention(
    q, k, v, *, impl="blockwise", causal=True, window=None, softcap=None,
    q_block=512, k_block=512,
):
    """Dispatch by implementation name (training/prefill)."""
    if impl == "packed" and causal and window is None and q.shape[1] == k.shape[1]:
        return packed_causal_attention(
            q, k, v, softcap=softcap, q_block=q_block, k_block=k_block)
    if impl == "swa" or (window is not None and q.shape[1] > 2 * (window or 0)):
        if window is not None and causal:
            return swa_attention(
                q, k, v, window=window, softcap=softcap, q_block=q_block)
    return blockwise_attention(
        q, k, v, causal=causal, window=window, softcap=softcap,
        q_block=q_block, k_block=k_block)
