"""Mamba2 (state-space duality) block: chunked-scan prefill + recurrent
decode (port of ``repro.models.ssm``).

Follows Dao & Gu (2024) SSD with scalar-per-head decay A:

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t ;   y_t = C_t^T h_t + D x_t

Prefill uses the chunked dual form: an intra-chunk attention-like quadratic
term plus an inter-chunk state recurrence (a loop over the ``S / Q``
chunks).  Decode is the O(1) recurrence with a rolling depthwise-conv
cache.  The casts to the compute dtype sit where the reference's do: the
SSM state stays fp32, the conv cache is in the compute dtype.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..launch.cost import scan
from .layers import dense_init, einsum_f32, rmsnorm
from .sharded import is_dt, local_rows, replicate, whole


class SSMSpec(NamedTuple):
    d_model: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 128

    @property
    def d_inner(self):
        return self.expand * self.d_model

    @property
    def n_heads(self):
        return self.d_inner // self.head_dim

    @property
    def conv_dim(self):
        return self.d_inner + 2 * self.d_state  # x, B, C share the conv


def ssm_init(gen, spec: SSMSpec, dtype, lead=()):
    """One block's parameters (``lead`` stacks them), drawn from ``gen``
    with the reference's distributions."""
    di, N, H = spec.d_inner, spec.d_state, spec.n_heads
    dev = gen.device
    proj_out = 2 * di + 2 * N + H    # z, x, B, C, dt

    def per_head(v):
        return v.to(dtype).expand(*lead, H).clone()
    conv_w = torch.randn((*lead, spec.d_conv, spec.conv_dim), generator=gen,
                         device=dev)
    return {
        "in_proj": dense_init(gen, spec.d_model, (proj_out,), dtype,
                              lead=lead),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": torch.zeros((*lead, spec.conv_dim), dtype=dtype, device=dev),
        "A_log": per_head(torch.log(torch.linspace(1.0, 16.0, H, device=dev))),
        "D": per_head(torch.ones(H, device=dev)),
        "dt_bias": per_head(torch.log(torch.expm1(
            torch.full((H,), 0.01, device=dev)))),
        "norm_scale": torch.zeros((*lead, di), dtype=dtype, device=dev),
        "out_proj": dense_init(gen, di, (spec.d_model,), dtype, lead=lead),
    }


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))


def _split_proj(zxbcdt, spec: SSMSpec):
    di = spec.d_inner
    z = zxbcdt[..., :di]
    xBC = zxbcdt[..., di:di + spec.conv_dim]
    dt = zxbcdt[..., di + spec.conv_dim:]
    return z, xBC, dt


def _causal_conv(xBC, w, b):
    """Depthwise causal conv, kernel K, via K shifted adds.  xBC: (B, S, C)."""
    K = w.shape[0]
    S = xBC.shape[1]
    pad = F.pad(xBC, (0, 0, K - 1, 0))
    out = sum(pad[:, k:k + S, :] * w[k] for k in range(K))
    return F.silu(out + b)


def ssm_apply(x, params, spec: SSMSpec, compute_dtype):
    """Prefill forward.  x: (B, S, d_model) -> (y (B, S, d_model), cache).

    The cache, ``{"ssm": (B, H, P, N) fp32, "conv": (B, K-1, conv_dim)}``,
    seeds decode.  ``S`` must be at most the chunk or a multiple of it.
    Under DTensor the block between the two projections runs on each
    rank's own rows (``sharded.local_rows``), the projections as DTensor
    products; the TP-sharded ``in_proj`` output is gathered for the split
    into z | xBC | dt.
    """
    cd = compute_dtype
    B, S, _ = x.shape
    H, P, N = spec.n_heads, spec.head_dim, spec.d_state
    Q = min(spec.chunk, S)
    if S % Q:
        raise ValueError(f"ssm_apply: the sequence length S = {S} is not a "
                         f"multiple of the chunk Q = {Q}")

    def w(n):
        return params[n].to(cd)

    zxbcdt = whole(x @ w("in_proj"), -1)
    inner = {"conv_w": w("conv_w"), "conv_b": w("conv_b"),
             "dt_bias": params["dt_bias"], "A_log": params["A_log"],
             "D": params["D"], "norm_scale": params["norm_scale"]}
    y, s = local_rows(lambda z, p: _ssd(z, p, spec, cd), zxbcdt, inner,
                      out_shape=((B, S, spec.d_inner), (B, H, P, N)))
    out = y @ w("out_proj")

    conv_tail = xBC_raw_tail(x, params, spec, cd)
    return out, {"ssm": s, "conv": conv_tail}


def _ssd(zxbcdt, params, spec: SSMSpec, cd):
    """The block between the projections, row by row: the causal conv,
    the chunked SSD scan, the gate and the norm.  Returns ``(y (B, S,
    d_inner), final state (B, H, P, N) fp32)``."""
    B, S, _ = zxbcdt.shape
    di, N, H, P = spec.d_inner, spec.d_state, spec.n_heads, spec.head_dim
    Q = min(spec.chunk, S)
    nc = S // Q
    z, xBC, dt_raw = _split_proj(zxbcdt, spec)
    xBC = _causal_conv(xBC, params["conv_w"], params["conv_b"])
    xs = xBC[..., :di].reshape(B, S, H, P)
    Bm = xBC[..., di:di + N]                                  # (B, S, N), G=1
    Cm = xBC[..., di + N:]
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())      # (B,S,H)
    A = -torch.exp(params["A_log"].float())                          # (H,)
    dA = dt * A                                                      # log-decay

    # chunk views
    xs_c = xs.reshape(B, nc, Q, H, P)
    B_c = Bm.reshape(B, nc, Q, N)
    C_c = Cm.reshape(B, nc, Q, N)
    dt_c = dt.reshape(B, nc, Q, H)
    la = torch.cumsum(dA.reshape(B, nc, Q, H), dim=2)                # (B,nc,Q,H)

    # ---- intra-chunk (dual/attention-like) term, vectorized over chunks ----
    CB = einsum_f32("bcin,bcjn->bcij", C_c, B_c)                     # (B,nc,Q,Q)
    seg = la[:, :, :, None, :] - la[:, :, None, :, :]                # (B,nc,i,j,H)
    iq = torch.arange(Q, device=zxbcdt.device)
    causal = iq[:, None] >= iq[None, :]
    causal = causal[None, None, :, :, None]
    # seg is masked before the exp: above the diagonal it is positive and
    # its exp overflows once a chunk's decay sum passes 88.7, and a select
    # after the exp would take the gradient 0·inf = NaN there (the
    # reference does; ROADMAP, queue C, C10).  exp(-inf) = 0 gives the same
    # forward.
    decay = torch.exp(torch.where(causal, seg, float("-inf")))
    att = CB[..., None] * decay * dt_c[:, :, None, :, :]             # (B,nc,i,j,H)
    att = torch.where(causal, att, 0.0)
    y_diag = einsum_f32("bcijh,bcjhp->bcihp", att.to(cd), xs_c)

    # ---- inter-chunk state recurrence ----
    decay_to_end = torch.exp(la[:, :, -1:, :] - la)                  # (B,nc,Q,H)
    chunk_state = einsum_f32("bcjh,bcjn,bcjhp->bchpn",
                             (decay_to_end * dt_c).to(cd), B_c, xs_c)
    chunk_decay = torch.exp(la[:, :, -1, :])                         # (B,nc,H)
    # the state after each chunk; under autograd every chunk runs in a dry
    # run too: the last chunk's state takes no gradient in training
    def chunk(c, s):
        s = s * chunk_decay[:, c, :, None, None] + chunk_state[:, c]
        return s, s

    s0 = torch.zeros((B, H, P, N), device=zxbcdt.device)
    s, after = scan(chunk, s0, nc, under_grad=False)
    # the state *before* chunk c
    prev_states = torch.stack([s0] + after[:-1], dim=1)               # (B,nc,H,P,N)

    y_inter = einsum_f32("bcin,bchpn,bcih->bcihp", C_c, prev_states.to(cd),
                         torch.exp(la).to(cd))

    y = (y_diag + y_inter).reshape(B, S, H, P)
    y = y + params["D"].float()[None, None, :, None] * xs.float()
    y = y.reshape(B, S, di).to(cd)

    # gated RMSNorm (the out projection follows)
    y = y * F.silu(z)
    return rmsnorm(y, {"scale": params["norm_scale"]}, 1e-5), s


def xBC_raw_tail(x, params, spec: SSMSpec, compute_dtype):
    """Last (K-1) pre-conv xBC rows — the decode conv cache after prefill,
    projected again from ``x`` as the reference does."""
    K = spec.d_conv
    tail = whole(x[:, -(K - 1):, :] @ params["in_proj"].to(compute_dtype),
                 -1)
    _, xBC, _ = _split_proj(tail, spec)
    return xBC  # (B, K-1, conv_dim)


def ssm_init_cache(batch, spec: SSMSpec, dtype=torch.float32):
    return {
        "ssm": torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state)),
        "conv": torch.zeros((batch, spec.d_conv - 1, spec.conv_dim),
                            dtype=dtype),
    }


def ssm_decode_step(x, cache, params, spec: SSMSpec, compute_dtype):
    """One-token recurrence.  x: (B, d_model); cache from ssm_init_cache.

    Returns (y (B, d_model), new_cache); ``cache`` is left as it is.
    """
    cd = compute_dtype
    B, _ = x.shape
    di, N, H, P = spec.d_inner, spec.d_state, spec.n_heads, spec.head_dim

    def w(n):
        return params[n].to(cd)

    zxbcdt = whole(x @ w("in_proj"), -1)
    z, xBC_new, dt_raw = _split_proj(zxbcdt, spec)
    # rolling conv window: cache holds previous K-1 raw xBC rows
    window = torch.cat([whole(cache["conv"], -1), xBC_new[:, None, :]],
                       dim=1)                                        # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", window, replicate(w("conv_w"))) \
        + replicate(w("conv_b"))
    xBC = F.silu(conv_out)
    xv = xBC[:, :di].reshape(B, H, P)
    Bm = xBC[:, di:di + N]
    Cm = xBC[:, di + N:]
    dt = _softplus(dt_raw.float() + params["dt_bias"].float())       # (B,H)
    A = -torch.exp(params["A_log"].float())
    dA = torch.exp(dt * A)                                           # (B,H)

    state = cache["ssm"] * dA[..., None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt, xv.float(), Bm.float())               # (B,H,P,N)
    if is_dt(state):
        # DTensor cannot place the einsum's bmm on a state sharded over TP
        # (heads or P): it flattens them into a strided shard; the same
        # sum, elementwise
        y = (state * Cm.float()[:, None, None, :]).sum(-1)
    else:
        y = torch.einsum("bhpn,bn->bhp", state, Cm.float())
    y = y + params["D"].float()[None, :, None] * xv.float()
    # (H, P) whole before they are flattened (as above) for the gated
    # norm, which reads all of them anyway
    y = whole(whole(y, 1), 2)
    y = y.reshape(B, di).to(cd)
    y = y * F.silu(z)
    y = rmsnorm(y, {"scale": params["norm_scale"]}, 1e-5)
    out = y @ w("out_proj")
    return out, {"ssm": state, "conv": window[:, 1:, :]}
