"""Shared neural-net layers (port of ``repro.models.layers``).

Parameters are nested dicts of tensors with the reference's keys and
layouts; init functions mirror apply functions.  Compute dtype and
parameter dtype are decoupled (the mixed-precision policy lives in the
config).  The init functions draw from the reference's distributions with
an explicit ``torch.Generator``; they do not reproduce JAX's bits.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def einsum_f32(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum`` with an fp32 result, as the reference's
    ``preferred_element_type=jnp.float32`` asks: inputs of a narrower dtype
    are widened first, which is exact, and the products are summed in fp32."""
    return torch.einsum(eq, a.float(), b.float())


def dslice(x: torch.Tensor, start: int, size: int, dim: int) -> torch.Tensor:
    """``lax.dynamic_slice_in_dim``: the start is clamped so that the slice
    lies inside ``x``."""
    start = max(0, min(int(start), x.shape[dim] - size))
    return x.narrow(dim, start, size)


def _he(gen, shape, dtype, scale=None, lead=()):
    """Fan-in normal over ``lead + shape``; the fan-in is ``shape``'s."""
    fan_in = shape[0] if len(shape) >= 2 else shape[-1]
    s = scale if scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn((*lead, *shape), generator=gen, device=gen.device)
    return (w * s).to(dtype)


def dense_init(gen, in_dim, out_shape, dtype, scale=None, lead=()):
    """Weight (in_dim, *out_shape); fan-in normal init."""
    return _he(gen, (in_dim, *out_shape), dtype, scale, lead)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm_init(d, dtype, device=None, lead=()):
    return {"scale": torch.zeros((*lead, d), dtype=dtype, device=device)}


def rmsnorm(x, params, eps):
    """``x·rsqrt(mean(x²) + eps)·(1 + scale)`` in fp32, back in x's dtype."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + params["scale"].float())).to(dt)


def layernorm_init(d, dtype, device=None, lead=()):
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(x, params, eps):
    dt = x.dtype
    x = x.float()
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    x = (x - mean) * torch.rsqrt(var + eps)
    x = x * params["scale"].float() + params["bias"].float()
    return x.to(dt)


# ---------------------------------------------------------------------------
# rotary / sinusoidal position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim, theta, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def rope_angles(positions, head_dim, theta):
    """``(cos, sin)`` of the fp32 angles, shaped ``(..., S, 1, D/2)`` for
    ``positions`` broadcastable to ``(..., S)``.  A forward pass computes
    them once and shares them between its layers."""
    freqs = rope_freqs(head_dim, theta, positions.device)
    ang = positions[..., :, None].float() * freqs
    return torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]


def rope_rotate(x, cos, sin):
    """Rotate split halves (not interleaved pairs) of ``x`` in fp32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x, positions, theta):
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    return rope_rotate(x, *rope_angles(positions, x.shape[-1], theta))


def sinusoidal_positions(n_pos, d, dtype=torch.float32, device=None):
    """Transformer sinusoidal table (used by the whisper encoder)."""
    pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2.0 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


# ---------------------------------------------------------------------------
# misc
# ---------------------------------------------------------------------------


def softcap(x, cap):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    return cap * torch.tanh(x / cap)


def act_fn(name: str):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


# ---------------------------------------------------------------------------
# gated MLP
# ---------------------------------------------------------------------------


def mlp_init(gen, d, f, dtype, gated=True, bias=False, lead=()):
    dev = gen.device
    p = {"wi": dense_init(gen, d, (f,), dtype, lead=lead),
         "wo": dense_init(gen, f, (d,), dtype, lead=lead)}
    if gated:
        p["wg"] = dense_init(gen, d, (f,), dtype, lead=lead)
    if bias:
        p["bi"] = torch.zeros((*lead, f), dtype=dtype, device=dev)
        p["bo"] = torch.zeros((*lead, d), dtype=dtype, device=dev)
    return p


def mlp(x, params, act, compute_dtype, constrain=None):
    """x: (..., d) -> (..., d).  constrain: optional fn applied to the hidden."""
    def w(n):
        return params[n].to(compute_dtype)
    h = x @ w("wi")
    if "bi" in params:
        h = h + w("bi")
    h = act_fn(act)(h)
    if "wg" in params:
        h = h * (x @ w("wg"))
    if constrain is not None:
        h = constrain(h)
    out = h @ w("wo")
    if "bo" in params:
        out = out + w("bo")
    return out


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def pad_vocab(v, multiple=128):
    return -(-v // multiple) * multiple


def embed_init(gen, vocab, d, dtype, pad_to=128):
    vp = pad_vocab(vocab, pad_to)
    w = torch.randn((vp, d), generator=gen, device=gen.device)
    return {"table": (w * 0.02).to(dtype)}


def embed_lookup(params, tokens, compute_dtype, scale_by_sqrt_d=False):
    """Rows of the table in the compute dtype; with ``scale_by_sqrt_d``
    times ``sqrt(d)`` rounded to the compute dtype first."""
    t = params["table"].to(compute_dtype)
    x = t[tokens]
    if scale_by_sqrt_d:
        x = x * torch.tensor(math.sqrt(t.shape[-1]), dtype=compute_dtype,
                             device=x.device)
    return x
