"""Flash attention's backward in the port (``models/flash.py``) against
``repro``'s custom VJP, a naive attention, and finite differences.

* ``tests/test_attention.py``'s flash cases (causal, softcap, window 48,
  bidirectional, window 100) and a ``q_offset`` continuation, at B 2,
  S 256, 8 heads over 4 kv heads, blocks of 64, on the same numpy
  inputs: the output and the gradients of ``sum(out²)`` against JAX's
  ``flash_attention`` (its ``_bwd``) at rtol 1e-5, and against a naive
  softmax attention in torch at rtol 3e-4 (the reference test's).
* ``torch.autograd.gradcheck`` in fp64 at a tiny shape with the slab, a
  soft-cap, GQA and a ``q_offset``.
* Under ``no_grad`` or with inputs that need no gradient,
  ``flash_attention`` is the forward alone, bit for bit; the Function
  saves only ``(q, k, v, out, lse)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.flash import flash_attention as jax_flash
from repro_torch.models import flash as F
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

CASES = [("causal", dict()), ("softcap", dict(softcap=30.0)),
         ("window", dict(window=48)), ("bidir", dict(causal=False)),
         ("window100", dict(window=100)), ("q_offset", dict(q_offset=64))]


def _qkv(B=2, S=256, H=8, KH=4, D=32, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((B, S, H, D), (B, S, KH, D), (B, S, KH, D)))


def _args(kw):
    return (kw.get("causal", True), kw.get("window"), kw.get("softcap"),
            64, 64, kw.get("q_offset", 0))


def naive(q, k, v, causal=True, window=None, softcap=None, q_offset=0):
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    qg = q.reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k) * D ** -0.5
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    iq = q_offset + torch.arange(Sq)[:, None]
    ik = torch.arange(k.shape[1])[None, :]
    mask = torch.ones((Sq, k.shape[1]), dtype=torch.bool)
    if causal:
        mask &= iq >= ik
    if window is not None:
        mask &= ik > iq - window
    p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v)
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


def _grads(fn, q, k, v):
    """``fn``'s output and the gradients of ``sum(out²)`` in q, k, v."""
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    out = fn(*ts)
    return out.detach(), torch.autograd.grad((out ** 2).sum(), ts)


@pytest.mark.parametrize("name,kw", CASES, ids=[c[0] for c in CASES])
def test_values_and_grads_match_reference_and_naive(name, kw):
    q, k, v = _qkv()
    if "q_offset" in kw:
        q = q[:, kw["q_offset"]:]

    def f(q, k, v):
        return jax_flash(q, k, v, *_args(kw))

    jout = f(q, k, v)
    jgrads = jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    out, grads = _grads(lambda *t: F.flash_attention(*t, *_args(kw)), q, k, v)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-5,
                               atol=1e-6, err_msg="out")
    for n, a, b in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=f"d{n} vs repro")
    nout, ngrads = _grads(lambda *t: naive(*t, **kw), q, k, v)
    np.testing.assert_allclose(out.numpy(), nout.numpy(), rtol=2e-5,
                               atol=2e-5, err_msg="out vs naive")
    for n, a, b in zip("qkv", grads, ngrads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-4,
                                   atol=3e-4, err_msg=f"d{n} vs naive")


@pytest.mark.parametrize("kw", [dict(window=3, softcap=2.0),
                                dict(causal=False),
                                dict(q_offset=4, window=5)])
def test_gradcheck_fp64(kw):
    q, k, v = _qkv(B=1, S=12, H=4, KH=2, D=4, dtype=np.float64, seed=1)
    off = kw.get("q_offset", 0)
    ts = [torch.tensor(a, requires_grad=True) for a in (q[:, off:], k, v)]
    args = (kw.get("causal", True), kw.get("window"), kw.get("softcap"), 4,
            4, off)
    assert torch.autograd.gradcheck(
        lambda q, k, v: F.FlashAttention.apply(q, k, v, *args), ts)


def test_forward_alone_without_grad_and_five_saved_tensors():
    q, k, v = (torch.as_tensor(a) for a in _qkv(S=128))
    want, _ = F.flash_forward(q, k, v, True, None, None, 64, 64, 0)
    out = F.flash_attention(q, k, v, True, None, None, 64, 64, 0)
    assert out.grad_fn is None and torch.equal(out, want)
    ts = [t.clone().requires_grad_(True) for t in (q, k, v)]
    with torch.no_grad():
        out = F.flash_attention(*ts, True, None, None, 64, 64, 0)
    assert out.grad_fn is None and torch.equal(out, want)
    out = F.flash_attention(*ts, True, None, None, 64, 64, 0)
    assert torch.equal(out, want)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert len(out.grad_fn.saved_tensors) == 5
