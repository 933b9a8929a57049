"""The port's ``HybridModel`` (zamba2) against ``repro``'s, in fp32, with
JAX's weights carried across by the bridge.

Prefill logits, every leaf of the nested cache and 8 decode steps at
rtol 1e-4 (``torch_parity.assert_lm_prefill_decode``), decoding at
``pos = S + step`` into the prefill's S-long K/V: the C6 slot, pinned
against ``repro`` too; ``attn_prefill_kv`` against the reference's and
against ``_layer_prefill``'s k, v; decode fed token by token from
``init_cache`` against prefill.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from torch_parity import LM_ATOL, LM_RTOL, LMPair, assert_lm_prefill_decode, \
    flat_cache


@pytest.fixture(scope="module")
def zamba():
    return LMPair("zamba2-2.7b")


@pytest.mark.parametrize("S", [32, 64])
def test_prefill_and_decode_match_reference(zamba, S):
    assert_lm_prefill_decode(zamba, S=S)


def test_decode_past_the_cache_overwrites_its_last_slot(zamba):
    """C6: the shared block's decode at pos >= S writes K/V slot S - 1 of
    every group, as ``repro`` does, and leaves the other slots alone."""
    S = 16
    toks = np.random.default_rng(3).integers(0, 512, (2, S)).astype(np.int32)
    jl, jcache = zamba.prefill(zamba.params, {"tokens": jnp.asarray(toks)})
    _, tcache = zamba.model.prefill({"tokens": torch.as_tensor(toks)})
    for pos in (S, S + 1):
        before = {k: tcache[k].clone() for k in "kv"}
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jcache = zamba.decode(zamba.params, jcache, jnp.asarray(tok),
                                  jnp.int32(pos))
        tl, tcache = zamba.model.decode_step(tcache, torch.as_tensor(tok), pos)
        for k in "kv":
            assert torch.equal(tcache[k][:, :, :S - 1], before[k][:, :, :S - 1])
            assert not torch.equal(tcache[k][:, :, S - 1],
                                   before[k][:, :, S - 1])
        theirs = flat_cache(jcache)
        for k, v in flat_cache(tcache).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(theirs[k]),
                                       rtol=LM_RTOL, atol=LM_ATOL, err_msg=k)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)


def test_attn_prefill_kv_matches_reference(zamba):
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    cfg = zamba.model.cfg
    p = jax.tree.map(np.asarray, zamba.params["shared"])
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), p)
    x = (np.random.default_rng(4).standard_normal((2, 32, cfg.d_model))
         * 0.5).astype(np.float32)
    positions = np.arange(32)[None, :]
    noop = lambda h, kind: h  # noqa: E731
    jk, jv = jax.jit(lambda x, p: JT.attn_prefill_kv(
        x, p, zamba.cfg, jnp.float32, noop, jnp.asarray(positions)))(
        jnp.asarray(x), p["attn"])
    tk, tv = TT.attn_prefill_kv(torch.as_tensor(x), tp["attn"], cfg,
                                torch.float32, noop, torch.as_tensor(positions))
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=LM_RTOL,
                               atol=LM_ATOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=LM_RTOL,
                               atol=LM_ATOL)
    # the hybrid's prefill takes them from _layer_prefill: the same values
    xn = TT._norm(torch.as_tensor(x), tp["ln1"], cfg)
    k2, v2 = TT.attn_prefill_kv(xn, tp["attn"], cfg, torch.float32, noop,
                                torch.as_tensor(positions))
    _, _, k3, v3 = TT._layer_prefill(
        torch.as_tensor(x), tp, cfg, kind="full", constrain=noop,
        rope=TT._rope(cfg, torch.as_tensor(positions)))
    assert torch.equal(k2, k3) and torch.equal(v2, v3)


def test_decode_matches_prefill():
    """Tokens fed one by one from ``init_cache(B, S)`` reproduce prefill's
    logits (``tests/test_models.py``'s tolerance)."""
    cfg = get_config("zamba2-2.7b").reduced()
    model = build_model(cfg, device="cpu", seed=10)
    B, S = 2, 32
    toks = torch.as_tensor(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S)))
    logits_pre, _ = model.prefill({"tokens": toks})
    cache = model.init_cache(B, S)
    for i in range(S):
        logits, cache = model.decode_step(cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits.numpy(), logits_pre.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_model_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("zamba2-2.7b").reduced())
