"""The port's Mamba2 block and ``SSMModel`` against ``repro``'s, in fp32.

The block (``models/ssm.py``) on the same numpy inputs and JAX's
parameters: ``ssm_apply`` and ``ssm_decode_step`` at the LM tolerance;
chunked prefill against the token-by-token recurrence at chunk 4, 8 and 16
(rtol 2e-4, ``tests/test_ssm_moe.py``'s); state decay; the ``S % Q``
error; a large ``dt·A``, where ``exp`` of the masked segment sums
overflows and the output and the gradient must stay finite.  The model: prefill, the cache
and 8 decode steps (``torch_parity.assert_lm_prefill_decode``), decode fed
token by token against prefill, and the reference's cast of the stacked
tree in bf16.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as JS
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import ssm as TS
from torch_parity import LM_ATOL, LM_RTOL, LMPair, assert_lm_prefill_decode

KEY = jax.random.key(0)


def _block(chunk=16, d_model=64, d_state=16, head_dim=16, **over):
    """``(jax spec, port spec, jax params, port params)``; ``over`` sets
    parameter leaves to constants."""
    kw = dict(d_model=d_model, d_state=d_state, d_conv=4, expand=2,
              head_dim=head_dim, chunk=chunk)
    jspec, tspec = JS.SSMSpec(**kw), TS.SSMSpec(**kw)
    params = JS.ssm_init(KEY, jspec, jnp.float32)
    for k, v in over.items():
        params[k] = jnp.full_like(params[k], v)
    tparams = {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
    return jspec, tspec, params, tparams


def _x(B, T, d, scale=0.5, seed=1):
    return (np.random.default_rng(seed).standard_normal((B, T, d))
            * scale).astype(np.float32)


def _close(got, want, what, rtol=LM_RTOL, atol=LM_ATOL):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol,
                               atol=atol, err_msg=what)


@pytest.mark.parametrize("chunk", [4, 8, 16])
def test_block_matches_reference_and_its_recurrence(chunk):
    jspec, tspec, params, tparams = _block(chunk)
    B, T = 2, 32
    x = _x(B, T, 64)
    jy, jc = jax.jit(lambda x, p: JS.ssm_apply(x, p, jspec, jnp.float32))(
        jnp.asarray(x), params)
    ty, tc = TS.ssm_apply(torch.as_tensor(x), tparams, tspec, torch.float32)
    _close(ty, jy, "ssm_apply y")
    for k in ("ssm", "conv"):
        _close(tc[k], jc[k], f"ssm_apply cache {k}")
    # the recurrence, step by step, against repro's and against the scan
    jstep = jax.jit(lambda x, c, p: JS.ssm_decode_step(x, c, p, jspec,
                                                        jnp.float32))
    jcache = JS.ssm_init_cache(B, jspec)
    cache = TS.ssm_init_cache(B, tspec)
    ys = []
    for t in range(T):
        jy_t, jcache = jstep(jnp.asarray(x[:, t]), jcache, params)
        y_t, new = TS.ssm_decode_step(torch.as_tensor(x[:, t]), cache,
                                      tparams, tspec, torch.float32)
        assert new is not cache and new["ssm"] is not cache["ssm"]
        cache = new
        _close(y_t, jy_t, f"decode y step {t}")
        for k in ("ssm", "conv"):
            _close(cache[k], jcache[k], f"decode cache {k} step {t}")
        ys.append(y_t)
    _close(torch.stack(ys, dim=1), ty.numpy(), "chunked vs sequential",
           rtol=2e-4, atol=2e-4)
    _close(cache["ssm"], tc["ssm"].numpy(), "final state", rtol=2e-4,
           atol=2e-4)
    _close(cache["conv"], tc["conv"].numpy(), "conv cache", rtol=1e-5,
           atol=1e-5)


def test_state_decay():
    """With zero input the SSM state decays monotonically (A < 0)."""
    _, spec, _, params = _block(8, d_model=32, d_state=8, head_dim=8)
    cache = TS.ssm_init_cache(1, spec)
    cache["ssm"] += 1.0
    _, c1 = TS.ssm_decode_step(torch.zeros((1, 32)), cache, params, spec,
                               torch.float32)
    assert bool((c1["ssm"].abs() <= cache["ssm"].abs() + 1e-6).all())


@pytest.mark.parametrize("S", [24, 40])
def test_length_off_the_chunk_raises(S):
    _, spec, _, params = _block(16)
    with pytest.raises(ValueError, match=f"S = {S} .* Q = 16"):
        TS.ssm_apply(torch.zeros((1, S, 64)), params, spec, torch.float32)


def test_large_decay_stays_finite():
    """dt ≈ 8 and A = -16: within a chunk of 16 the segment sums above the
    diagonal pass 88, ``exp`` overflows to inf there, and the select (not
    a product with a 0/1 mask, which would make NaN) must drop it."""
    jspec, tspec, params, tparams = _block(16, dt_bias=8.0,
                                           A_log=float(np.log(16.0)))
    x = _x(2, 32, 64)
    _, _, dt_raw = TS._split_proj(torch.as_tensor(x) @ tparams["in_proj"],
                                  tspec)
    la = torch.cumsum(TS._softplus(dt_raw[:, :16] + 8.0) * -16.0, dim=1)
    assert torch.isinf(torch.exp(la[:, 0] - la[:, -1])).all()
    jy, jc = jax.jit(lambda x, p: JS.ssm_apply(x, p, jspec, jnp.float32))(
        jnp.asarray(x), params)
    ty, tc = TS.ssm_apply(torch.as_tensor(x), tparams, tspec, torch.float32)
    assert bool(torch.isfinite(ty).all())
    assert bool(torch.isfinite(tc["ssm"]).all())
    assert np.isfinite(np.asarray(jy)).all()
    _close(ty, jy, "y at large dt·A")
    _close(tc["ssm"], jc["ssm"], "state at large dt·A")


def test_large_decay_grad_stays_finite():
    """The same overflow in the backward: with the select after ``exp``,
    the masked entries' gradient is 0·inf = NaN.  ``repro``'s gradient is
    NaN there (ROADMAP, queue C, C10); the port masks the segment sums
    before the ``exp``, so its gradient is finite everywhere and equals
    JAX's wherever JAX's is finite (rtol 1e-4, atol 1e-4 of the leaf's
    largest entry)."""
    jspec, tspec, params, tparams = _block(16, dt_bias=8.0,
                                           A_log=float(np.log(16.0)))
    x = _x(2, 32, 64)

    def f(p, x):
        return jnp.sum(JS.ssm_apply(x, p, jspec, jnp.float32)[0] ** 2)

    jg, jgx = jax.jit(jax.grad(f, argnums=(0, 1)))(params, jnp.asarray(x))
    assert np.isnan(np.asarray(jgx)).all()                # the defect
    assert np.isnan(np.asarray(jg["dt_bias"])).all()
    tp = {k: v.clone().requires_grad_(True) for k, v in tparams.items()}
    tx = torch.tensor(x, requires_grad=True)
    y, _ = TS.ssm_apply(tx, tp, tspec, torch.float32)
    grads = torch.autograd.grad((y ** 2).sum(), [tx, *tp.values()])
    n_finite = 0
    for name, got in zip(["x", *tp], grads):
        assert bool(torch.isfinite(got).all()), f"d{name} not finite"
        want = np.asarray(jgx if name == "x" else jg[name])
        ok = np.isfinite(want)
        n_finite += int(ok.sum())
        # rtol 1e-4, and 1e-4 of the leaf's largest entry: the gradient
        # sums many terms, so small entries carry the large ones' rounding
        scale = np.abs(want[ok]).max(initial=0.0)
        np.testing.assert_allclose(got.numpy()[ok], want[ok], rtol=LM_RTOL,
                                   atol=LM_RTOL * scale, err_msg=f"d{name}")
    assert n_finite > 0


@pytest.fixture(scope="module")
def mamba():
    return LMPair("mamba2-130m")


@pytest.mark.parametrize("S", [16, 64])
def test_prefill_and_decode_match_reference(mamba, S):
    assert_lm_prefill_decode(mamba, S=S)


def test_decode_matches_prefill():
    """Feeding tokens one by one through decode reproduces prefill's logits
    (``tests/test_models.py``'s tolerance)."""
    cfg = get_config("mamba2-130m").reduced()
    model = build_model(cfg, device="cpu", seed=10)
    B, S = 2, 64
    toks = torch.as_tensor(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S)))
    logits_pre, _ = model.prefill({"tokens": toks})
    cache = model.init_cache(B)
    for i in range(S):
        logits, cache = model.decode_step(cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits.numpy(), logits_pre.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_bf16_compute_copy_follows_the_reference_cast():
    """The stacked per-layer vectors (``A_log``, ``D``, ``dt_bias``,
    ``norm_scale``, ``conv_b``: 2-D once stacked) are cast to bf16, the
    final norm's scale is not; the SSM state stays fp32 and the conv cache
    is bf16."""
    cfg = dataclasses.replace(get_config("mamba2-130m").reduced(),
                              compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    cp = model.compute_params()
    for k in ("A_log", "D", "dt_bias", "norm_scale", "conv_b", "in_proj"):
        assert cp["layers"]["ssm"][k].dtype == torch.bfloat16, k
    assert cp["final_norm"]["scale"].dtype == torch.float32
    assert model.params["layers"]["ssm"]["A_log"].dtype == torch.float32
    logits, cache = model.prefill(
        {"tokens": torch.zeros((1, 16), dtype=torch.long)})
    assert logits.dtype == torch.float32 and bool(torch.isfinite(logits).all())
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    logits, cache = model.decode_step(cache, torch.zeros((1, 1),
                                                         dtype=torch.long), 16)
    assert logits.dtype == torch.float32 and cache["conv"].dtype == torch.bfloat16


def test_model_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("mamba2-130m").reduced())
