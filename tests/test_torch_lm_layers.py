"""The port's LM layers, attention paths, flash forward and config registry
against ``repro``'s, on the same numpy inputs from a seed, in fp32.

Tolerances: the layers atol = rtol = 1e-6 (a few fp32 ops in the same
order); the attention paths and flash rtol = 1e-5, atol = 1e-6 (fp32 tile
sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models.flash import _fwd as jax_flash_fwd
from repro_torch import configs as tconfigs
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models.flash import flash_forward

LAYER_TOL = dict(rtol=1e-6, atol=1e-6)
ATTN_TOL = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.as_tensor(a)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norms(norm):
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 8, 64, scale=3.0)
    p = {"scale": _rand(rng, 64, scale=0.1)}
    if norm == "layernorm":
        p["bias"] = _rand(rng, 64, scale=0.1)
    out_j = getattr(JL, norm)(jnp.asarray(x), jax.tree.map(jnp.asarray, p),
                              1e-5)
    out_t = getattr(TL, norm)(torch.as_tensor(x),
                              {k: torch.as_tensor(v) for k, v in p.items()},
                              1e-5)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **LAYER_TOL)


@pytest.mark.parametrize("theta", [10_000.0, 500_000.0])
def test_rope_rotates_split_halves(theta):
    rng = np.random.default_rng(2)
    x = _rand(rng, 2, 64, 4, 16)
    pos = np.arange(64)[None, :]
    np.testing.assert_allclose(_np(TL.rope_freqs(16, theta)),
                               _np(JL.rope_freqs(16, theta)), **LAYER_TOL)
    out_j = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    out_t = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), theta)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **LAYER_TOL)


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", True),
                                       ("gelu", False), ("relu", True)])
def test_mlp(act, gated):
    rng = np.random.default_rng(3)
    x = _rand(rng, 2, 8, 64)
    p = {"wi": _rand(rng, 64, 128, scale=0.125),
         "wo": _rand(rng, 128, 64, scale=0.09)}
    if gated:
        p["wg"] = _rand(rng, 64, 128, scale=0.125)
    else:
        p["bi"], p["bo"] = _rand(rng, 128, scale=0.1), _rand(rng, 64, scale=0.1)
    out_j = JL.mlp(jnp.asarray(x), jax.tree.map(jnp.asarray, p), act,
                   jnp.float32)
    out_t = TL.mlp(torch.as_tensor(x),
                   {k: torch.as_tensor(v) for k, v in p.items()}, act,
                   torch.float32)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **LAYER_TOL)


@pytest.mark.parametrize("scale", [False, True])
def test_embed_lookup(scale):
    rng = np.random.default_rng(4)
    table = _rand(rng, 512, 64, scale=0.02)
    toks = rng.integers(0, 500, (2, 16)).astype(np.int32)
    out_j = JL.embed_lookup({"table": jnp.asarray(table)}, jnp.asarray(toks),
                            jnp.float32, scale_by_sqrt_d=scale)
    out_t = TL.embed_lookup({"table": torch.as_tensor(table)},
                            torch.as_tensor(toks), torch.float32,
                            scale_by_sqrt_d=scale)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **LAYER_TOL)


def test_embed_scale_rounds_in_bf16():
    """In bf16 the sqrt(d) factor is a bf16 constant, as in the reference."""
    rng = np.random.default_rng(5)
    table = _rand(rng, 256, 2304, scale=0.02)
    toks = np.array([[1, 7, 255]], np.int32)
    out_j = JL.embed_lookup({"table": jnp.asarray(table)}, jnp.asarray(toks),
                            jnp.bfloat16, scale_by_sqrt_d=True)
    out_t = TL.embed_lookup({"table": torch.as_tensor(table)},
                            torch.as_tensor(toks), torch.bfloat16,
                            scale_by_sqrt_d=True)
    np.testing.assert_array_equal(_np(out_t.float()),
                                  np.asarray(out_j.astype(jnp.float32)))


def test_small_layers():
    rng = np.random.default_rng(6)
    x = _rand(rng, 4, 32, scale=40.0)
    np.testing.assert_allclose(_np(TL.softcap(torch.as_tensor(x), 30.0)),
                               _np(JL.softcap(jnp.asarray(x), 30.0)),
                               **LAYER_TOL)
    np.testing.assert_allclose(_np(TL.sinusoidal_positions(64, 32)),
                               _np(JL.sinusoidal_positions(64, 32)),
                               **LAYER_TOL)
    assert [TL.pad_vocab(v) for v in (512, 50280, 128256)] == \
        [JL.pad_vocab(v) for v in (512, 50280, 128256)]


def test_init_draws_the_reference_distributions():
    """Not JAX's bits: the shapes, dtypes and scales of its distributions."""
    gen = torch.Generator().manual_seed(0)
    w = TL.dense_init(gen, 256, (8, 32), torch.float32)
    assert w.shape == (256, 8, 32)
    assert abs(float(w.std()) - 256 ** -0.5) < 0.1 * 256 ** -0.5
    emb = TL.embed_init(gen, 1000, 64, torch.bfloat16)["table"]
    assert emb.shape == (1024, 64) and emb.dtype == torch.bfloat16
    assert abs(float(emb.float().std()) - 0.02) < 0.002
    assert float(TL.rmsnorm_init(64, torch.float32)["scale"].abs().sum()) == 0


# ---------------------------------------------------------------------------
# attention paths and flash forward
# ---------------------------------------------------------------------------


def _qkv(S=96, Sk=None, H=8, KH=4, D=16, seed=7):
    rng = np.random.default_rng(seed)
    Sk = Sk or S
    return (_rand(rng, 2, S, H, D), _rand(rng, 2, Sk, KH, D),
            _rand(rng, 2, Sk, KH, D))


def _run(fn_j, fn_t, arrays, **kw):
    out_j = fn_j(*(jnp.asarray(a) for a in arrays), **kw)
    out_t = fn_t(*(torch.as_tensor(a) for a in arrays), **kw)
    return out_t, out_j


BLOCK_CASES = [("causal", {}), ("bidir", dict(causal=False)),
               ("window", dict(window=24)), ("softcap", dict(softcap=20.0)),
               ("offset", dict(q_offset=32))]


@pytest.mark.parametrize("name,kw", BLOCK_CASES, ids=[c[0] for c in BLOCK_CASES])
def test_blockwise(name, kw):
    arrays = _qkv()
    out_t, out_j = _run(JA.blockwise_attention, TA.blockwise_attention,
                        arrays, q_block=32, k_block=32, **kw)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)


@pytest.mark.parametrize("softcap", [None, 20.0])
def test_packed(softcap):
    out_t, out_j = _run(JA.packed_causal_attention, TA.packed_causal_attention,
                        _qkv(), softcap=softcap, q_block=32, k_block=32)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)


@pytest.mark.parametrize("q_offset", [0, 16])
def test_swa(q_offset):
    out_t, out_j = _run(JA.swa_attention, TA.swa_attention, _qkv(S=128),
                        window=24, q_block=32, q_offset=q_offset)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)


@pytest.mark.parametrize("window,softcap,pos", [
    (None, None, 40), (None, 30.0, 64), (16, None, 50), (16, None, 5)])
def test_decode_attention(window, softcap, pos):
    q, k, v = _qkv(S=64)
    out_t, out_j = _run(JA.decode_attention, TA.decode_attention,
                        (q[:, :1], k, v), pos=pos, window=window,
                        softcap=softcap)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)


def test_decode_attention_per_row_positions():
    q, k, v = _qkv(S=64)
    pos = np.array([10, 63], np.int32)
    out_j = JA.decode_attention(*(jnp.asarray(a) for a in (q[:, :1], k, v)),
                                jnp.asarray(pos), window=16)
    out_t = TA.decode_attention(*(torch.as_tensor(a) for a in (q[:, :1], k, v)),
                                torch.as_tensor(pos), window=16)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)


@pytest.mark.parametrize("impl,kw", [
    ("blockwise", {}), ("packed", {}), ("swa", dict(window=24)),
    ("blockwise", dict(window=40)), ("blockwise", dict(causal=False))])
def test_attention_dispatch(impl, kw):
    out_t, out_j = _run(JA.attention, TA.attention, _qkv(S=128), impl=impl,
                        q_block=32, k_block=32, **kw)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)


#: (name, q length, kv length, kv heads, causal, window, softcap, q_offset)
FLASH_CASES = [
    ("causal", 96, 96, 4, True, None, None, 0),
    ("bidir", 96, 96, 4, False, None, None, 0),
    ("slab", 96, 96, 4, True, 32, None, 0),        # Sk > window + q_block
    ("window-no-slab", 64, 64, 4, True, 32, None, 0),
    ("softcap", 96, 96, 4, True, None, 20.0, 0),
    ("gqa-4x", 64, 64, 2, True, None, None, 0),
    ("mha", 64, 64, 8, True, None, None, 0),
    ("q-offset", 32, 96, 4, True, None, None, 64),
    ("q-offset-slab", 32, 128, 4, True, 32, 20.0, 96),
    ("one-block", 24, 24, 4, True, None, None, 0),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_forward(case):
    _, S, Sk, KH, causal, window, softcap, q_offset = case
    q, k, v = _qkv(S=S, Sk=Sk, KH=KH)
    out_j, (_, _, _, _, lse_j) = jax_flash_fwd(
        *(jnp.asarray(a) for a in (q, k, v)), causal, window, softcap, 32, 32,
        q_offset)
    out_t, lse_t = flash_forward(*(torch.as_tensor(a) for a in (q, k, v)),
                                 causal, window, softcap, 32, 32, q_offset)
    np.testing.assert_allclose(_np(out_t), _np(out_j), **ATTN_TOL)
    np.testing.assert_allclose(_np(lse_t), _np(lse_j), **ATTN_TOL)


def test_flash_rejects_a_ragged_q_length():
    q, k, v = (torch.as_tensor(a) for a in _qkv(S=48))
    with pytest.raises(ValueError, match="q_block = 32"):
        flash_forward(q, k, v, True, None, None, 32, 32, 0)


# ---------------------------------------------------------------------------
# the config registry
# ---------------------------------------------------------------------------


def _fields(cfg):
    """Every field of a config, specs as plain tuples."""
    return {f.name: (tuple(v) if isinstance(v := getattr(cfg, f.name), tuple)
                     else v) for f in dataclasses.fields(cfg)}


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_equals_reference(arch):
    for reduce in (False, True):
        j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
        if reduce:
            j, t = j.reduced(), t.reduced()
        assert _fields(t) == _fields(j), (arch, reduce)
        assert t.n_params() == j.n_params()
        assert t.n_active_params() == j.n_active_params()
        assert (t.group_size, t.n_groups) == (j.group_size, j.n_groups)


def test_registry_shapes_and_skips():
    assert tconfigs.ARCH_IDS == jconfigs.ARCH_IDS
    assert tconfigs.LONG_CONTEXT_SKIPS == jconfigs.LONG_CONTEXT_SKIPS
    for name, shape in jconfigs.SHAPES.items():
        t = tconfigs.get_shape(name)
        assert dataclasses.asdict(t) == dataclasses.asdict(shape)
        assert dataclasses.asdict(t.reduced()) == \
            dataclasses.asdict(shape.reduced())
    for a in jconfigs.ARCH_IDS:
        for s in jconfigs.SHAPES:
            assert tconfigs.cell_is_runnable(a, s) == \
                jconfigs.cell_is_runnable(a, s)
    with pytest.raises(KeyError):
        tconfigs.get_config("nonexistent")
