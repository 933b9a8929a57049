"""The port's threefry stream (``core/prng.py``) against ``jax.random``.

Every word is compared bit for bit: the Random123 known-answer vectors,
``threefry2x32`` on random inputs (high counter words included), the key
data of ``key``, ``split`` and ``fold_in``, and ``random_bits`` /
``horizon.event_bits`` / the generator's plain version
(``kernels.threefry``) against ``jax.random.bits`` for seeds
{0, 7, -3, 2**31 - 1}, steps {0, 5, 2**31 - 1} and shapes with odd L.
"""
import jax
import jax.extend.random as jxr
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import horizon as jh
from repro_torch import bridge
from repro_torch.core import horizon as th
from repro_torch.core import prng
from repro_torch.kernels import threefry

SEEDS = (0, 7, -3, 2**31 - 1)
STEPS = (0, 5, 2**31 - 1)
SHAPES = ((3, 7), (2, 16), (1, 5))

#: Random123's known-answer vectors for threefry2x32 (20 rounds):
#: (k0, k1, x0, x1) -> (y0, y1).
KAT = [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def _data(k) -> np.ndarray:
    """A JAX key's data as int64 numpy."""
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


def test_jax_default_is_partitionable_threefry():
    """The port follows this layout; a change of JAX's default fails here."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.config.jax_default_prng_impl == "threefry2x32"


@pytest.mark.parametrize("inputs,want", KAT)
def test_known_answer_vectors(inputs, want):
    y0, y1 = prng.threefry2x32(*(torch.tensor(v) for v in inputs))
    assert (int(y0), int(y1)) == want


def test_threefry_matches_jax_on_random_inputs():
    rng = np.random.default_rng(0)
    k = rng.integers(0, 1 << 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 1 << 32, (2, 64), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jxr.threefry_2x32(jnp.asarray(k),
                                        jnp.asarray(x.reshape(-1))))
    y0, y1 = prng.threefry2x32(*(torch.as_tensor(v.astype(np.int64))
                                 for v in (k[0], k[1], x[0], x[1])))
    np.testing.assert_array_equal(np.concatenate([y0.numpy(), y1.numpy()]),
                                  want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_and_fold_in_match_jax(seed):
    jk, tk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(prng.key_data(tk).numpy(), _data(jk))
    for j, t in zip(jax.random.split(jk), prng.split(tk)):
        np.testing.assert_array_equal(t.numpy(), _data(j))
    for step in STEPS:
        np.testing.assert_array_equal(prng.fold_in(tk, step).numpy(),
                                      _data(jax.random.fold_in(jk, step)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("step", STEPS)
def test_random_bits_match_jax(seed, step):
    jk = jax.random.fold_in(jax.random.key(seed), step)
    tk = prng.fold_in(prng.key(seed), step)
    for shape in SHAPES:
        want = np.asarray(jax.random.bits(jk, shape + (2,), jnp.uint32))
        got = prng.random_bits(tk, shape + (2,))
        assert got.dtype == torch.int64 and tuple(got.shape) == want.shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_event_bits_and_generator_plain_version_match_jax(seed):
    """``horizon.event_bits`` and the generator's words on the CPU."""
    jk, tk = jax.random.key(seed), prng.key(seed)
    launches = threefry.launches
    B, L, K = 3, 7, 4
    step0 = 2**31 - 2            # the steps pass the int32 boundary
    want = np.stack([np.asarray(jh.event_bits(jk, jnp.uint32(step0 + i),
                                              (B, L)))
                     for i in range(K)])
    words = threefry.threefry_bits(tk, step0, K, (B, L))
    assert words.dtype == torch.int32 and tuple(words.shape) == want.shape
    np.testing.assert_array_equal(words.numpy().view(np.uint32), want)
    for i in range(K):
        bits = th.event_bits(tk, step0 + i, (B, L))
        assert bits.dtype == torch.int64
        np.testing.assert_array_equal(bits.numpy(), want[i].astype(np.int64))
    # into a caller's buffer: the same words, and the buffer is returned
    buf = torch.empty((K, B, L, 2), dtype=torch.int32)
    assert threefry.threefry_bits(tk, step0, K, (B, L), out=buf) is buf
    assert torch.equal(buf, words)
    assert threefry.launches == launches   # the CPU never launches it


def test_generator_validates_its_arguments():
    k = prng.key(0)
    with pytest.raises(ValueError, match="out must be"):
        threefry.threefry_bits(k, 0, 2, (2, 3),
                               out=torch.empty((2, 2, 3, 2),
                                               dtype=torch.int64))
    with pytest.raises(ValueError, match="n_steps"):
        threefry.threefry_bits(k, 0, 0, (2, 3))
    with pytest.raises(ValueError, match="key"):
        threefry.threefry_bits(torch.zeros(3, dtype=torch.int64), 0, 1,
                               (2, 3))


def test_key_from_numpy_continues_a_jax_stream():
    jk = jax.random.split(jax.random.key(11))[1]
    tk = bridge.key_from_numpy(np.asarray(jax.random.key_data(jk)),
                               device="cpu")
    want = np.asarray(jax.random.bits(jax.random.fold_in(jk, 3), (5, 2),
                                      jnp.uint32))
    np.testing.assert_array_equal(
        prng.random_bits(prng.fold_in(tk, 3), (5, 2)).numpy(),
        want.astype(np.int64))
    with pytest.raises(ValueError, match="two integer words"):
        bridge.key_from_numpy(np.zeros(3, np.uint32), device="cpu")
