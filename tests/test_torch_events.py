"""Port of the counter event stream: bitwise equal to ``repro.core.events``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import events as jev
from repro_torch.core import events as tev

B, L = 64, 1024


def _b0(kind):
    if kind == "scalar":
        return 37
    if kind == "vector":
        return np.arange(B, dtype=np.int32) * 3 + 5
    # the service's pad rows: -1 - r, wrapped mod 2**32
    return np.concatenate([np.arange(B - 16, dtype=np.int32),
                           -1 - np.arange(16, dtype=np.int32)])


@pytest.mark.parametrize("kind", ["scalar", "vector", "negative"])
def test_counter_bits_block_matches_reference(kind):
    b0 = _b0(kind)
    ref = jev.counter_bits_block(
        11, jnp.int32(29), jnp.asarray(b0) if kind != "scalar" else b0,
        jnp.int32(3), B, L)
    port = tev.counter_bits_block(
        11, 29, torch.as_tensor(b0) if kind != "scalar" else b0, 3, B, L)
    assert port.shape == (B, L, 2)
    np.testing.assert_array_equal(port.numpy().astype(np.uint32),
                                  np.asarray(ref))


def test_counter_words_match_reference():
    bi = np.arange(B, dtype=np.uint32)[:, None] * np.uint32(2654435761)
    li = np.arange(L, dtype=np.uint32)[None, :]
    w0, w1 = jev.counter_words(jnp.uint32(0xFFFFFFFF), jnp.uint32(1 << 31),
                               jnp.asarray(bi), jnp.asarray(li))
    t0, t1 = tev.counter_words(tev.as_u32(0xFFFFFFFF), tev.as_u32(1 << 31),
                               tev.as_u32(bi), tev.as_u32(li))
    np.testing.assert_array_equal(t0.numpy().astype(np.uint32), np.asarray(w0))
    np.testing.assert_array_equal(t1.numpy().astype(np.uint32), np.asarray(w1))


def test_vector_b0_equals_scalar_form():
    a = tev.counter_bits_block(2, 9, 100, 0, 8, 64)
    b = tev.counter_bits_block(2, 9, torch.arange(100, 108), 0, 8, 64)
    assert torch.equal(a, b)


def test_int64_multiply_wraps_to_exact_low_bits():
    """The emulation masks int64 products whose true value exceeds 2**63."""
    a = np.array([0xFFFFFFFF, 0xDEADBEEF, 0x80000001, 12345], np.int64)
    for c in (tev._C1, tev._C2, tev._PE_C, tev._TRIAL_C):
        got = (torch.as_tensor(a) * c) & tev.MASK32
        want = [(int(x) * c) & 0xFFFFFFFF for x in a]
        assert got.tolist() == want


def test_as_u32_wraps_negative_and_rejects_floats():
    assert tev.as_u32([-1, -2, 0]).tolist() == [0xFFFFFFFF, 0xFFFFFFFE, 0]
    with pytest.raises(TypeError):
        tev.as_u32(torch.zeros(2))
