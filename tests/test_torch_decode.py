"""The port's η decode, exhaustively over all 2**24 inputs.

The port's rule is ``eta = fp32(-log(fp64(fp32(u + 2**-25))))``
(``repro_torch.core.horizon``).  It equals numpy's fp64 ``log`` rounded to
fp32 on every input.  JAX's fp32 ``log`` differs from it by exactly one
ulp on 2,376,976 of the 2**24 inputs and agrees on the rest; the parity
tests therefore inject JAX's η (``horizon.eta_override``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import horizon as jh
from repro_torch.core import horizon as th

from torch_parity import jax_eta_table

K = np.arange(1 << 24, dtype=np.uint32)


def _port_eta() -> np.ndarray:
    return th.decode_eta(torch.as_tensor(K.astype(np.int64) << 8)).numpy()


def test_port_eta_is_fp64_log_rounded_to_fp32():
    x = K.astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)
    want = (-np.log(x.astype(np.float64))).astype(np.float32)
    np.testing.assert_array_equal(_port_eta(), want)


def test_port_eta_within_one_ulp_of_jax():
    port, ref = _port_eta(), jax_eta_table()
    ulps = np.abs(port.view(np.int32).astype(np.int64)
                  - ref.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert int((ulps != 0).sum()) == 2_376_976


@pytest.mark.parametrize("n_v", [1, 2, 10])
def test_site_picks_match_reference(n_v):
    rng = np.random.default_rng(n_v)
    w0 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    w1 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64).astype(np.uint32)
    jl, jr, _ = jh.decode_words(jnp.asarray(w0), jnp.asarray(w1), n_v,
                                jnp.float32)
    tl, tr, _ = th.decode_words(torch.as_tensor(w0.astype(np.int64)),
                                torch.as_tensor(w1.astype(np.int64)), n_v,
                                torch.float32)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


def test_eta_override_reads_the_table_and_restores():
    table = jax_eta_table()
    w1 = torch.as_tensor(np.array([0, 1 << 8, 0xFFFFFFFF], np.int64))
    plain = th.decode_eta(w1)
    with th.eta_override(table):
        assert th.eta_override_active()
        got = th.decode_eta(w1)
    assert not th.eta_override_active()
    np.testing.assert_array_equal(got.numpy(), table[[0, 1, (1 << 24) - 1]])
    assert torch.equal(th.decode_eta(w1), plain)
    with pytest.raises(ValueError):
        with th.eta_override(np.zeros(8, np.float32)):
            pass
