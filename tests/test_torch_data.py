"""The port's data pipeline (``data/pipeline.py``) against ``repro``'s:
``make_batch`` bit for bit over several (seed, step, batch, seq, vocab),
the step and seed words past 2**31 included; tokens and labels shifted by
one; the ``Prefetcher`` yields batches in order from its start step."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import DataConfig as JD
from repro.data.pipeline import make_batch as jax_make_batch
from repro_torch.data.pipeline import DataConfig, Prefetcher, make_batch
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

CASES = [(1234, 0, 2, 8, 64), (7, 123_456, 4, 512, 50_257),
         (0, 2**31 + 5, 3, 100, 128_256), (2**32 - 1, 2**32 - 1, 2, 33, 512),
         (99, 17, 8, 2048, 51_865)]


@pytest.mark.parametrize("seed,step,B,S,V", CASES)
def test_make_batch_is_the_reference_bitwise(seed, step, B, S, V):
    want = jax_make_batch(JD(V, S, B, seed), step)
    got = make_batch(DataConfig(V, S, B, seed), step, device="cpu")
    for k in ("tokens", "labels"):
        assert got[k].shape == (B, S) and got[k].device.type == "cpu"
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["tokens"][:, 1:].numpy(),
                                  got["labels"][:, :-1].numpy())
    assert 0 <= int(got["tokens"].min()) and int(got["tokens"].max()) < V


def test_prefetcher_yields_in_order():
    dc = DataConfig(vocab_size=64, seq_len=8, global_batch=2)
    pf = Prefetcher(dc, start_step=3, depth=2, device="cpu")
    try:
        for s in range(3, 7):
            b = next(pf)
            for k in ("tokens", "labels"):
                assert torch.equal(b[k], make_batch(dc, s, device="cpu")[k])
    finally:
        pf.close()
