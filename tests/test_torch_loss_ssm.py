"""The port's training loss of the ssm, hybrid and encdec families against
``repro``'s.

mamba2-130m, zamba2-2.7b (its shared attention block applied once a
group) and whisper-base (frame embeddings into the encoder, cross
attention in every decoder layer) at their reduced widths in fp32, on
JAX's parameters carried across by the bridge: the loss, its metrics and
every gradient leaf against ``jax.value_and_grad(model.loss)`` at the LM
tolerance (rtol 1e-4), over 64 tokens (four SSM chunks, two flash q
blocks), with label pads; every leaf's gradient non-zero and finite.
"""
import pytest

from torch_parity import LMPair, assert_loss_and_grads, lm_train_batch
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ["mamba2-130m", "zamba2-2.7b",
                                  "whisper-base"])
def test_loss_and_grads_match_reference(arch):
    pair = LMPair(arch)
    grads = assert_loss_and_grads(pair, lm_train_batch(pair.cfg, B=2, S=64))
    for k, g in grads.items():
        assert bool(g.any()), f"{arch}: the gradient of {k} is zero"
        assert bool(g.isfinite().all()), f"{arch}: {k}"
