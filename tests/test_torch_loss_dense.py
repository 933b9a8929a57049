"""The port's training loss of the dense decoders against ``repro``'s.

For llama3.2-1b, qwen2.5-3b (qkv biases), h2o-danube-3-4b and
internvl2-76b (embeddings in) at their reduced widths in fp32, on JAX's
parameters carried across by the bridge: the loss, its metrics and every
gradient leaf against ``jax.value_and_grad(model.loss)`` at the LM
tolerance (rtol 1e-4), over 128 tokens (four flash q blocks), with label
pads.  Every leaf's gradient is non-zero.  gemma2-2b and the MoE
decoders are in ``test_torch_loss_moe.py``.
"""
import pytest

from torch_parity import (LMPair, assert_loss_and_grads, lm_train_batch,
                          port_loss_and_grads)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ["llama3.2-1b", "qwen2.5-3b", "h2o-danube-3-4b", "internvl2-76b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    pair = LMPair(arch)
    batch = lm_train_batch(pair.cfg, B=2, S=128)
    assert_loss_and_grads(pair, batch)
    # every leaf learns (internvl2 reads its table only for tokens in)
    batch.pop("embeddings", None)
    _, _, grads = port_loss_and_grads(pair.model, batch)
    for k, g in grads.items():
        assert bool(g.any()), f"{arch}: the gradient of {k} is zero"
        assert bool(g.isfinite().all()), f"{arch}: {k}"
