"""The port's training loss of gemma2 and the MoE decoders against
``repro``'s, the chunked cross-entropy, and the remat policies.

* gemma2-2b (local/global layers: the local layers' flash takes the slab
  at 128 tokens; attention and final soft-caps), mixtral-8x7b and
  arctic-480b (a dense residual branch) reduced, in fp32, on JAX's
  parameters: loss, metrics (the MoE aux losses) and every gradient leaf
  against ``jax.value_and_grad(model.loss)`` at rtol 1e-4; every leaf's
  gradient non-zero.
* ``chunked_ce`` against ``repro``'s on the same inputs, with ``-1`` pads
  and gemma2's ``final_softcap``, value and gradients.
* Remat ``none``, ``full`` and ``dots`` give the same loss and gradients
  bit for bit; ``dots`` keeps the unbatched products' outputs, so its
  backward recomputes none of them, where ``full`` recomputes all.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as jax_config
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import transformer as TT
from torch_parity import (LM_ATOL, LM_RTOL, LMPair, assert_loss_and_grads,
                          lm_train_batch)
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("arch", ["gemma2-2b", "mixtral-8x7b", "arctic-480b"])
def test_loss_and_grads_match_reference(arch):
    pair = LMPair(arch)
    batch = lm_train_batch(pair.cfg, B=2, S=128)
    grads = assert_loss_and_grads(pair, batch)
    for k, g in grads.items():
        assert bool(g.any()), f"{arch}: the gradient of {k} is zero"


@pytest.mark.parametrize("cap", [None, 30.0])
def test_chunked_ce_matches_reference(cap):
    cfg = dataclasses.replace(jax_config("gemma2-2b").reduced(),
                              final_softcap=cap, ce_chunk=16)
    rng = np.random.default_rng(3)
    B, S, d = 2, 64, cfg.d_model
    h = rng.standard_normal((B, S, d)).astype(np.float32)
    table = (rng.standard_normal((640, d)) * 0.3).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :7] = -1
    labels[1, 40:] = -1

    def jloss(h, t):
        nll, n = JT.chunked_ce(h, t, jnp.asarray(labels), cfg,
                               lambda x, k: x)
        return nll / n, n

    (jl, jn), (jgh, jgt) = jax.value_and_grad(jloss, argnums=(0, 1),
                                              has_aux=True)(h, table)
    th = torch.tensor(h, requires_grad=True)
    tt = torch.tensor(table, requires_grad=True)
    nll, n = TT.chunked_ce(th, tt, torch.as_tensor(labels), cfg, TT._noop)
    loss = nll / n
    gh, gt = torch.autograd.grad(loss, (th, tt))
    assert int(n) == int(jn) == B * S - 7 - 24
    for got, want, what in ((loss, jl, "loss"), (gh, jgh, "dh"),
                            (gt, jgt, "dtable")):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=LM_RTOL, atol=LM_ATOL, err_msg=what)
    assert not bool(gt[cfg.vocab_size:].any())      # the padded rows


class _Products(TorchDispatchMode):
    """Counts the unbatched products dispatched while active."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += TT._unbatched_product(func, args)
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mixtral-8x7b",
                                  "mamba2-130m", "zamba2-2.7b",
                                  "whisper-base"])
def test_remat_policies_agree_bitwise(arch):
    cfg = get_config(arch).reduced()
    batch = lm_train_batch(cfg, B=2, S=64)
    runs = {}
    for remat in ("none", "full", "dots"):
        model = build_model(dataclasses.replace(cfg, remat=remat),
                            device="cpu", seed=0)
        tb = {k: torch.as_tensor(v) for k, v in batch.items()}
        loss, _ = model.loss(tb)
        counter = _Products()
        with counter:
            grads = torch.autograd.grad(
                loss, list(model.trainable_leaves().values()),
                materialize_grads=True)
        runs[remat] = (loss.detach(), grads, counter.n)
    loss0, grads0, n0 = runs["none"]
    for remat in ("full", "dots"):
        loss, grads, _ = runs[remat]
        assert torch.equal(loss, loss0), remat
        for a, b in zip(grads, grads0):
            assert torch.equal(a, b), remat
    # dots recomputes no unbatched product in the backward; full does
    assert runs["dots"][2] == n0 < runs["full"][2]
