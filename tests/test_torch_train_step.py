"""The port's train step (``train/train_step.py``) against ``repro``'s.

From the same state (JAX's, carried across by ``bridge``) and the same
batches (``make_batch`` is bitwise), six steps of the port's
``train_step`` against ``jax.jit`` of ``repro``'s, with 1 and 2
microbatches: the loss, the metrics and the gradient norm each step at
rtol 1e-4, and every parameter, moment and count after (rtol 1e-4, atol
1e-6).  The step updates the module's own parameters in place; a ``par``
that is no ``Parallelism`` raises (sharded steps:
``test_torch_train_sharded.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JD
from repro.data.pipeline import make_batch as jax_make_batch
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train.train_step import init_train_state as jax_init
from repro.train.train_step import make_train_step as jax_make
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import train_step as TS
from torch_parity import flat_cache
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)


@pytest.mark.parametrize("arch,micro", [("llama3.2-1b", 1),
                                        ("llama3.2-1b", 2),
                                        ("mamba2-130m", 2)])
def test_six_steps_match_reference(arch, micro):
    jcfg = dataclasses.replace(jax_config(arch).reduced(), microbatches=micro)
    tcfg = dataclasses.replace(get_config(arch).reduced(), microbatches=micro)
    jm, jstep = jax_make(jcfg, None, JAdamW(**OPT))
    jstep = jax.jit(jstep)
    jstate = jax_init(jm, jax.random.key(0))
    model, step = TS.make_train_step(tcfg, None, AdamWConfig(**OPT),
                                     device="cpu")
    state = bridge.train_state_from_numpy(model,
                                          jax.tree.map(np.asarray, jstate))
    leaves = list(model.parameters())
    for i in range(6):
        jstate, jmet = jstep(jstate, jax_make_batch(JD(jcfg.vocab_size, 64, 4),
                                                    i))
        state, met = step(state, make_batch(DataConfig(tcfg.vocab_size, 64, 4),
                                            i, device="cpu"))
        assert set(met) == set(jmet)
        for k in jmet:
            np.testing.assert_allclose(float(met[k]), float(jmet[k]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {k}")
    assert list(model.parameters()) == leaves          # updated in place
    assert state["params"]["embed"]["table"] is model.params["embed"]["table"]
    ours = flat_cache(bridge.train_state_to_numpy(state))
    theirs = flat_cache(jax.tree.map(np.asarray, jstate))
    assert set(ours) == set(theirs)
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert int(state["step"]) == int(state["opt"]["count"]) == 6


def test_sharded_par_is_refused_and_serve_steps_read_the_module():
    cfg = get_config("llama3.2-1b").reduced()
    for make in (TS.make_train_step, TS.make_prefill_step,
                 TS.make_decode_step):
        with pytest.raises(TypeError, match="Parallelism"):
            make(cfg, object(), device="cpu")
    model, prefill = TS.make_prefill_step(cfg, device="cpu")
    _, decode = TS.make_decode_step(cfg, device="cpu")    # same seed
    toks = torch.arange(8)[None] % cfg.vocab_size
    logits, cache = prefill({"tokens": toks})
    mine = {k: v.clone() for k, v in cache.items()}
    assert torch.equal(logits, model.prefill({"tokens": toks})[0])
    assert torch.equal(decode(cache, toks[:, :1], 8)[0],
                       model.decode_step(mine, toks[:, :1], 8)[0])
    model2, step = TS.make_train_step(cfg, device="cpu")
    state = TS.init_train_state(model)
    with pytest.raises(ValueError, match="parameter tree"):
        step(state, make_batch(DataConfig(cfg.vocab_size, 32, 2), 0, "cpu"))
