"""Checkpoint/restore, failure recovery, the launcher and the example of
the port (``train/checkpoint.py``, ``train/fault.py``,
``launch/train.py``, ``examples/train_lm_torch.py``).

* ``tests/test_checkpoint_fault.py``'s five cases on the port; the
  elastic case restores onto another device: a template on the ``meta``
  device with ``device="cpu"``, and a fresh module's state in place.
* The reference's file format both ways: a JAX checkpoint continues in
  the port, and a port checkpoint in JAX (the same next step, rtol 1e-4).
* ``launch.train.main`` reduced on the CPU with an injected failure, and
  ``examples/train_lm_torch.py --reduced --steps 12 --device cpu``.
* The serve path after training: a trained module's ``prefill`` logits
  equal, bit for bit, those of a fresh module loaded with the trained
  parameters.
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.data.pipeline import DataConfig as JD
from repro.data.pipeline import make_batch as jax_make_batch
from repro.optim.adamw import AdamWConfig as JAdamW
from repro.train import checkpoint as jax_ckpt
from repro.train.train_step import init_train_state as jax_init
from repro.train.train_step import make_train_step as jax_make
from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.launch import train as launch
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint
from repro_torch.train.fault import (FaultInjector, RecoveryConfig,
                                     TrainController)
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves
from torch_parity import SRC, flat_cache
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ROOT = SRC.parent
TINY = dict(n_layers=2, d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
            d_ff=64, vocab_size=128, q_block=16, k_block=16, ce_chunk=16)


def _tiny_setup(steps=30, seed=0):
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), **TINY)
    model, step = make_train_step(cfg, None, AdamWConfig(
        peak_lr=1e-3, warmup_steps=2, total_steps=steps), device="cpu",
        seed=seed)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=2)
    return model, step, init_train_state(model), \
        lambda s: make_batch(dc, s, device="cpu")


def _equal_trees(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x.cpu(), y.cpu())


def test_checkpoint_roundtrip(tmp_path):
    _, step, state, data = _tiny_setup()
    state, _ = step(state, data(0))
    saved = bridge.train_state_to_numpy(state)
    p = tmp_path / "ck"
    checkpoint.save(state, p, step=1)
    state, _ = step(state, data(1))                  # moves on in place
    restored = checkpoint.restore(p, state)
    assert restored["params"]["embed"]["table"] is \
        state["params"]["embed"]["table"]            # written into the tensors
    for k, v in flat_cache(saved).items():
        np.testing.assert_array_equal(
            flat_cache(bridge.train_state_to_numpy(restored))[k], v)


def test_latest_step(tmp_path):
    _, _, state, _ = _tiny_setup()
    assert checkpoint.latest_step(tmp_path) is None
    checkpoint.save(state, tmp_path / "step_5", step=5)
    checkpoint.save(state, tmp_path / "step_10", step=10)
    assert checkpoint.latest_step(tmp_path) == 10


def test_recovery_resumes_and_matches_uninterrupted_run(tmp_path):
    """Kill training mid-run; the recovered run equals the failure-free one
    (deterministic pipeline + checkpointed state)."""
    runs = []
    for name, inj in (("a", None), ("b", FaultInjector(fail_at_steps=(7, 12)))):
        model, step, state0, data = _tiny_setup(steps=20)
        ctl = TrainController(step, state0, data, RecoveryConfig(
            ckpt_dir=str(tmp_path / name), ckpt_every=5), injector=inj)
        runs.append((ctl, ctl.run(15), model))
    (plain, log_a, _), (fail, log_b, model) = runs
    assert fail.restarts == 2 and len(log_b) == 15 + 2 + 2
    np.testing.assert_allclose(log_a[-1]["loss"], log_b[-1]["loss"],
                               rtol=1e-5)
    assert int(plain.state["step"]) == int(fail.state["step"]) == 15
    _equal_trees(plain.state, fail.state)      # bitwise on the CPU
    assert fail.state["params"]["embed"]["table"] is \
        model.params["embed"]["table"]


def test_elastic_restore_onto_another_device(tmp_path):
    _, step, state, data = _tiny_setup()
    p = tmp_path / "ck"
    checkpoint.save(state, p, step=0)
    meta = jax.tree.map(lambda t: torch.empty_like(t, device="meta"), state)
    restored = checkpoint.restore(p, meta, device="cpu")
    _equal_trees(restored, state)
    assert restored["params"]["embed"]["table"].device.type == "cpu"
    # a fresh module (another seed) takes the checkpoint in place and trains
    model2, step2, state2, _ = _tiny_setup(seed=1)
    state2 = checkpoint.restore(p, state2)
    _equal_trees(state2, state)
    s3, _ = step2(state2, data(0))
    assert bool(torch.isfinite(s3["opt"]["m"]["embed"]["table"]).all())


def test_max_restarts_exceeded(tmp_path):
    _, step, state, data = _tiny_setup()
    ctl = TrainController(step, state, data, RecoveryConfig(
        ckpt_dir=str(tmp_path / "c"), ckpt_every=100),
        injector=FaultInjector(fail_at_steps=(1,)))
    # failure at step 1 with no checkpoint -> restarts from 0, replays the
    # lost step (log grows by one), and completes all 5 steps
    log = ctl.run(5)
    assert len(log) == 6
    assert ctl.step == 5 and ctl.restarts == 1


def _pair():
    """(jax cfg, jax step, jax state after 1 step, port model, step, state
    from the same start), and the data of step i for each."""
    jcfg = dataclasses.replace(jax_config("llama3.2-1b").reduced(), **TINY)
    tcfg = dataclasses.replace(get_config("llama3.2-1b").reduced(), **TINY)
    opt = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jm, jstep = jax_make(jcfg, None, JAdamW(**opt))
    jstep = jax.jit(jstep)
    jstate = jax_init(jm, jax.random.key(0))
    model, step = make_train_step(tcfg, None, AdamWConfig(**opt),
                                  device="cpu", seed=5)
    return (jstep, jstate, model, step,
            lambda i: jax_make_batch(JD(128, 32, 2), i),
            lambda i: make_batch(DataConfig(128, 32, 2), i, device="cpu"))


def test_checkpoints_cross_between_jax_and_the_port(tmp_path):
    jstep, jstate, model, step, jdata, tdata = _pair()
    jstate, _ = jstep(jstate, jdata(0))
    jax_ckpt.save(jstate, tmp_path / "jax", step=1)
    state = checkpoint.restore(tmp_path / "jax", init_train_state(model))
    theirs = flat_cache(jax.tree.map(np.asarray, jstate))
    for k, v in flat_cache(bridge.train_state_to_numpy(state)).items():
        np.testing.assert_array_equal(v, theirs[k], err_msg=k)
    # the port continues JAX's run ...
    jstate, jmet = jstep(jstate, jdata(1))
    state, met = step(state, tdata(1))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-4)
    # ... and JAX the port's
    checkpoint.save(state, tmp_path / "port", step=2)
    back = jax_ckpt.restore(tmp_path / "port", jstate)
    ours = flat_cache(bridge.train_state_to_numpy(state))
    for k, v in flat_cache(jax.tree.map(np.asarray, back)).items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)
    _, jmet = jstep(back, jdata(2))
    _, met = step(state, tdata(2))
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-4)


def test_launch_train_reduced_on_the_cpu(tmp_path, capsys):
    log = launch.main(["--arch", "llama3.2-1b", "--reduced", "--steps", "10",
                       "--batch", "2", "--seq", "32", "--ckpt-every", "4",
                       "--fail-at", "6", "--device", "cpu",
                       "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("arch=llama3.2-1b params=") and \
        out[0].endswith("devices=1 (cpu)")
    assert out[1].startswith("steps=12 restarts=1 ")
    assert len(log) == 12 and all(np.isfinite(m["loss"]) for m in log)
    assert checkpoint.latest_step(tmp_path) == 8
    if not torch.cuda.is_available():        # the GPU by default
        with pytest.raises(RuntimeError, match="device='cpu'"):
            launch.main(["--reduced", "--steps", "1"])


def test_example_reduced_on_the_cpu(tmp_path):
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "train_lm_torch.py"),
         "--reduced", "--steps", "12", "--device", "cpu", "--ckpt-dir",
         str(tmp_path / "ck")],
        env=dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1"),
        cwd=tmp_path,
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.splitlines()
    assert lines[0].startswith("arch=mamba2-130m")
    assert lines[1].startswith("steps=12 restarts=0")
    # a checkpoint every 100 steps: none in 12, and nothing in the cwd
    assert list(tmp_path.iterdir()) == []


@pytest.mark.parametrize("arch", ["llama3.2-1b", "mamba2-130m"])
def test_serve_after_training_reads_the_trained_parameters(arch):
    cfg = get_config(arch).reduced()
    model, step = make_train_step(cfg, None, AdamWConfig(
        peak_lr=1e-2, warmup_steps=1, total_steps=5), device="cpu")
    toks = {"tokens": torch.arange(32)[None] % cfg.vocab_size}
    before, _ = model.prefill(toks)              # the kept serve copy
    state = init_train_state(model)
    for i in range(3):
        state, _ = step(state, make_batch(DataConfig(cfg.vocab_size, 32, 2),
                                          i, device="cpu"))
    after, cache = model.prefill(toks)
    fresh = build_model(cfg, device="cpu", seed=7)
    bridge.lm_params_from_numpy(fresh, bridge.lm_params_to_numpy(model))
    want, want_cache = fresh.prefill(toks)
    assert not torch.equal(after, before)
    assert torch.equal(after, want)
    for k, v in flat_cache(cache).items():
        assert torch.equal(v, flat_cache(want_cache)[k])
