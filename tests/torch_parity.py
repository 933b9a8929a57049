"""Helpers shared by the tests that hold ``repro_torch`` against ``repro``.

Imported by ``tests/test_torch_*.py`` (pytest puts this directory on the
path); not a test module itself.
"""
import functools
import json
import math
import os
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

#: moments (and the StepStats built from them) that must agree bit for bit;
#: the sums agree only to rounding, because the reduction order differs.
EXACT_MOMENTS = ("ucount", "min", "max")
EXACT_STATS = ("utilization", "gvt")
RTOL = 1e-5
#: wall-clock metric series: never compared between runs
WALL_SERIES = {"repro_service_phase_seconds", "repro_daemon_phase_seconds"}


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One torch thread for each test of a module that imports this
    fixture: its models are small, Python sets the pace, and the suite's
    workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.cache
def jax_eta_table() -> np.ndarray:
    """JAX's η for all ``2**24`` decode inputs ``k << 8`` (64 MiB of fp32).

    Built under ``jax.jit``, as the reference's kernel bodies are compiled;
    returned writable, so ``torch.as_tensor`` shares it without a copy.
    """
    import jax
    import jax.numpy as jnp
    from repro.core.horizon import decode_words
    w1 = np.arange(1 << 24, dtype=np.uint32) << 8
    fn = jax.jit(lambda w: decode_words(jnp.zeros_like(w), w, 1,
                                        jnp.float32)[2])
    return np.array(fn(jnp.asarray(w1)))


def np_of(x) -> np.ndarray:
    """A JAX array, torch tensor or numpy array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_moments(port: dict, ref: dict, msg="") -> None:
    """Kernel moment dicts: exact keys bitwise, sums to ``RTOL``."""
    assert set(port) == set(ref), (list(port), list(ref))
    for k in ref:
        a, b = np_of(port[k]), np_of(ref[k])
        if k in EXACT_MOMENTS:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}{k}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-6,
                                       err_msg=f"{msg}{k}")


def assert_stats(port, ref, msg="") -> None:
    """StepStats: utilization and gvt bitwise, the rest to ``RTOL``."""
    for f in ref._fields:
        a, b = np_of(getattr(port, f)), np_of(getattr(ref, f))
        if f in EXACT_STATS:
            np.testing.assert_array_equal(a, b, err_msg=f"{msg}{f}")
        else:
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=1e-5,
                                       err_msg=f"{msg}{f}")


def run_ranks(script: str, world: int, workdir, *, env=None,
              timeout: float = 240.0) -> None:
    """Run ``script`` as ``world`` ranks of one gloo group, and wait.

    Each rank is ``python -c script`` with ``RANK``, ``WORLD_SIZE`` and
    ``STORE`` (a ``file://`` rendezvous path in ``workdir``) set, one thread
    of torch each, output in ``workdir/rank<r>.log``.  Every rank gets the
    same ``timeout``-second deadline: past it, all are killed and the call
    fails, so a hang fails the test instead of the suite's time limit.
    """
    workdir = pathlib.Path(workdir)
    base = dict(os.environ, PYTHONPATH=str(SRC), WORLD_SIZE=str(world),
                STORE=str(workdir / "store"), OMP_NUM_THREADS="1",
                **(env or {}))
    procs, logs = [], []
    try:
        for r in range(world):
            log = open(workdir / f"rank{r}.log", "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script], env=dict(base, RANK=str(r)),
                stdout=log, stderr=subprocess.STDOUT, cwd=workdir))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        tails = "\n".join(
            f"--- rank {r} (exit {rc}):\n"
            + (workdir / f"rank{r}.log").read_text()[-2000:]
            for r, rc in bad[:2])
        raise AssertionError(f"ranks failed or passed the {timeout:.0f} s "
                             f"deadline: {bad}\n{tails}")


def _series(snap) -> dict:
    """Metric series of a snapshot by (name, labels)."""
    return {(s["name"], json.dumps(s["labels"], sort_keys=True)): s
            for s in snap["series"]}


def assert_service_snapshot_matches(port_snap, ref_snap) -> None:
    """Hold the port's service metrics snapshot to ``repro``'s.

    Names, kinds, help, units and labels equal; counters and gauges equal;
    histogram buckets and counts equal; the sums of ``repro_pass_u``,
    ``repro_pass_gvt_rate`` and ``repro_pass_rows`` bitwise (utilization and
    GVT are), of ``repro_pass_w2`` and ``repro_pass_window_occupancy`` to
    ``RTOL``; wall-clock series left out.
    """
    port, ref = _series(port_snap), _series(ref_snap)
    assert port.keys() == ref.keys()
    for key, r in ref.items():
        p = port[key]
        assert {k: p[k] for k in ("type", "help", "unit", "labels")} == \
            {k: r[k] for k in ("type", "help", "unit", "labels")}, key
        name = key[0]
        if name in WALL_SERIES:
            continue
        if r["type"] != "histogram":
            assert p["value"] == r["value"], key
            continue
        assert (p["buckets"], p["count"]) == (r["buckets"], r["count"]), key
        if name in ("repro_pass_w2", "repro_pass_window_occupancy"):
            assert math.isclose(p["sum"], r["sum"], rel_tol=RTOL), key
        else:       # u, the GVT rate and the row counts: bitwise
            assert (p["counts"], p["sum"]) == (r["counts"], r["sum"]), key


#: Tolerance of the language-model parity tests in fp32 (the reduced
#: configs): logits and caches of whole models, summed in another order.
LM_RTOL, LM_ATOL = 1e-4, 1e-5


def lm_pair(arch: str, seed: int = 0):
    """``(jax model, jax params, port model)`` of ``arch``'s reduced config,
    the port's on the CPU with JAX's weights carried across by the bridge."""
    import jax
    from repro.configs import get_config as jax_config
    from repro.models import build_model as jax_build
    from repro_torch import bridge
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    jm = jax_build(jax_config(arch).reduced())
    params = jm.init(jax.random.key(seed))
    model = build_model(get_config(arch).reduced(), device="cpu")
    bridge.lm_params_from_numpy(model, jax.tree.map(np.asarray, params))
    return jm, params, model


class LMPair:
    """``lm_pair(arch)`` with ``repro``'s ``prefill`` and ``decode_step``
    jitted once, so that a test module can share one (a fixture)."""

    def __init__(self, arch: str, seed: int = 0):
        import jax
        self.jm, self.params, self.model = lm_pair(arch, seed)
        self.cfg = self.jm.cfg
        static = ("max_decode_len",) if self.cfg.family == "encdec" else ()
        self.prefill = jax.jit(self.jm.prefill, static_argnames=static)
        self.decode = jax.jit(self.jm.decode_step)


def flat_cache(cache, prefix="") -> dict:
    """``{"a/b": leaf}`` of a (nested) cache."""
    out = {}
    for k, v in cache.items():
        if isinstance(v, dict):
            out.update(flat_cache(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def assert_lm_prefill_decode(arch, S=64, B=2, steps=8, *, pos0=None,
                             max_decode_len=16):
    """Hold the port's prefill logits and cache (every leaf of a nested
    one), and ``steps`` decode steps' logits and caches, to ``repro``'s;
    tokens fed back are JAX's argmax.

    ``arch`` is an arch id or an ``LMPair``.  Decode runs at positions
    ``pos0``, ``pos0 + 1``, ...: by default S (after the prompt), or 0 for
    an encoder-decoder, whose batch is S frame embeddings and whose
    decoder cache has ``max_decode_len`` slots.
    """
    import jax.numpy as jnp

    pair = LMPair(arch) if isinstance(arch, str) else arch
    cfg, params, model = pair.cfg, pair.params, pair.model
    rng = np.random.default_rng(11)
    kw = {}
    if cfg.family == "encdec":
        batch = {"enc_embeddings": (rng.standard_normal((B, S, cfg.d_model))
                                    * 0.1).astype(np.float32)}
        kw["max_decode_len"] = max_decode_len
        start = 0 if pos0 is None else pos0
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        if cfg.input_mode == "embeddings":
            batch["embeddings"] = (rng.standard_normal((B, S, cfg.d_model))
                                   * 0.1).astype(np.float32)
        start = S if pos0 is None else pos0
    jl, jcache = pair.prefill(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, **kw)
    tl, tcache = model.prefill({k: torch.as_tensor(v) for k, v in
                                batch.items()}, **kw)

    def check(what):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=f"{what} logits")
        theirs, ours = flat_cache(jcache), flat_cache(tcache)
        assert set(ours) == set(theirs)
        for k in theirs:
            np.testing.assert_allclose(ours[k].numpy(), np.asarray(theirs[k]),
                                       rtol=LM_RTOL, atol=LM_ATOL,
                                       err_msg=f"{what} cache {k}")

    check("prefill")
    for i in range(steps):
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jcache = pair.decode(params, jcache, jnp.asarray(tok),
                                 jnp.int32(start + i))
        tl, tcache = model.decode_step(tcache, torch.as_tensor(tok), start + i)
        check(f"decode step {i}")


def lm_train_batch(cfg, B=2, S=64, seed=0, pads=True) -> dict:
    """A numpy training batch for ``cfg``: tokens and labels (the first
    five labels of row 0 pads, ``-1``, with ``pads``), plus the frame
    embeddings of an encoder-decoder and the input embeddings of an
    ``input_mode="embeddings"`` config."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if pads:
        batch["labels"][0, :5] = -1
    if cfg.family == "encdec":
        batch["enc_embeddings"] = (rng.standard_normal((B, S, cfg.d_model))
                                   * 0.1).astype(np.float32)
    if cfg.input_mode == "embeddings":
        batch["embeddings"] = (rng.standard_normal((B, S, cfg.d_model))
                               * 0.1).astype(np.float32)
    return batch


def port_loss_and_grads(model, batch) -> tuple:
    """``(loss, metrics, {keystr: grad})`` of the port's ``model.loss`` on
    a numpy ``batch`` (on the model's device), unused leaves' gradients as
    zeros."""
    tb = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
    loss, metrics = model.loss(tb)
    leaves = model.trainable_leaves()
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in metrics.items()}, \
        dict(zip(leaves, grads))


def assert_loss_and_grads(pair, batch) -> dict:
    """Hold the port's loss, metrics and every gradient leaf to
    ``jax.value_and_grad(model.loss)`` on the same parameters and batch,
    at the LM tolerance.  Returns the port's gradients."""
    import jax
    import jax.numpy as jnp

    fn = jax.jit(jax.value_and_grad(pair.jm.loss, has_aux=True))
    (jl, jmet), jg = fn(pair.params,
                        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, metrics, grads = port_loss_and_grads(pair.model, batch)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jl), rtol=LM_RTOL,
                               atol=LM_ATOL, err_msg="loss")
    assert set(metrics) == set(jmet)
    for k in jmet:
        np.testing.assert_allclose(metrics[k].numpy(), np.asarray(jmet[k]),
                                   rtol=LM_RTOL, atol=LM_ATOL, err_msg=k)
    theirs = {jax.tree_util.keystr(kp): v
              for kp, v in jax.tree_util.tree_leaves_with_path(jg)}
    assert list(grads) == list(theirs)          # same paths, same order
    for k, g in grads.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(theirs[k]),
                                   rtol=LM_RTOL, atol=LM_ATOL,
                                   err_msg=f"grad {k}")
    return grads
