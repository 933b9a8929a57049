"""The port's sharded prefill and decode steps (``par``) against its
one-device steps and against ``repro``'s same steps.

Four gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh run a prefill
and four decode steps of a reduced llama3.2-1b (dense), mixtral-8x7b
(MoE), zamba2-2.7b (hybrid) and whisper-base (encoder-decoder), every
rank with the same seed and the same global batch.  The prefill runs
under the training profile (``Parallelism(mesh)``: FSDP over ``data``,
TP over ``model``), the decode steps under the serve profile
(``fsdp_axis=None, serve=True``: weights resident, the cache's sequence
over TP), as the dry run places them.  JAX runs the same steps from the
same weights with the same two ``Parallelism``s on four fake CPU devices
in a subprocess; the test process runs the port's ``par=None`` steps.

So each explicit redistribution of the decode profile
(``models/sharded.py``: ``experts_local``'s all-to-all, ``write_slot`` on
a sequence-sharded cache, ``local_heads``) is held against values: the
logits of the prefill and of every decode step, and the whole cache
after the last step, at rtol 1e-4.  The decoder-only archs decode at the
last ``STEPS`` slots of the prompt's cache, so every write lands inside
it.

One more step writes past the cache's end, where one device clamps the
slot (ROADMAP C6, C8).  ``repro``'s sharded decode drops that write
instead (XLA's partitioned ``dynamic_update_slice`` on the
sequence-sharded axis does not clamp; ROADMAP C14), so this step is held
against the port's one-device step only, which ``test_torch_lm_*`` hold
against ``repro``'s one-device decode.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.train.train_step import make_decode_step, make_prefill_step
from torch_parity import SRC, flat_cache, run_ranks
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("llama3.2-1b", "mixtral-8x7b", "zamba2-2.7b", "whisper-base")
B, S, STEPS, MAX_DECODE = 4, 32, 4, 8

COMMON = textwrap.dedent("""
    import os
    import numpy as np

    def inputs(arch, cfg):
        OUT = os.environ["OUT"]
        batch = dict(np.load(os.path.join(OUT, arch + "_batch.npz")))
        toks = np.load(os.path.join(OUT, arch + "_toks.npy"))
        enc = cfg.family == "encdec"
        kw = {"max_decode_len": int(os.environ["MAX_DECODE"])} if enc else {}
        pos0 = 0 if enc else int(os.environ["S"]) - len(toks)
        # one more step past the cache's end: the clamped slot (C6, C8)
        clamp = int(os.environ["MAX_DECODE"] if enc else os.environ["S"])
        return batch, toks, kw, pos0, clamp
""")

RANK_SCRIPT = COMMON + textwrap.dedent("""
    from datetime import timedelta
    import torch
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import Parallelism
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train.train_step import make_decode_step, make_prefill_step

    def whole(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, prefix + k + "/"))
            else:
                out[prefix + k] = whole(v).numpy()
        return out

    mesh = make_host_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in os.environ["ARCHS"].split(","):
        cfg = get_config(arch).reduced()
        batch, toks, kw, pos0, clamp = inputs(arch, cfg)
        _, prefill = make_prefill_step(cfg, Parallelism(mesh), device="cpu")
        _, decode = make_decode_step(
            cfg, Parallelism(mesh, fsdp_axis=None, serve=True), device="cpu")
        logits, cache = prefill({k: torch.as_tensor(v) for k, v in
                                 batch.items()}, **kw)
        out[arch + "/logits0"] = whole(logits).numpy()
        # the prefill's cache as the decode profile places it
        cache = torch.utils._pytree.tree_map(whole, cache)
        for i in range(len(toks)):
            logits, cache = decode(cache, torch.as_tensor(toks[i]), pos0 + i)
            out[arch + f"/logits{i + 1}"] = whole(logits).numpy()
        for k, v in flat(cache).items():
            out[arch + "/cache/" + k] = v
        logits, cache = decode(cache, torch.as_tensor(toks[0]), clamp)
        out[arch + "/clamped/logits"] = whole(logits).numpy()
        for k, v in flat(cache).items():
            out[arch + "/clamped/cache/" + k] = v
    np.savez(os.path.join(os.environ["OUT"], f"sharded{rank}.npz"), **out)
    dist.destroy_process_group()
""")

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import functools
    import jax, jax.numpy as jnp
""") + COMMON + textwrap.dedent("""
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.distributed.sharding import (Parallelism, batch_pspecs,
                                            cache_pspecs, param_pspecs,
                                            to_shardings)
    from repro.train.train_step import make_decode_step, make_prefill_step

    OUT = os.environ["OUT"]
    mesh = make_mesh((2, 2), ("data", "model"))
    out = {}
    for arch in os.environ["ARCHS"].split(","):
        cfg = get_config(arch).reduced()
        batch, toks, kw, pos0, _ = inputs(arch, cfg)
        flat = np.load(os.path.join(OUT, arch + "_params.npz"))
        params = {}
        for k in flat.files:
            node = params
            *path, leaf = k.split("/")
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(flat[k])
        pre_par = Parallelism(mesh)
        dec_par = Parallelism(mesh, fsdp_axis=None, serve=True)
        pm, _ = make_prefill_step(cfg, pre_par)
        dm, _ = make_decode_step(cfg, dec_par)
        batch = {k: jnp.asarray(v) for k, v in batch.items()}
        p_sh = to_shardings(param_pspecs(params, pre_par), mesh)
        b_sh = to_shardings(batch_pspecs(batch, pre_par), mesh)
        pre = jax.jit(functools.partial(pm.prefill, **kw),
                      in_shardings=(p_sh, b_sh))
        logits, cache = pre(jax.device_put(params, p_sh),
                            jax.device_put(batch, b_sh))
        out[arch + "/logits0"] = np.asarray(logits)
        pd_sh = to_shardings(param_pspecs(params, dec_par), mesh)
        c_sh = to_shardings(cache_pspecs(cache, dec_par), mesh)
        t_sh = to_shardings(batch_pspecs({"tokens": jnp.asarray(toks[0])},
                                         dec_par)["tokens"], mesh)
        dec = jax.jit(dm.decode_step, in_shardings=(pd_sh, c_sh, t_sh, None),
                      out_shardings=(None, c_sh))
        dparams = jax.device_put(params, pd_sh)
        cache = jax.device_put(cache, c_sh)
        for i in range(len(toks)):
            logits, cache = dec(dparams, cache, jnp.asarray(toks[i]),
                                jnp.int32(pos0 + i))
            out[arch + f"/logits{i + 1}"] = np.asarray(logits)
        def walk(tree, prefix):
            for k, v in tree.items():
                if isinstance(v, dict):
                    walk(v, prefix + k + "/")
                else:
                    out[prefix + k] = np.asarray(v)
        walk(cache, arch + "/cache/")
    np.savez(os.path.join(OUT, "jax.npz"), **out)
""")


def _inputs(arch, cfg, tmp_path):
    """The arch's batch and decode tokens, made from a seed and saved for
    the ranks and JAX: ``(batch, tokens (STEPS, B, 1), kw, pos0,
    clamp)``."""
    rng = np.random.default_rng(5)
    if cfg.family == "encdec":
        batch = {"enc_embeddings": (rng.standard_normal((B, S, cfg.d_model))
                                    * 0.1).astype(np.float32)}
        kw, pos0, clamp = {"max_decode_len": MAX_DECODE}, 0, MAX_DECODE
    else:
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
            np.int32)}
        kw, pos0, clamp = {}, S - STEPS, S
    toks = rng.integers(0, cfg.vocab_size, (STEPS, B, 1)).astype(np.int32)
    np.savez(tmp_path / f"{arch}_batch.npz", **batch)
    np.save(tmp_path / f"{arch}_toks.npy", toks)
    return batch, toks, kw, pos0, clamp


def _one_device(arch, tmp_path):
    """The port's ``par=None`` prefill and decode steps; saves the weights
    for JAX."""
    cfg = get_config(arch).reduced()
    batch, toks, kw, pos0, clamp = _inputs(arch, cfg, tmp_path)
    model, prefill = make_prefill_step(cfg, None, device="cpu")
    _, decode = make_decode_step(cfg, None, device="cpu")
    np.savez(tmp_path / f"{arch}_params.npz",
             **flat_cache(bridge.lm_params_to_numpy(model)))
    out = {}
    logits, cache = prefill({k: torch.as_tensor(v) for k, v in batch.items()},
                            **kw)
    out["logits0"] = logits.numpy()
    for i in range(STEPS):
        logits, cache = decode(cache, torch.as_tensor(toks[i]), pos0 + i)
        out[f"logits{i + 1}"] = logits.numpy()
    for k, v in flat_cache(cache).items():
        out["cache/" + k] = v.numpy().copy()    # the next step writes in place
    logits, cache = decode(cache, torch.as_tensor(toks[0]), clamp)
    out["clamped/logits"] = logits.numpy()
    for k, v in flat_cache(cache).items():
        out["clamped/cache/" + k] = v.numpy()
    return out


def test_sharded_serve_matches_one_device_and_reference(tmp_path):
    env = {"OUT": str(tmp_path), "ARCHS": ",".join(ARCHS), "S": str(S),
           "MAX_DECODE": str(MAX_DECODE)}
    ones = {arch: _one_device(arch, tmp_path) for arch in ARCHS}
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT],
        env=dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu", **env),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        run_ranks(RANK_SCRIPT, 4, tmp_path, env=env)
        log, _ = jax_proc.communicate(timeout=240)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.wait()
    assert jax_proc.returncode == 0, log[-3000:]
    theirs = np.load(tmp_path / "jax.npz")
    ranks = [np.load(tmp_path / f"sharded{r}.npz") for r in range(4)]
    for arch in ARCHS:
        ours = {k[len(arch) + 1:]: ranks[0][k] for k in ranks[0].files
                if k.startswith(arch + "/")}
        for r in ranks[1:]:                     # every rank: the same whole
            for k in ours:
                np.testing.assert_array_equal(r[f"{arch}/{k}"], ours[k])
        one = ones[arch]
        assert set(ours) == set(one)
        held = [k for k in ours if not k.startswith("clamped/")]
        assert {f"{arch}/{k}" for k in held} <= set(theirs.files)
        for k in ours:
            refs = [("one device", one[k])]
            if k in held:
                refs.append(("repro", theirs[f"{arch}/{k}"]))
            for what, ref in refs:
                np.testing.assert_allclose(
                    ours[k], ref, rtol=1e-4, atol=1e-5,
                    err_msg=f"{arch} {k} against {what}")
