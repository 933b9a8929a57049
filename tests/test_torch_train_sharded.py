"""The port's sharded train step (``par``) against its one-device step and
against ``repro``'s sharded ``train_step``.

Four gloo ranks on a ``(2, 2)`` ``("data", "model")`` mesh take one step
of a reduced llama3.2-1b and a reduced mixtral-8x7b (MoE) in fp32, every
rank with the same seed and the same global batch; JAX takes the same
step from the same state with the same ``Parallelism`` on four fake CPU
devices, in a subprocess (``XLA_FLAGS`` must precede JAX's import there);
the test process takes the one-device step.  The loss, every parameter
and both moments agree at rtol 1e-4.

The sharded sums (the FSDP reduce-scatters, the TP all-reduces, the
global norm's per-shard partial sums) add in another order than one
device's.  Adam's first step divides the gradient by its own magnitude
plus ``eps``, so for an element whose gradient is near ``eps`` it turns
that rounding into a parameter change of up to ``peak_lr``: at the
default ``eps = 1e-8`` a few such elements miss rtol 1e-4.  The steps
here use ``eps = 1e-6``; the moments (the gradients themselves) are
held at the same rtol either way.

Also: a one-device checkpoint restored with ``shardings=`` gives each
rank its own slice of every leaf, in place in the sharded model's
parameters.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint
from repro_torch.train.train_step import init_train_state, make_train_step
from torch_parity import SRC, flat_cache, run_ranks
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

ARCHS = ("llama3.2-1b", "mixtral-8x7b", "mamba2-130m")
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)
B, S = 4, 64

RANK_SCRIPT = textwrap.dedent("""
    import json, os
    from datetime import timedelta
    import numpy as np, torch
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, make_batch
    from repro_torch.distributed.sharding import Parallelism, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train import checkpoint
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves_with_path

    OUT = os.environ["OUT"]
    par = Parallelism(make_host_mesh((2, 2), ("data", "model")))
    opt = AdamWConfig(**json.loads(os.environ["OPT"]))
    B, S = int(os.environ["B"]), int(os.environ["S"])
    out = {}
    for arch in os.environ["ARCHS"].split(","):
        cfg = get_config(arch).reduced()
        model, step = make_train_step(cfg, par, opt, device="cpu")
        state = init_train_state(model)
        state, met = step(state, make_batch(DataConfig(cfg.vocab_size, S, B),
                                            0, device="cpu"))
        out[arch + "/loss"] = met["loss"].numpy()
        for k, v in tree_leaves_with_path(state):
            v = v.detach()
            out[arch + "/" + k] = (v.full_tensor() if hasattr(v, "full_tensor")
                                   else v).numpy()
    # elastic restore: a one-device checkpoint into this rank's shards
    cfg = get_config(os.environ["ARCHS"].split(",")[0]).reduced()
    model, _ = make_train_step(cfg, par, opt, device="cpu", seed=7)
    params = model.params.as_dict(lambda t: t)
    got = checkpoint.restore(os.path.join(OUT, "one_device"), params,
                             shardings=param_shardings(params, par))
    assert all(a is b for (_, a), (_, b) in zip(
        tree_leaves_with_path(got), tree_leaves_with_path(params)))
    full = np.load(os.path.join(OUT, "one_device.npz"))
    keys = json.load(open(os.path.join(OUT, "one_device.json")))["keys"]
    for k, p in tree_leaves_with_path(params):
        local, whole = p.to_local().detach(), torch.from_numpy(full[keys[k]])
        want = whole
        for d, pl in zip(range(2), p.placements):
            if pl.is_shard():
                n = p.device_mesh.size(d)
                want = want.chunk(n, pl.dim)[p.device_mesh.get_local_rank(d)]
        assert torch.equal(local, want), k
    np.savez(os.path.join(OUT, f"sharded{rank}.npz"), **out)
    dist.destroy_process_group()
""")

JAX_SCRIPT = textwrap.dedent("""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import json
    import jax, jax.numpy as jnp, numpy as np
    from repro.compat import make_mesh
    from repro.configs import get_config
    from repro.data.pipeline import DataConfig, make_batch
    from repro.distributed.sharding import Parallelism, batch_pspecs, to_shardings
    from repro.optim.adamw import AdamWConfig
    from repro.train.train_step import make_train_step, state_pspecs

    OUT = os.environ["OUT"]
    mesh = make_mesh((2, 2), ("data", "model"))
    par = Parallelism(mesh)
    opt = AdamWConfig(**json.loads(os.environ["OPT"]))
    B, S = int(os.environ["B"]), int(os.environ["S"])
    out = {}
    for arch in os.environ["ARCHS"].split(","):
        cfg = get_config(arch).reduced()
        _, step = make_train_step(cfg, par, opt)
        flat = np.load(os.path.join(OUT, arch + "_state0.npz"))
        state = {"params": {}, "opt": {"m": {}, "v": {}}}
        def put(tree, path, v):
            for k in path[:-1]:
                tree = tree.setdefault(k, {})
            tree[path[-1]] = v
        for k in flat.files:
            put(state, k.split("/"), jnp.asarray(flat[k]))
        batch = make_batch(DataConfig(cfg.vocab_size, S, B), 0)
        st_sh = to_shardings(state_pspecs(state, par), mesh)
        b_sh = to_shardings(batch_pspecs(batch, par), mesh)
        fn = jax.jit(step, in_shardings=(st_sh, b_sh))
        state, met = fn(jax.device_put(state, st_sh), jax.device_put(batch, b_sh))
        out[arch + "/loss"] = np.asarray(met["loss"])
        for kp, v in jax.tree_util.tree_leaves_with_path(state):
            out[arch + "/" + jax.tree_util.keystr(kp)] = np.asarray(v)
    np.savez(os.path.join(OUT, "jax.npz"), **out)
""")


def _one_device(arch):
    """``(initial state as numpy, {name: array} after one step)``."""
    cfg = get_config(arch).reduced()
    model, step = make_train_step(cfg, None, AdamWConfig(**OPT), device="cpu")
    state = init_train_state(model)
    state0 = flat_cache(bridge.train_state_to_numpy(state))
    state, met = step(state, make_batch(DataConfig(cfg.vocab_size, S, B), 0,
                                        device="cpu"))
    from repro_torch.tree import tree_leaves_with_path
    after = {k: v.detach().numpy() for k, v in tree_leaves_with_path(state)}
    after["loss"] = met["loss"].numpy()
    return state0, after


def test_sharded_step_matches_one_device_and_reference(tmp_path):
    env = {"OUT": str(tmp_path), "ARCHS": ",".join(ARCHS),
           "OPT": json.dumps(OPT), "B": str(B), "S": str(S)}
    ones = {}
    for arch in ARCHS:
        state0, ones[arch] = _one_device(arch)
        np.savez(tmp_path / f"{arch}_state0.npz", **state0)
    # the checkpoint the ranks restore: a fresh model of seed 7, one device
    cfg = get_config(ARCHS[0]).reduced()
    model, _ = make_train_step(cfg, None, AdamWConfig(**OPT), device="cpu",
                               seed=7)
    checkpoint.save(model.params.as_dict(lambda t: t), tmp_path / "one_device")
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
        for k in ours:
            for what, ref in (("one device", one[k]),
                              ("repro", theirs[f"{arch}/{k}"])):
                np.testing.assert_allclose(
                    ours[k], ref, rtol=1e-4, atol=1e-6,
                    err_msg=f"{arch} {k} against {what}")
