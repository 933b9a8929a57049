"""The port's sharded train step on the families and the profile that
``test_torch_train_sharded`` leaves out: a reduced zamba2-2.7b (hybrid)
and whisper-base (encoder-decoder) under ``Parallelism(mesh)``, and a
reduced llama3.2-1b and mixtral-8x7b under the joint-batch profile
(``joint_batch=True``: the batch over ``data`` and ``model`` together,
experts over ``model``, dense FFN and vocabulary replicated).

As there: four gloo ranks on a ``(2, 2)`` mesh take one step in fp32 from
the same seed and global batch; JAX takes the same step from the same
state with the same ``Parallelism`` on four fake CPU devices; the test
process takes the port's one-device step.  The loss, every parameter and
both moments agree at rtol 1e-4.  The batch (tokens and labels, and
whisper's frame embeddings) is made once from a seed and read by all
three.

AdamW's ``eps`` is 1e-4 here, where ``test_torch_train_sharded`` takes
1e-6, for the reason given there, measured: a few gradient elements of
these archs (the tied embedding's rarest rows, a conv weight) are sums
that cancel to about 1e-7, and the three implementations' sums of them
differ by up to 3e-8 (fp32's rounding of terms a thousand times larger).
Adam's first step moves a parameter by ``lr · g / (|g| + eps)``, so such
an element's difference reaches ``lr · 3e-8 / eps``: 3e-5 at
``eps = 1e-6``, 3e-6 at 1e-5 (both past the comparison's 1e-6 floor),
3e-7 at 1e-4.  The moments, which hold the gradients themselves, are
compared at the same tolerance either way.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import init_train_state, make_train_step
from repro_torch.tree import tree_leaves_with_path
from torch_parity import SRC, flat_cache, lm_train_batch, run_ranks
from torch_parity import one_torch_thread  # noqa: F401 (autouse)

CASES = {"families": (("zamba2-2.7b", "whisper-base"), False),
         "joint_batch": (("llama3.2-1b", "mixtral-8x7b"), True)}
OPT = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-4)
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
    from repro_torch.distributed.sharding import Parallelism
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.train_step import init_train_state, make_train_step
    from repro_torch.tree import tree_leaves_with_path

    OUT = os.environ["OUT"]
    par = Parallelism(make_host_mesh((2, 2), ("data", "model")),
                      joint_batch=os.environ["JOINT"] == "1")
    opt = AdamWConfig(**json.loads(os.environ["OPT"]))
    B, S = int(os.environ["B"]), int(os.environ["S"])
    out = {}
    for arch in os.environ["ARCHS"].split(","):
        cfg = get_config(arch).reduced()
        model, step = make_train_step(cfg, par, opt, device="cpu")
        state = init_train_state(model)
        batch = np.load(os.path.join(OUT, arch + "_batch.npz"))
        state, met = step(state, {k: torch.as_tensor(batch[k])
                                  for k in batch.files})
        out[arch + "/loss"] = met["loss"].numpy()
        for k, v in tree_leaves_with_path(state):
            v = v.detach()
            out[arch + "/" + k] = (v.full_tensor() if hasattr(v, "full_tensor")
                                   else v).numpy()
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
    from repro.distributed.sharding import Parallelism, batch_pspecs, to_shardings
    from repro.optim.adamw import AdamWConfig
    from repro.train.train_step import make_train_step, state_pspecs

    OUT = os.environ["OUT"]
    mesh = make_mesh((2, 2), ("data", "model"))
    par = Parallelism(mesh, joint_batch=os.environ["JOINT"] == "1")
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
        batch = dict(np.load(os.path.join(OUT, arch + "_batch.npz")))
        st_sh = to_shardings(state_pspecs(state, par), mesh)
        b_sh = to_shardings(batch_pspecs(batch, par), mesh)
        fn = jax.jit(step, in_shardings=(st_sh, b_sh))
        state, met = fn(jax.device_put(state, st_sh), jax.device_put(batch, b_sh))
        out[arch + "/loss"] = np.asarray(met["loss"])
        for kp, v in jax.tree_util.tree_leaves_with_path(state):
            out[arch + "/" + jax.tree_util.keystr(kp)] = np.asarray(v)
    np.savez(os.path.join(OUT, "jax.npz"), **out)
""")



def _one_device(arch, tmp_path):
    """The port's one-device step; saves the initial state and the batch
    for the ranks and JAX.  Returns ``{name: array}`` after the step."""
    cfg = get_config(arch).reduced()
    batch = lm_train_batch(cfg, B=B, S=S, seed=3, pads=False)
    np.savez(tmp_path / f"{arch}_batch.npz", **batch)
    model, step = make_train_step(cfg, None, AdamWConfig(**OPT), device="cpu")
    state = init_train_state(model)
    np.savez(tmp_path / f"{arch}_state0.npz",
             **flat_cache(bridge.train_state_to_numpy(state)))
    state, met = step(state, {k: torch.as_tensor(v) for k, v in batch.items()})
    after = {k: v.detach().numpy() for k, v in tree_leaves_with_path(state)}
    after["loss"] = met["loss"].numpy()
    return after


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_one_device_and_reference(case, tmp_path):
    archs, joint = CASES[case]
    env = {"OUT": str(tmp_path), "ARCHS": ",".join(archs),
           "OPT": json.dumps(OPT), "B": str(B), "S": str(S),
           "JOINT": "1" if joint else "0"}
    ones = {arch: _one_device(arch, tmp_path) for arch in archs}
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
    for arch in archs:
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
