"""The port's cost counter (``launch/cost.py``) and roofline against
``repro.launch.hlo_cost`` and ``repro.launch.roofline``.

``tests/test_roofline.py``'s computations, written in torch, run under
``CostCounter``; their flops equal what ``analyze_hlo`` counts on the
compiled JAX version (rtol 0.01, as there; 0.02 for the gradient, as
there).  The torch gradient is taken of the weights and the input, the
three products a step that the reference's scan backward body takes.
Collectives on a fake process group of 4 ranks: a DTensor all-gather and
a reduce-scatter come out by kind with their bytes.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import ARCH_IDS as JAX_ARCHS
from repro.configs import get_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.configs.base import SHAPES as JAX_SHAPES
from repro.launch.hlo_cost import analyze_hlo
from repro.launch.roofline import model_flops_for as jax_model_flops
from repro_torch.configs import ARCH_IDS, get_config, get_shape
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.roofline import analyze, model_flops_for
from torch_parity import SRC
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


def _hlo_flops(f, *avals):
    return analyze_hlo(jax.jit(f).lower(*avals).compile().as_text()).flops


def _count(fn, *args):
    with CostCounter() as c:
        fn(*args)
    return c.cost


def test_loop_of_eight_products():
    d = 256

    def scanned(x, ws):
        y, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)
        return y

    ref = _hlo_flops(scanned, jax.ShapeDtypeStruct((32, d), jnp.float32),
                     jax.ShapeDtypeStruct((8, d, d), jnp.float32))

    def loop(x, ws):
        for i in range(8):
            x = torch.tanh(x @ ws[i])
        return x

    c = _count(loop, torch.randn(32, d), torch.randn(8, d, d))
    np.testing.assert_allclose(c.flops, ref, rtol=0.01)
    np.testing.assert_allclose(c.flops, 8 * 2 * 32 * d * d, rtol=0.01)


def test_unrolled_four():
    d = 256

    def unrolled(x, ws):
        for i in range(4):
            x = jnp.tanh(x @ ws[i])
        return x

    ref = _hlo_flops(unrolled, jax.ShapeDtypeStruct((32, d), jnp.float32),
                     jax.ShapeDtypeStruct((4, d, d), jnp.float32))

    def loop(x, ws):
        for i in range(4):
            x = torch.tanh(x @ ws[i])
        return x

    c = _count(loop, torch.randn(32, d), torch.randn(4, d, d))
    np.testing.assert_allclose(c.flops, ref, rtol=0.01)


def test_gradient_through_the_loop():
    d = 128

    def loss(ws, x):
        y, _ = jax.lax.scan(lambda x, w: (jnp.tanh(x @ w), None), x, ws)
        return (y ** 2).sum()

    ref = _hlo_flops(jax.grad(loss),
                     jax.ShapeDtypeStruct((8, d, d), jnp.float32),
                     jax.ShapeDtypeStruct((16, d), jnp.float32))

    def grad(ws, x):
        y = x
        for i in range(8):
            y = torch.tanh(y @ ws[i])
        return torch.autograd.grad((y ** 2).sum(), (ws, x))

    c = _count(grad, torch.randn(8, d, d, requires_grad=True),
               torch.randn(16, d, requires_grad=True))
    np.testing.assert_allclose(c.flops, ref, rtol=0.02)
    np.testing.assert_allclose(c.flops, 3 * 8 * 2 * 16 * d * d, rtol=0.02)


def test_einsum_batch_dims():
    ref = _hlo_flops(lambda q, k: jnp.einsum("bqhd,bkhd->bhqk", q, k),
                     jax.ShapeDtypeStruct((2, 64, 4, 32), jnp.bfloat16),
                     jax.ShapeDtypeStruct((2, 64, 4, 32), jnp.bfloat16))
    q = torch.randn(2, 64, 4, 32, dtype=torch.bfloat16)
    c = _count(lambda q, k: torch.einsum("bqhd,bkhd->bhqk", q, k), q, q)
    np.testing.assert_allclose(c.flops, ref, rtol=0.01)
    # bytes: the inputs and outputs of the ops that moved data
    assert c.bytes >= 2 * q.numel() * 2 + 2 * 4 * 64 * 64 * 2


def test_peak_memory_counts_arguments_and_temporaries():
    x = torch.zeros(1024)                     # 4 KiB argument
    with CostCounter() as c:
        assert c.track({"x": x}) == 4096
        y = x + 1                             # +4 KiB live
        del y
        z = x * 2                             # freed y's bytes: peak stays
        del z
    assert c.peak_bytes == 8192
    assert c.cost.bytes == 4 * 4096           # two ops, input + output each


def test_model_flops_for_every_arch_and_shape():
    assert list(ARCH_IDS) == list(JAX_ARCHS)
    for arch in ARCH_IDS:
        for shape in JAX_SHAPES:
            assert model_flops_for(get_config(arch), get_shape(shape)) == \
                jax_model_flops(jax_config(arch), jax_shape(shape)), \
                (arch, shape)


def test_roofline_terms_use_the_cards_peaks():
    from repro_torch.launch import mesh
    c = _count(lambda a, b: a @ b, torch.randn(64, 32), torch.randn(32, 16))
    rl = analyze(c, n_devices=1, model_flops=2 * 64 * 32 * 16)
    assert rl.flops_per_dev == 2 * 64 * 32 * 16
    assert rl.compute_s == rl.flops_per_dev / mesh.BF16_FLOPS_PER_S
    assert rl.memory_s == rl.bytes_per_dev / mesh.HBM_BYTES_PER_S
    assert rl.useful_ratio == 1.0 and rl.dominant == "memory"
    assert set(rl.to_dict()) == {
        "flops_per_dev", "bytes_per_dev", "coll_bytes_per_dev", "compute_s",
        "memory_s", "collective_s", "dominant", "model_flops",
        "useful_ratio", "coll_detail"}


FAKE_SCRIPT = textwrap.dedent("""
    import torch
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.cost import CostCounter
    from repro_torch.launch.mesh import fake_world, make_host_mesh
    with fake_world(4):
        mesh = make_host_mesh((2, 2))
        w = distribute_tensor(torch.zeros(64, 32), mesh, [Shard(0), Shard(1)],
                              src_data_rank=None)
        with CostCounter() as c:
            g = w.redistribute(mesh, [Replicate(), Shard(1)])   # all-gather
            (g * 2).redistribute(mesh, [Shard(0), Shard(1)])     # no comm
        # local (32, 16) fp32 shards gathered over 2 ranks: (64, 16)
        assert c.cost.coll["all-gather"] == 64 * 16 * 4, c.cost.coll
        assert c.cost.coll_msgs == 1, c.cost
        from torch.distributed.tensor import DTensor, Partial
        part = DTensor.from_local(torch.zeros(64, 16), mesh,
                                  [Partial(), Shard(1)], run_check=False)
        with CostCounter() as c:
            part.redistribute(mesh, [Shard(0), Shard(1)])   # reduce-scatter
        assert c.cost.coll["reduce-scatter"] == 64 * 16 * 4, c.cost.coll
    print("ok")
""")


def test_collectives_on_a_fake_group():
    out = subprocess.run([sys.executable, "-c", FAKE_SCRIPT],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]
