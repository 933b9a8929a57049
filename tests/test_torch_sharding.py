"""The port's sharding rules (``distributed/sharding.py``) against
``repro.distributed.sharding``, entry by entry.

For all ten archs at full width, on the single (16 x 16) and multi-pod
(2 x 16 x 16) production meshes, in the train, serve (decode) and
joint-batch profiles: ``param_pspecs``, ``state_pspecs``, ``batch_pspecs``
(train, prefill and decode batches) and ``cache_pspecs`` (the decode
cache) equal JAX's ``PartitionSpec``s on an ``AbstractMesh``.  The port's
trees are built under ``FakeTensorMode`` (no storage), JAX's with
``jax.eval_shape``.  The activation table of ``make_constrain`` is held
to the reference's for every role on a few shapes.  Under a fake group
of 256 ranks every parameter of every arch, placed by its spec, has the
local shard shape the spec gives.
"""
import os
import subprocess
import sys
import textwrap

import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs import ARCH_IDS, get_config as jax_config
from repro.configs import get_shape as jax_shape
from repro.distributed import sharding as JS
from repro.launch import specs as jspecs
from repro.models import build_model as jax_build
from repro.train.train_step import state_pspecs as jax_state_pspecs
from repro_torch.configs import get_config, get_shape
from repro_torch.distributed import sharding as TS
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import AbstractMesh as TorchAbstractMesh
from repro_torch.launch.mesh import production_shape
from repro_torch.models import build_model
from repro_torch.train.train_step import init_train_state, state_pspecs
from repro_torch.tree import tree_leaves_with_path
from torch_parity import SRC

MESHES = ("single", "multi")
PROFILES = {"train": dict(), "serve": dict(fsdp_axis=None, serve=True),
            "joint": dict(joint_batch=True)}


def _pars(mesh_name, profile):
    shape, axes = production_shape(multi_pod=mesh_name == "multi")
    kw = dict(dp_axes=("pod", "data") if "pod" in axes else ("data",),
              **PROFILES[profile])
    return (JS.Parallelism(mesh=AbstractMesh(shape, axes), **kw),
            TS.Parallelism(mesh=TorchAbstractMesh(shape, axes), **kw))


def _jax_flat(tree):
    return {jax.tree_util.keystr(kp): tuple(s) for kp, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))}


def _torch_flat(tree):
    return dict(tree_leaves_with_path(tree))


@pytest.fixture(scope="module")
def trees():
    """Per arch: JAX's abstract params, state and decode cache, and the
    port's (fake) model with its state and decode cache."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = {}
    dec = get_shape("decode_32k")
    for arch in ARCH_IDS:
        jcfg = jax_config(arch)
        jm = jax_build(jcfg)
        jp = jspecs.abstract_params(jm, jcfg)
        scalar = jax.ShapeDtypeStruct((), "int32")
        jst = {"params": jp, "opt": {"m": jp, "v": jp, "count": scalar},
               "step": scalar}
        jc = jspecs.abstract_cache(jm, jcfg, jax_shape("decode_32k"))
        with FakeTensorMode():
            model = build_model(get_config(arch), device="cpu")
            tp = model.params.as_dict(lambda t: t)
            tst = init_train_state(model)
            tc = tspecs.abstract_cache(model, get_config(arch), dec)
        out[arch] = (jp, jst, jc, tp, tst, tc)
    return out


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("profile", PROFILES)
def test_param_state_cache_specs_match(trees, mesh_name, profile):
    jpar, tpar = _pars(mesh_name, profile)
    for arch, (jp, jst, jc, tp, tst, tc) in trees.items():
        for what, theirs, ours in (
                ("params", JS.param_pspecs(jp, jpar),
                 TS.param_pspecs(tp, tpar)),
                ("state", jax_state_pspecs(jst, jpar),
                 state_pspecs(tst, tpar)),
                ("cache", JS.cache_pspecs(jc, jpar),
                 TS.cache_pspecs(tc, tpar))):
            j, t = _jax_flat(theirs), _torch_flat(ours)
            assert set(j) == set(t), (arch, what, set(j) ^ set(t))
            for k in j:
                assert t[k] == j[k], (arch, profile, mesh_name, what, k)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("profile", PROFILES)
def test_batch_specs_match(mesh_name, profile):
    from torch._subclasses.fake_tensor import FakeTensorMode
    jpar, tpar = _pars(mesh_name, profile)
    for arch in ARCH_IDS:
        for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
            jb = jspecs.batch_specs(jax_config(arch), jax_shape(shape))
            with FakeTensorMode():
                tb = tspecs.batch_specs(get_config(arch), get_shape(shape))
            assert {k: tuple(v.shape) for k, v in tb.items()} == \
                {k: tuple(v.shape) for k, v in jb.items()}
            assert _torch_flat(TS.batch_pspecs(tb, tpar)) == \
                _jax_flat(JS.batch_pspecs(jb, jpar)), (arch, shape)


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("profile", PROFILES)
def test_activation_roles_match(mesh_name, profile):
    import torch
    jpar, tpar = _pars(mesh_name, profile)
    shapes = {"act": [(256, 4096, 2048), (8, 16, 64), (1, 16, 64)],
              "attn_in": [(256, 4096, 2048), (32, 16, 64)],
              "act_ff": [(256, 4096, 8192), (16, 16, 100)],
              "heads": [(256, 16, 32, 64), (512, 16, 8, 64), (3, 16, 56, 64)],
              "kv_heads": [(256, 16, 8, 64), (256, 16, 16, 64)],
              "logits": [(256, 256, 128256), (2, 16, 50)],
              "moe_hidden": [(256, 8, 64, 14336), (16, 128, 4, 4864)],
              "moe_in": [(256, 8, 64, 4096), (16, 128, 4, 7168)],
              "moe_out": [(256, 8, 64, 4096), (16, 128, 4, 7168)],
              "other": [(4, 4)]}
    for n_heads in (32, 56, None):
        jc = JS.make_constrain(jpar, n_heads)
        tc = TS.make_constrain(tpar, n_heads)
        for kind, cases in shapes.items():
            for shape in cases:
                spec = _reference_spec(
                    jc, jax.ShapeDtypeStruct(shape, "float32"), kind)
                ours = tc.spec_for(torch.empty(shape, device="meta"), kind)
                assert ours == spec, (n_heads, kind, shape, ours, spec)


def _reference_spec(constrain, x, kind):
    """The spec the reference's ``constrain`` puts on ``x`` of ``kind``,
    read from the jaxpr of the call, or None if it puts none."""
    eqns = jax.make_jaxpr(lambda v: constrain(v, kind))(x).jaxpr.eqns
    specs = [tuple(e.params["sharding"].spec) for e in eqns
             if e.primitive.name == "sharding_constraint"]
    return specs[0] if specs else None


SHARD_SCRIPT = textwrap.dedent("""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.distributed import sharding as TS
    from repro_torch.launch.mesh import fake_world, make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves_with_path
    n = 0
    with fake_world(256):
        mesh = make_production_mesh()
        sizes = TS.mesh_sizes(mesh)
        for serve in (False, True):
            par = TS.Parallelism(mesh, fsdp_axis=None if serve else "data",
                                 serve=serve)
            for arch in ARCH_IDS:
                with FakeTensorMode():
                    model = build_model(get_config(arch), device="cpu")
                    tree = model.params.as_dict(lambda t: t)
                    specs = dict(tree_leaves_with_path(
                        TS.param_pspecs(tree, par)))
                    shard = TS.param_shardings(tree, par)
                    for k, t in tree_leaves_with_path(tree):
                        sh = dict(tree_leaves_with_path(shard))[k]
                        local = TS.distribute(t, sh).to_local()
                        want = list(t.shape)
                        for d, e in enumerate(specs[k]):
                            for a in ((e,) if isinstance(e, str) else e or ()):
                                want[d] = -(-want[d] // sizes[a])
                        assert list(local.shape) == want, (arch, k, want)
                        n += 1
    print("ok", n)
""")


def test_local_shards_have_the_spec_shapes():
    out = subprocess.run([sys.executable, "-c", SHARD_SCRIPT],
                         env=dict(os.environ, PYTHONPATH=str(SRC)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and "ok" in out.stdout, out.stderr[-3000:]
