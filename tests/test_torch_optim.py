"""The port's optimizer and gradient compression (``optim/``) against
``repro.optim``.

* ``tests/test_data_optim.py``'s AdamW and compression cases, on the port.
* ``update`` against ``repro.optim.adamw.update`` on random trees over
  several steps (clipping active, every decay tag), rtol 1e-6; the
  parameters and moments are written in place.
* The set of decayed leaves equal to JAX's for every arch's parameter
  tree (the ``keystr`` paths, ``'b`` and ``'D'`` tags included).
* ``lr_schedule`` over steps 0 to 120, rtol 1e-6.
* ``quantize_int8`` and ``ef_compress_leaf`` bit for bit; the stochastic
  variant (torch's generator) unbiased to within its noise.
* ``compressed_psum`` on 4 gloo ranks and ``make_compressed_dp_allreduce``
  on a (2, 2) ("pod", "model") mesh, against a numpy model of the
  reference's formula.
"""
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import build_model as jax_build
from repro.optim import adamw as JA
from repro.optim import grad as JG
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import build_model
from repro_torch.optim import adamw as TA
from repro_torch.optim import grad as TG
from torch_parity import run_ranks
from torch_parity import one_torch_thread  # noqa: F401 (autouse)


class TestAdamW:
    def test_converges_on_quadratic(self):
        cfg = TA.AdamWConfig(peak_lr=0.1, warmup_steps=5, total_steps=200,
                             weight_decay=0.0, clip_norm=100.0)
        target = torch.tensor([1.0, -2.0, 3.0])
        params = {"w": torch.zeros(3)}
        state = TA.init(params)
        for _ in range(200):
            g = {"w": 2 * (params["w"] - target)}
            params, state, _ = TA.update(g, state, params, cfg)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                                   atol=0.05)

    def test_clip_norm(self):
        params = {"w": torch.zeros(4)}
        _, _, m = TA.update({"w": torch.full((4,), 100.0)}, TA.init(params),
                            params, TA.AdamWConfig(clip_norm=1.0))
        assert float(m["grad_norm"]) == pytest.approx(200.0)

    def test_no_decay_on_norm_scales(self):
        cfg = TA.AdamWConfig(peak_lr=1.0, warmup_steps=0, weight_decay=0.1)
        params = {"mlp": {"wi": torch.ones((2, 2))},
                  "ln": {"scale": torch.ones(2)}}
        zg = {"mlp": {"wi": torch.zeros((2, 2))}, "ln": {"scale": torch.zeros(2)}}
        new, _, _ = TA.update(zg, TA.init(params), params, cfg)
        assert float(new["mlp"]["wi"].max()) < 1.0
        assert float(new["mlp"]["wi"].min()) > 0.5
        np.testing.assert_allclose(new["ln"]["scale"].numpy(), 1.0)

    def test_schedule_shape(self):
        cfg = TA.AdamWConfig(peak_lr=1.0, warmup_steps=10, total_steps=100,
                             min_lr_frac=0.1)
        lrs = [float(TA.lr_schedule(cfg, torch.tensor(s, dtype=torch.int32)))
               for s in range(0, 101, 10)]
        assert lrs[1] == pytest.approx(1.0, rel=1e-3)
        assert lrs[-1] == pytest.approx(0.1, rel=1e-2)
        assert max(lrs) <= 1.0 + 1e-6


def _tree(rng, scale=1.0):
    shapes = {"embed": {"table": (16, 8)},
              "layers": {"attn": {"wq": (2, 8, 4), "bq": (2, 4)},
                         "ln1": {"scale": (2, 8), "bias": (2, 8)},
                         "ssm": {"A_log": (2, 3), "D": (2, 3), "dt_bias": (2, 3),
                                 "conv_b": (2, 5), "in_proj": (2, 8, 6)}},
              "final_norm": {"scale": (8,)}}

    def draw(s):
        return {k: draw(v) if isinstance(v, dict) else
                (rng.standard_normal(v) * scale).astype(np.float32)
                for k, v in s.items()}
    return draw(shapes)


def _torch(tree):
    return jax.tree.map(lambda a: torch.tensor(np.asarray(a)), tree)


def test_update_matches_reference_in_place():
    rng = np.random.default_rng(0)
    cfg = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=0.5)
    jp = _tree(rng)
    tp = _torch(jp)
    leaves = jax.tree.leaves(tp)
    jstate, tstate = JA.init(jp), TA.init(tp)
    for step in range(5):
        g = _tree(rng, scale=0.3)
        jp, jstate, jm = JA.update(g, jstate, jp, JA.AdamWConfig(**cfg))
        tp2, tstate, tm = TA.update(_torch(g), tstate, tp,
                                    TA.AdamWConfig(**cfg))
        assert jax.tree.leaves(tp2) == leaves          # written in place
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-6, err_msg=k)
        for part, a, b in (("params", tp, jp), ("m", tstate["m"], jstate["m"]),
                           ("v", tstate["v"], jstate["v"])):
            for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
                np.testing.assert_allclose(x.numpy(), np.asarray(y),
                                           rtol=1e-6, atol=1e-9,
                                           err_msg=f"{part} step {step}")
        assert int(tstate["count"]) == int(jstate["count"]) == step + 1


def test_decayed_leaves_match_reference_for_every_arch():
    for arch in ARCH_IDS:
        jm = jax_build(jax_config(arch).reduced())
        shapes = jax.eval_shape(jm.init, jax.random.key(0))
        want = {jax.tree_util.keystr(kp) for kp, _ in
                jax.tree_util.tree_leaves_with_path(shapes)
                if JA._decayable(jax.tree_util.keystr(kp))}
        paths = build_model(get_config(arch).reduced(), device="cpu"
                            ).trainable_leaves()
        got = {p for p in paths if TA._decayable(p)}
        assert got == want, arch
        assert "['embed']['table']" in got


def test_lr_schedule_matches_reference():
    cfg = dict(peak_lr=3e-4, warmup_steps=7, total_steps=100,
               min_lr_frac=0.1)
    steps = np.arange(121, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: JA.lr_schedule(JA.AdamWConfig(**cfg),
                                                        s))(steps))
    got = TA.lr_schedule(TA.AdamWConfig(**cfg), torch.as_tensor(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


class TestCompression:
    def test_quantize_roundtrip_bound(self):
        x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
        q, s = TG.quantize_int8(x)
        assert float((TG.dequantize(q, s) - x).abs().max()) <= \
            float(s) * 0.5 + 1e-6

    def test_error_feedback_unbiased_over_time(self):
        g = torch.randn(256, generator=torch.Generator().manual_seed(1)) * 0.01
        err = torch.zeros(256)
        total = torch.zeros(256)
        for _ in range(50):
            q, s, err = TG.ef_compress_leaf(g, err)
            total = total + TG.dequantize(q, s)
        np.testing.assert_allclose((total / 50).numpy(), g.numpy(), atol=5e-4)

    def test_init_error_state(self):
        e = TG.init_error_state({"a": torch.ones((2, 3), dtype=torch.bfloat16)})
        assert e["a"].dtype == torch.float32 and e["a"].shape == (2, 3)

    def test_quantize_and_ef_bitwise(self):
        rng = np.random.default_rng(2)
        for scale in (1e-3, 1.0, 50.0):
            x = (rng.standard_normal((64, 33)) * scale).astype(np.float32)
            e = (rng.standard_normal(x.shape) * scale * 0.01).astype(np.float32)
            jq, js = JG.quantize_int8(jnp.asarray(x))
            tq, ts = TG.quantize_int8(torch.as_tensor(x))
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert ts.numpy().tobytes() == np.asarray(js).tobytes()
            for got, want in zip(TG.ef_compress_leaf(torch.as_tensor(x),
                                                     torch.as_tensor(e)),
                                 JG.ef_compress_leaf(jnp.asarray(x),
                                                     jnp.asarray(e))):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def test_stochastic_rounding_is_unbiased(self):
        x = torch.linspace(-1.0, 1.0, 101)
        gen = torch.Generator().manual_seed(3)
        total = torch.zeros_like(x)
        for _ in range(2000):
            q, s = TG.quantize_int8(x, generator=gen)
            total += TG.dequantize(q, s)
        # the noise of a mean of 2000 draws of spread s: well inside s/10
        assert float((total / 2000 - x).abs().max()) < float(s) / 10


RANKS = textwrap.dedent("""
    import os, sys
    from datetime import timedelta
    import numpy as np, torch
    import torch.distributed as dist
    from repro_torch.core.mesh import make_mesh
    from repro_torch.optim import grad as TG
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method="file://" + os.environ["STORE"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=60))
    data = np.load("grads.npz")
    grads = {"a": {"w": torch.as_tensor(data[f"w{rank}"])},
             "b": torch.as_tensor(data[f"b{rank}"])}
    err = TG.init_error_state(grads)
    out = {}
    for it in range(2):
        red, err = TG.compressed_psum(grads, err)
        out[f"red_w{it}"], out[f"red_b{it}"] = red["a"]["w"], red["b"]
        out[f"err_w{it}"], out[f"err_b{it}"] = err["a"]["w"], err["b"]
    mesh = make_mesh((2, 2), ("pod", "model"), device="cpu")
    red, _ = TG.make_compressed_dp_allreduce(mesh)(
        grads, TG.init_error_state(grads))
    out["pod_w"], out["pod_b"] = red["a"]["w"], red["b"]
    np.savez(f"out{rank}.npz", **{k: v.numpy() for k, v in out.items()})
    dist.destroy_process_group()
""")


def _model(gs, errs):
    """The reference's compressed_psum over ranks, in numpy float32."""
    qs, scales, new_errs = [], [], []
    for g, e in zip(gs, errs):
        g32 = g + e
        scale = np.float32(np.abs(g32).max() + np.float32(1e-12)) \
            / np.float32(127.0)
        q = np.clip(np.round(g32 / scale), -127, 127).astype(np.int8)
        qs.append(q)
        scales.append(scale)
        new_errs.append(g32 - q.astype(np.float32) * scale)
    n = np.float32(len(gs))
    tot = np.sum([q.astype(np.int32) for q in qs], axis=0)
    s = np.float32(np.sum(scales, dtype=np.float32)) / n
    return tot.astype(np.float32) * s / n, new_errs


def test_compressed_psum_on_four_gloo_ranks(tmp_path):
    rng = np.random.default_rng(4)
    gw = [(rng.standard_normal((6, 7)) * 10 ** r).astype(np.float32)
          for r in range(4)]
    gb = [rng.standard_normal(5).astype(np.float32) for _ in range(4)]
    np.savez(tmp_path / "grads.npz", **{f"w{r}": gw[r] for r in range(4)},
             **{f"b{r}": gb[r] for r in range(4)})
    run_ranks(RANKS, 4, tmp_path, timeout=120)
    outs = [np.load(tmp_path / f"out{r}.npz") for r in range(4)]
    for name, gs in (("w", gw), ("b", gb)):
        errs = [np.zeros_like(g) for g in gs]
        for it in range(2):
            red, errs = _model(gs, errs)
            for r, o in enumerate(outs):
                np.testing.assert_allclose(o[f"red_{name}{it}"], red,
                                           rtol=1e-6, err_msg=f"{name} {it}")
                np.testing.assert_array_equal(o[f"err_{name}{it}"], errs[r])
        # the pod axis of a (2, 2) mesh: ranks {0, 2} and {1, 3}
        for pair in ((0, 2), (1, 3)):
            red, _ = _model([gs[r] for r in pair], [np.zeros_like(gs[0])] * 2)
            for r in pair:
                np.testing.assert_allclose(outs[r][f"pod_{name}"], red,
                                           rtol=1e-6)
