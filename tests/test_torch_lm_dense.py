"""The port's dense decoders against ``repro``'s, in fp32, with JAX's
weights carried across by the bridge.

Every reduced dense arch through ``prefill`` and 8 ``decode_step``s at
rtol 1e-4 (``torch_parity.assert_lm_prefill_decode``); the serve cache's
clamp (ROADMAP C6) pinned against ``repro``; decode fed token by token
against prefill (rtol = atol = 2e-3, ``tests/test_models.py``'s); the
bridge's checks, also on the ssm, hybrid and encdec trees.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.models import build_model
from torch_parity import LM_ATOL, LM_RTOL, assert_lm_prefill_decode, lm_pair


@pytest.mark.parametrize("arch,S", [
    ("llama3.2-1b", 64), ("qwen2.5-3b", 64), ("gemma2-2b", 64),
    ("gemma2-2b", 96),      # local layers take flash's window slab
    ("h2o-danube-3-4b", 64)])
def test_prefill_and_decode_match_reference(arch, S):
    assert_lm_prefill_decode(arch, S=S)


@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen2.5-3b", "mixtral-8x7b"])
def test_layer_apply_matches_reference(arch):
    """One layer of each kind through ``layer_apply`` and ``attn_apply``
    (positions left to the function) against ``repro``'s."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as TT
    jm, params, model = lm_pair(arch)
    cfg = model.cfg
    x = (np.random.default_rng(4).standard_normal((2, 64, cfg.d_model))
         * 0.5).astype(np.float32)
    for j, kind in enumerate(cfg.layer_group):
        pj = jax.tree.map(lambda a: a[0, j], params["layers"])
        tj = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), pj)
        noop = lambda h, kind: h  # noqa: E731
        yj, aux_j = jax.jit(lambda x, p: JT.layer_apply(
            x, p, jm.cfg, kind=kind, constrain=noop))(jnp.asarray(x), pj)
        yt, aux_t = TT.layer_apply(torch.as_tensor(x), tj, cfg, kind=kind,
                                   constrain=noop)
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=kind)
        for k in ("lb_loss", "z_loss"):
            np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                       rtol=LM_RTOL, atol=LM_ATOL)
        aj = jax.jit(lambda x, p: JT.attn_apply(
            x, p, jm.cfg, kind=kind, constrain=noop))(jnp.asarray(x),
                                                      pj["attn"])
        at = TT.attn_apply(torch.as_tensor(x), tj["attn"], cfg, kind=kind,
                           constrain=noop)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=LM_RTOL,
                                   atol=LM_ATOL, err_msg=kind)


def test_decode_past_the_cache_overwrites_its_last_slot():
    """C6: decode at pos >= Sc writes slot Sc - 1, as ``repro`` does, and
    leaves the other slots alone."""
    jm, params, model = lm_pair("llama3.2-1b")
    S = 16
    toks = np.random.default_rng(3).integers(0, 512, (2, S)).astype(np.int32)
    jl, jcache = jax.jit(jm.prefill)(params, {"tokens": jnp.asarray(toks)})
    _, tcache = model.prefill({"tokens": torch.as_tensor(toks)})
    step = jax.jit(jm.decode_step)
    for pos in (S, S + 1):
        before = {k: v.clone() for k, v in tcache.items()}
        tok = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        jl, jcache = step(params, jcache, jnp.asarray(tok), jnp.int32(pos))
        tl, tcache = model.decode_step(tcache, torch.as_tensor(tok), pos)
        for k in tcache:
            assert torch.equal(tcache[k][:, :, :S - 1], before[k][:, :, :S - 1])
            assert not torch.equal(tcache[k][:, :, S - 1],
                                   before[k][:, :, S - 1])
            np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                       rtol=LM_RTOL, atol=LM_ATOL)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=LM_RTOL,
                                   atol=LM_ATOL)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "gemma2-2b"])
def test_decode_matches_prefill(arch):
    """Feeding tokens one by one through decode reproduces prefill's logits."""
    cfg = get_config(arch).reduced()
    model = build_model(cfg, device="cpu", seed=10)
    B, S = 2, 64
    toks = torch.as_tensor(
        np.random.default_rng(11).integers(0, cfg.vocab_size, (B, S)))
    logits_pre, _ = model.prefill({"tokens": toks})
    cache = model.cache_spec(B, S)
    for i in range(S):
        logits, cache = model.decode_step(cache, toks[:, i:i + 1], i)
    np.testing.assert_allclose(logits.numpy(), logits_pre.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_bridge_round_trip_and_checks():
    jm, params, model = lm_pair("qwen2.5-3b")
    tree = jax.tree.map(np.asarray, params)
    back = bridge.lm_params_to_numpy(model)
    flat_j = jax.tree_util.tree_leaves_with_path(tree)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for (path, a), b in zip(flat_j, jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, a, err_msg=str(path))
    missing = {k: v for k, v in tree.items() if k != "final_norm"}
    with pytest.raises(ValueError, match="missing.*final_norm/scale"):
        bridge.lm_params_from_numpy(model, missing)
    extra = dict(tree, lm_head={"table": tree["embed"]["table"]})
    with pytest.raises(ValueError, match="extra.*lm_head/table"):
        bridge.lm_params_from_numpy(model, extra)
    bad = jax.tree.map(lambda a: a, tree)
    bad["embed"]["table"] = bad["embed"]["table"][:, :8]
    with pytest.raises(ValueError, match="embed/table"):
        bridge.lm_params_from_numpy(model, bad)


def test_compute_copy_follows_the_parameters():
    """The compute-dtype copy is made once, and again after a write."""
    cfg = get_config("llama3.2-1b").reduced()
    model = build_model(cfg, device="cpu")
    first = model.compute_params()
    assert model.compute_params() is first
    with torch.no_grad():
        model.params["final_norm"]["scale"].add_(1.0)
    again = model.compute_params()
    assert again is not first
    assert torch.equal(again["final_norm"]["scale"],
                       model.params["final_norm"]["scale"])


def test_bf16_compute_copy_follows_the_reference_cast():
    """fp32 leaves of more than one axis of the *stacked* tree are cast, as
    the reference casts before its layer scan: the layers' norm scales
    (n_groups, group_size, d) too, the final norm's (d,) not."""
    cfg = dataclasses.replace(get_config("llama3.2-1b").reduced(),
                              compute_dtype="bfloat16")
    model = build_model(cfg, device="cpu")
    cp = model.compute_params()
    assert cp["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert cp["embed"]["table"].dtype == torch.bfloat16
    assert cp["layers"]["ln1"]["scale"].dtype == torch.bfloat16
    assert cp["final_norm"]["scale"].dtype == torch.float32
    assert model.params["layers"]["attn"]["wq"].dtype == torch.float32
    logits, cache = model.prefill(
        {"tokens": torch.zeros((1, 8), dtype=torch.long)})
    assert logits.dtype == torch.float32
    assert cache["k0"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,cls,leaf", [
    ("mamba2-130m", "SSMModel", ("layers", "ssm", "A_log")),
    ("zamba2-2.7b", "HybridModel", ("shared_in",)),
    ("whisper-base", "EncDecModel", ("dec_layers", "xattn", "bq"))])
def test_family_builds_and_the_bridge_checks_its_tree(arch, cls, leaf):
    """The ssm, hybrid and encdec families build on the CPU and load JAX's
    tree; a tree without one of the family's own leaves, or with an extra
    one, is refused."""
    model = build_model(get_config(arch).reduced(), device="cpu")
    assert type(model).__name__ == cls and model.device.type == "cpu"
    jm, params, model = lm_pair(arch)
    tree = jax.tree.map(np.asarray, params)
    missing = jax.tree.map(lambda a: a, tree)
    node = missing
    for k in leaf[:-1]:
        node = node[k]
    del node[leaf[-1]]
    with pytest.raises(ValueError, match="missing.*" + "/".join(leaf)):
        bridge.lm_params_from_numpy(model, missing)
    extra = dict(tree, lm_head={"table": tree["embed"]["table"]})
    with pytest.raises(ValueError, match="extra.*lm_head/table"):
        bridge.lm_params_from_numpy(model, extra)


def test_model_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("llama3.2-1b").reduced())
