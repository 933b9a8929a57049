"""The port's MoE layer and MoE models against ``repro``'s, in fp32.

``moe_apply`` (dispatch, drops past capacity, the tie order of the router's
top-k, the aux losses) at rtol = 1e-5, atol = 1e-6; the reduced MoE archs
(and internvl2's ``embeddings`` input) through ``prefill`` and 8
``decode_step``s with JAX's weights carried across by the bridge
(``torch_parity.assert_lm_prefill_decode``, rtol 1e-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM
from torch_parity import assert_lm_prefill_decode

MOE_TOL = dict(rtol=1e-5, atol=1e-6)


def _moe_pair(spec_args, d, f, seed, zero_router=False, gated=True):
    spec_j, spec_t = JM.MoESpec(*spec_args), TM.MoESpec(*spec_args)
    params = JM.moe_init(jax.random.key(seed), d, f, spec_j, jnp.float32,
                         gated=gated)
    if zero_router:
        params["router"] = jnp.zeros_like(params["router"])
    tparams = {k: torch.as_tensor(np.array(v)) for k, v in params.items()}
    return spec_j, spec_t, params, tparams


#: (name, MoESpec args, gated, zero router, activation)
MOE_CASES = [
    ("no-drops", (4, 2, 8.0), True, False, "silu"),
    ("drops", (4, 2, 0.5), True, False, "silu"),
    ("heavy-drops", (8, 2, 0.25), True, False, "gelu"),
    ("top1-ungated", (4, 1, 1.0), False, False, "silu"),
    ("ties", (8, 2, 1.0), True, True, "silu"),    # all router logits equal
]


@pytest.mark.parametrize("case", MOE_CASES, ids=[c[0] for c in MOE_CASES])
def test_moe_apply(case):
    _, spec_args, gated, zero_router, act = case
    spec_j, spec_t, params, tparams = _moe_pair(spec_args, 32, 64, 0,
                                                zero_router, gated)
    x = np.random.default_rng(1).standard_normal((2, 24, 32)).astype(np.float32)
    out_j, aux_j = JM.moe_apply(jnp.asarray(x), params, spec_j, act=act,
                                compute_dtype=jnp.float32)
    out_t, aux_t = TM.moe_apply(torch.as_tensor(x), tparams, spec_t, act=act,
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), **MOE_TOL)
    for k in ("lb_loss", "z_loss", "drop_frac"):
        np.testing.assert_allclose(float(aux_t[k]), float(aux_j[k]),
                                   err_msg=k, **MOE_TOL)
    if spec_args[2] < 1.0:
        assert float(aux_t["drop_frac"]) > 0.1, "the case must drop tokens"


def test_top_k_takes_the_lower_index_on_ties():
    x = np.array([[1.0, 3.0, 3.0, 0.5, 3.0]], np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(x), 3)
    vals_t, idx_t = TM.top_k(torch.as_tensor(x), 3)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(idx_t.numpy(), [[1, 2, 4]])
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


def test_capacity_and_init():
    for S, args in [(4096, (8, 2, 1.25)), (1, (128, 2, 1.0)), (64, (4, 2, 0.5))]:
        assert TM.capacity(S, TM.MoESpec(*args)) == JM.capacity(
            S, JM.MoESpec(*args))
    gen = torch.Generator().manual_seed(0)
    p = TM.moe_init(gen, 32, 64, TM.MoESpec(4), torch.bfloat16)
    assert p["router"].dtype == torch.float32            # router in fp32
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (32, 4), "wi": (4, 32, 64), "wg": (4, 32, 64),
        "wo": (4, 64, 32)}
    assert p["wi"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "arctic-480b",
                                  "internvl2-76b"])
def test_prefill_and_decode_match_reference(arch):
    assert_lm_prefill_decode(arch)
