"""The port's ``EncDecModel`` (whisper) against ``repro``'s, in fp32, with
JAX's weights carried across by the bridge.

``prefill`` (encode, the cross K/V, zero logits) and 8 decode steps from
position 0, every cache leaf at rtol 1e-4
(``torch_parity.assert_lm_prefill_decode``); the three clamps the
reference makes implicitly: the self-attention slot at ``max_len - 1``,
the attention over every slot once ``pos + 1 > max_len``, and the learned
position at ``pos_table_len - 1``; ``encode`` and the cross-attention
helpers on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as JE
from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.models import encdec as TE
from torch_parity import LM_ATOL, LM_RTOL, LMPair, assert_lm_prefill_decode


@pytest.fixture(scope="module")
def whisper():
    return LMPair("whisper-base")


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LM_RTOL,
                               atol=LM_ATOL, err_msg=what)


@pytest.mark.parametrize("S", [32, 64])
def test_prefill_and_decode_match_reference(whisper, S):
    assert_lm_prefill_decode(whisper, S=S)


@pytest.mark.parametrize("max_decode_len,pos0,steps", [
    (4, 0, 8),          # the slot clamps at 3 from pos 4 on; every slot valid
    (8, 125, 6),        # pos_table_len 128: positions 128+ read row 127
])
def test_decode_clamps_match_reference(whisper, max_decode_len, pos0, steps):
    assert whisper.cfg.pos_table_len == 128
    assert_lm_prefill_decode(whisper, S=32, steps=steps, pos0=pos0,
                             max_decode_len=max_decode_len)


def test_slot_clamp_overwrites_the_last_slot(whisper):
    model = whisper.model
    enc = (np.random.default_rng(2).standard_normal((2, 32, 64))
           * 0.1).astype(np.float32)
    _, cache = model.prefill({"enc_embeddings": torch.as_tensor(enc)},
                             max_decode_len=4)
    tok = torch.zeros((2, 1), dtype=torch.long)
    for pos in range(6):
        before = cache["k"].clone()
        _, cache = model.decode_step(cache, tok, pos)
        slot = min(pos, 3)
        assert not torch.equal(cache["k"][:, :, slot], before[:, :, slot])
        keep = [s for s in range(4) if s != slot]
        assert torch.equal(cache["k"][:, :, keep], before[:, :, keep])


def test_encode_and_cross_attention_match_reference(whisper):
    cfg, jcfg = whisper.model.cfg, whisper.cfg
    rng = np.random.default_rng(5)
    enc_in = (rng.standard_normal((2, 64, 64)) * 0.1).astype(np.float32)
    jenc = jax.jit(lambda p, e: whisper.jm.encode(p, e))(
        whisper.params, jnp.asarray(enc_in))
    tenc = whisper.model.encode(torch.as_tensor(enc_in))
    _close(tenc, jenc, "encode")
    p = jax.tree.map(lambda a: a[0], whisper.params["dec_layers"]["xattn"])
    tp = jax.tree.map(lambda a: torch.as_tensor(np.array(a)), p)
    noop = lambda h, kind: h  # noqa: E731
    f32 = jnp.float32
    jk, jv = JE._cross_kv(jenc, p, jcfg, f32, noop)
    tk, tv = TE._cross_kv(tenc, tp, cfg, torch.float32, noop)
    _close(tk, jk, "cross k")
    _close(tv, jv, "cross v")
    x = (rng.standard_normal((2, 32, 64)) * 0.5).astype(np.float32)
    _close(TE._cross_apply(torch.as_tensor(x), tk, tv, tp, cfg, torch.float32,
                           noop),
           JE._cross_apply(jnp.asarray(x), jk, jv, p, jcfg, f32, noop),
           "cross apply")
    _close(TE._cross_decode(torch.as_tensor(x[:, :1]), tk, tv, tp, cfg,
                            torch.float32),
           JE._cross_decode(jnp.asarray(x[:, :1]), jk, jv, p, jcfg, f32),
           "cross decode")


def test_model_runs_on_the_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("whisper-base").reduced())
