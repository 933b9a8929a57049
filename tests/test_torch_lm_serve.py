"""The port's ``ServeEngine`` against ``repro``'s on the reduced llama, with
JAX's weights carried across by the bridge.

Lanes 2 and 4, Δ 8 and 16, prompts of mixed lengths so that batches are
left-padded.  Tokens must equal ``repro``'s token for token; where one
differs, the reference's top-2 logit gap at that token must be below
``NEAR_TIE`` (a near-tie that fp32 rounding may flip), and the rest of that
request is not compared.  Lane utilization is equal exactly: the lane gate
draws from the same seeded stream and the stop rule counts tokens only.
"""
import numpy as np
import pytest
import torch

from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.serve import Request, ServeEngine
from torch_parity import lm_pair

NEAR_TIE = 1e-4


def _requests(vocab, n=7, seed=5):
    rng = np.random.default_rng(seed)
    return [(uid, rng.integers(0, vocab, int(rng.integers(4, 25))).astype(
        np.int32), int(rng.integers(8, 41))) for uid in range(n)]


def _recording_engine(jm, params, **kw):
    """``repro``'s engine, with each batch's logits rows and lane masks
    recorded: ``log`` holds per batch its uids, the prefill's and each
    step's logits, and each step's mask (``None`` for the prefill)."""
    eng = JServeEngine(jm, params, **kw)
    log = []
    prefill, decode, offer = eng._prefill_batch, eng._decode, eng.scheduler.offer

    def rec_prefill(reqs):
        out = prefill(reqs)
        log.append(dict(uids=[r.uid for r in reqs], budgets=[
            r.max_new_tokens for r in reqs], logits=[np.asarray(out[0])],
            masks=[None]))
        return out

    def rec_decode(*args):
        logits, cache = decode(*args)
        log[-1]["logits"].append(np.asarray(logits))
        return logits, cache

    def rec_offer(*args):
        mask = offer(*args)
        log[-1]["masks"].append(mask[:len(log[-1]["uids"])].copy())
        return mask

    eng._prefill_batch, eng._decode, eng.scheduler.offer = (
        rec_prefill, rec_decode, rec_offer)
    return eng, log


def _token_logits(log):
    """{uid: [the reference logits row each output token came from]}."""
    rows = {}
    for batch in log:
        for i, (uid, budget) in enumerate(zip(batch["uids"], batch["budgets"])):
            rows[uid] = [batch["logits"][0][i]]
            for mask, logits in zip(batch["masks"][1:], batch["logits"][1:]):
                if mask[i] and len(rows[uid]) < budget:
                    rows[uid].append(logits[i])
    return rows


@pytest.mark.parametrize("lanes,delta", [(2, 8.0), (2, 16.0), (4, 8.0),
                                         (4, 16.0)])
def test_serve_engine_matches_reference(lanes, delta):
    jm, params, model = lm_pair("llama3.2-1b")
    reqs = _requests(jm.cfg.vocab_size)
    ref, log = _recording_engine(jm, params, batch_lanes=lanes, max_len=128,
                                 delta=delta)
    port = ServeEngine(model, batch_lanes=lanes, max_len=128, delta=delta,
                       device="cpu")
    for uid, prompt, n in reqs:
        ref.submit(JRequest(uid, prompt, n))
        port.submit(Request(uid, prompt, n))
    want, got = ref.run(), port.run()
    assert sorted(got) == sorted(want) == [r[0] for r in reqs]
    assert any(len(b["uids"]) > 1 and len({len(reqs[u][1]) for u in b["uids"]})
               > 1 for b in log), "no batch was padded"
    rows = _token_logits(log)
    for uid, prompt, budget in reqs:
        a, b = got[uid].tokens, want[uid].tokens
        assert len(a) == len(b) and 1 <= len(a) <= budget
        assert all(0 <= t < jm.cfg.vocab_size for t in a)
        assert [int(np.argmax(r)) for r in rows[uid]] == b
        for t, (x, y) in enumerate(zip(a, b)):
            if x != y:
                top2 = np.sort(rows[uid][t])[-2:]
                assert top2[1] - top2[0] < NEAR_TIE, (uid, t, top2)
                break
    assert port.lane_utilization == ref.lane_utilization
    assert 0.0 < port.lane_utilization <= 1.0


def test_serve_engine_runs_on_the_gpu_by_default(monkeypatch):
    _, _, model = lm_pair("llama3.2-1b")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, batch_lanes=2, max_len=64)


def test_example_serves_on_the_cpu(capsys):
    """``examples/serve_lm_torch.py --device cpu`` runs end to end."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "serve_lm_torch.py"
    spec = importlib.util.spec_from_file_location("serve_lm_torch", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    example.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.count("request ") == 8
    assert "lane utilization" in out and "on cpu" in out
