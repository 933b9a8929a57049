"""The frozen reference against the port's service on the CPU, at a tiny
ring: bit for bit, every field, on every path the cells use."""
import math

import pytest
import torch

from bench import check, traffic
from bench.reference import pdes as ref
from repro_torch.experiments.sweep import WindowSweep
from repro_torch.service.api import SweepService


def _request(**kw):
    q = dict(Ls=[48], n_vs=[10], deltas=[1.0, 4.0, math.inf], replicas=3,
             n_steps=40, burn_in=24, backend="pallas_multistep",
             window="exact", k_fuse=16, rd_mode=False, border_both=False,
             steady_frac=0.5, seed=2**32 - 5)
    q.update(kw)
    return q


def _served(reqs):
    """Responses of one service to ``reqs``, submitted in turn."""
    svc = SweepService(device="cpu")
    out = []
    for i, q in enumerate(reqs):
        svc.submit(WindowSweep(**{f: q[f] for f in traffic.SPEC_FIELDS}),
                   requester=f"r{i}")
        out += svc.drain()
    return [[{"L": r.L, "n_v": r.n_v, "delta": r.delta,
              **{f: getattr(r, f) for f in ref.RECORD_FIELDS}}
             for r in resp.result.records] for resp in out]


CASES = {
    "b1_exact": dict(),
    "b2_stale": dict(backend="pallas", window="stale"),
    "plain_exact": dict(backend="reference"),
    "border_both": dict(border_both=True, n_vs=[3]),
    "no_burn_in": dict(burn_in=0),
    "remainder_chunk": dict(n_steps=37, burn_in=21),
}


@pytest.mark.parametrize("case", CASES)
def test_reference_equals_the_service(case):
    q = _request(**CASES[case])
    longer = dict(q, n_steps=2 * q["n_steps"])          # state-cache hits
    other = dict(q, deltas=[4.0, 16.0])                   # shares rows
    reqs = [q, longer, other, q]
    got = _served(reqs)
    want = check.reference_records(reqs, "cpu")
    assert check.compare(got, want) == {"max_rel_gap": 0.0,
                                        "exact_fields_differ": 0}


def test_rows_in_blocks_equal_rows_at_once():
    kw = dict(L=32, n_v=10, k_fuse=16, window="exact", seed=3, burn_in=16,
              n_steps=32, trials=[0, 1, 2, 5], deltas=[1.0, 2.0, 4.0,
                                                         math.inf],
              device="cpu")
    whole = ref.run_rows(**kw)
    blocks = ref.run_rows(block_elems=64, **kw)
    for f in whole:
        assert (whole[f] == blocks[f]).all(), f


def test_the_control_is_not_the_reference():
    reqs = [_request(n_steps=64)]
    want = check.reference_records(reqs, "cpu")
    got = check.reference_records(reqs, "cpu", dtype=torch.bfloat16)
    numbers = check.compare(got, want)
    assert numbers["exact_fields_differ"] > 0
    assert numbers["max_rel_gap"] > 1e-2


def test_compare_flags_missing_wrong_and_nan():
    want = check.reference_records([_request()], "cpu")
    ok = check.compare(want, want)
    assert ok == {"max_rel_gap": 0.0, "exact_fields_differ": 0}
    assert check.compare([None], want)["max_rel_gap"] == math.inf
    bad = [[dict(r) for r in want[0]]]
    bad[0][0]["u"] = math.nextafter(bad[0][0]["u"], 1.0)
    bad[0][1]["w2"] *= 1.001
    numbers = check.compare(bad, want)
    assert numbers["exact_fields_differ"] == 1
    assert numbers["max_rel_gap"] == pytest.approx(1e-3)
    bad[0][2]["wa"] = math.nan
    assert check.compare(bad, want)["max_rel_gap"] == math.inf
    assert not check.judge(numbers, {"max_rel_gap": 1e-2,
                                     "exact_fields_differ": 0})
    assert check.judge(ok, {"max_rel_gap": 0.0, "exact_fields_differ": 0})
