"""Configurations that name a grid of (L, N_V) points: a request's points
and PE-steps, a run's comparison with the reference point by point, the
PE-steps of a traced window summed over the passes' ring lengths; and,
for every configuration of one point, the rounds, the PE-steps and the
compared numbers as they were before grids came in."""
import hashlib
import itertools
import json
import math
import time

import pytest
from conftest import TINY_L_ONE_BLOCK, TINY_L_SPLIT

import repro_torch.service.api as api
from bench import calibrate, check, harness, roofline, traffic
from repro_torch import obs as tobs
from repro_torch.service.api import SweepService

GRID = "exact_mix.size_grid"
SEED = 2**31 + 4242

#: Of each cell of one point, as the harness gave them before it took
#: grids (seed ``SEED``, ``tests/conftest.py``'s sizes): the sha256 of the
#: first three rounds' JSON, their requests' PE-steps (each round's
#: distinct values), the control's numbers at the tiny size on seed 5, and
#: the engine's row-steps and ``roofline.pe_steps`` of the tiny size's
#: first two rounds, traced.
BEFORE = {
    "exact_mix.ring10k": (
        "9fbb92604bb0984e16afbff90338c46bf63e500ce0d7147dfe2d8cc9473f81ae",
        [9830400000, 13107200000, 15728640000],
        {"max_rel_gap": 11.305881114273076, "exact_fields_differ": 60},
        2304, 147456),
    "exact_mix.ring1m": (
        "eb99167c96c1846868442f89f7f3fafbd7510565b146e1317db934b95fc78d8a",
        [12884901888, 17179869184, 25769803776],
        {"max_rel_gap": 2895.309326171875, "exact_fields_differ": 60},
        2304, 221184),
    "exact_mix.ring512k": (
        "77c47136772df85ccdd244474e886439d45c98ef0a622dac2dcfa7a11deb54a0",
        [6442450944, 8589934592, 12884901888],
        {"max_rel_gap": 2895.309326171875, "exact_fields_differ": 60},
        2304, 221184),
    "growth_mix.ring1m": (
        "cb0f4d938c4d53bd51e9dc3df5f601c3951e32b360c6e92af6a7fb1792a40123",
        [4294967296, 6442450944],
        {"max_rel_gap": math.inf, "exact_fields_differ": 28},
        640, 61440),
    "exact_mix.ring8m": (
        "39958a3a0507a1059b508c16f8e047ef9c601d9a7265e7f6593dfab7cdece126",
        [25769803776, 34359738368, 51539607552],
        {"max_rel_gap": 2895.309326171875, "exact_fields_differ": 60},
        2304, 221184),
    "stale_fused_mix.ring1m": (
        "4619faeb56e11043acf4610b4540e66188c3199c4ad0054232f552d1aa009f56",
        [12884901888, 17179869184, 25769803776],
        {"max_rel_gap": 2895.309326171875, "exact_fields_differ": 60},
        2304, 221184),
    "stale_mix.ring10k": (
        "6e55ed909248ca0659acf585553876eb89e2ea03d273382dee31ef0cf9becd21",
        [122880000, 184320000, 245760000],
        {"max_rel_gap": 96.76219289178071, "exact_fields_differ": 66},
        3456, 221184),
}


def _rounds(root, name, n=3, seed=SEED):
    cell = harness.load_cell(root, name)
    return list(itertools.islice(traffic.rounds(
        cell["config"], cell["mix"], cell["cell"], seed), n))


def _traced(root, name, n=2, keep=None):
    """The record of ``n`` rounds served on the CPU with the service's
    spans: ``stats``, the ``pass`` spans and the configuration; ``keep``
    picks a request's points (a one-point request each) before it goes."""
    cell = harness.load_cell(root, name)
    svc = SweepService(device="cpu", state_cache_rows=int(
        cell["config"]["state_cache_rows"]))
    tracer = tobs.TraceRecorder()
    svc.attach_telemetry(tobs.Telemetry(tracer=tracer))
    gen = traffic.rounds(cell["config"], cell["mix"], cell["cell"], SEED)
    for _ in range(n):
        for q in next(gen):
            for p in (keep(q) if keep else [q]):
                svc.submit(harness._spec(p), requester=p["requester"])
        svc.drain()
    return {"stats": svc.stats.as_dict(), "config": cell["config"],
            "spans": [e for e in tracer.events if e["name"] == "pass"]}


@pytest.mark.parametrize("name", BEFORE)
def test_rounds_and_pe_steps_of_one_point_as_before(full_root, name):
    digest, pe_steps, _, _, _ = BEFORE[name]
    rnds = _rounds(full_root, name)
    assert hashlib.sha256(json.dumps(rnds, sort_keys=True).encode()
                          ).hexdigest() == digest
    assert sorted({traffic.pe_steps(q) for r in rnds for q in r}) == pe_steps


@pytest.mark.parametrize("name", BEFORE)
def test_compared_numbers_and_traced_pe_steps_as_before(tiny_root, name):
    _, _, control, row_steps, pe_steps = BEFORE[name]
    assert calibrate.control_numbers(tiny_root, name, 5, "cpu") == control
    rec = _traced(tiny_root, name)
    assert rec["stats"]["engine_row_steps"] == row_steps
    assert roofline.pe_steps(rec) == pe_steps


def test_a_grid_request_carries_the_grid_and_numbers_its_points(full_root):
    conf = harness.load_cell(full_root, GRID)["config"]
    Ls, n_vs = traffic.grid(conf)
    assert Ls == [64, 128, 256, 512, 1024, 2048, 2**20]
    assert n_vs == [1, 10, 100]
    r0, r1 = _rounds(full_root, GRID, 2)
    assert [q["requester"] for q in r1] == ["alice", "bob", "carol", "dave"]
    for q in r0 + r1:
        assert (q["Ls"], q["n_vs"]) == (Ls, n_vs)
    alice = r1[0]
    pts = check.points(alice)
    assert len(pts) == 21 and pts[0] == (64, 1, 0)
    assert pts[1] == (64, 10, 12) and pts[3] == (128, 1, 36)
    assert pts[-1] == (2**20, 100, 20 * 12)
    # the PE-steps of the grid are its points', each a request of one
    one = [dict(alice, Ls=[L], n_vs=[n_v]) for L, n_v, _ in pts]
    assert traffic.pe_steps(alice) == sum(map(traffic.pe_steps, one)) == \
        sum(Ls) * 3 * 3 * 4 * (512 + 512)
    assert traffic.rows(alice) == 21 * 12


def test_a_configuration_names_one_point_or_a_grid():
    assert traffic.grid({"L": 64, "n_v": 10}) == ([64], [10])
    assert traffic.grid({"Ls": [64, 96], "n_vs": [1, 3]}) == \
        ([64, 96], [1, 3])
    for bad in ({"L": 64, "n_v": 10, "Ls": [64], "n_vs": [10]}, {},
                {"Ls": [64, 64], "n_vs": [1]}):
        with pytest.raises(ValueError):
            traffic.grid(bad)


def test_the_reference_takes_a_grid_as_its_points_one_by_one():
    q = dict(Ls=[16, 24], n_vs=[1, 3], deltas=[1.0, math.inf], replicas=2,
             n_steps=32, burn_in=16, backend="pallas_multistep",
             window="exact", k_fuse=16, rd_mode=False, border_both=False,
             steady_frac=0.5, seed=2**32 - 9)
    whole = check.reference_records([q], "cpu")[0]
    assert [(r["L"], r["n_v"]) for r in whole] == \
        [(16, 1)] * 2 + [(16, 3)] * 2 + [(24, 1)] * 2 + [(24, 3)] * 2
    # a point alone, its trials moved to where the grid puts them
    from bench.reference import pdes as ref
    trials, deltas = ref.request_rows(q["deltas"], q["replicas"])
    stats = ref.run_rows(L=24, n_v=1, k_fuse=16, window="exact",
                         seed=q["seed"], burn_in=16, n_steps=32,
                         trials=trials + 2 * 4, deltas=deltas, device="cpu")
    assert [dict(r, L=24, n_v=1) for r in ref.records(
        stats, q["deltas"], 2)] == whole[4:6]


def test_a_grid_run_is_correct(tiny_root, tmp_path):
    Ls, n_vs = traffic.grid(harness.load_cell(tiny_root, GRID)["config"])
    assert (Ls, n_vs) == ([TINY_L_ONE_BLOCK, TINY_L_SPLIT], [1, 10, 100])
    res = harness.run(tiny_root, GRID, 2**31 + 21, 0.3, False, device="cpu",
                      out_dir=tmp_path, t_start=time.perf_counter())
    assert res["correct"] is True and res["failed"] == 0
    assert res["checks"]["exact_fields_differ"]["value"] == 0
    assert res["checks"]["max_rel_gap"]["value"] == 0.0


def test_a_response_with_its_points_swapped_is_not_correct(
        tiny_root, tmp_path, monkeypatch):
    result = api.SweepResult

    def swapped(spec, records):
        # the points in reverse: each in another's place, whichever the
        # check draws
        n = len(spec.deltas)
        blocks = [records[i:i + n] for i in range(0, len(records), n)]
        blocks.reverse()
        return result(spec=spec, records=tuple(itertools.chain(*blocks)))

    monkeypatch.setattr(api, "SweepResult", swapped)
    res = harness.run(tiny_root, GRID, 2**31 + 21, 0.3, False, device="cpu",
                      out_dir=tmp_path, t_start=time.perf_counter())
    assert res["correct"] is False
    assert res["checks"]["max_rel_gap"]["value"] == "inf"
    assert res["checks"]["exact_fields_differ"]["value"] == "inf"


def test_traced_pe_steps_of_a_grid_sum_its_ring_lengths(tiny_root):
    """A grid's passes counted by the spans' ring lengths equal the same
    requests sent point by point to services of one ring length each."""
    rec = _traced(tiny_root, GRID)
    Ls, n_vs = traffic.grid(rec["config"])
    by_L = {}
    for L in Ls:
        alone = _traced(tiny_root, GRID, keep=lambda q, L=L: [
            dict(q, Ls=[L], n_vs=[n_v]) for n_v in n_vs])
        by_L[L] = alone["stats"]["engine_row_steps"]
    assert roofline.row_steps(rec) == by_L
    assert sum(by_L.values()) == rec["stats"]["engine_row_steps"]
    assert roofline.pe_steps(rec) == sum(L * n for L, n in by_L.items())


def test_utilization_weighs_records_by_their_ring_length():
    q = {"replicas": 2, "burn_in": 10, "n_steps": 30}
    resp = [{"request": q, "records": [{"L": 100, "u": 0.2},
                                       {"L": 300, "u": 0.6}]}]
    assert roofline.utilization(resp) == pytest.approx(0.5)


def test_a_grid_check_draws_n_vs_at_every_ring_length():
    conf = {"Ls": [64, 96, 128], "n_vs": [1, 10, 100]}
    keep = check.drawn(conf, 5)
    assert sorted(k // 3 for k in keep) == [0, 1, 2]
    assert keep == check.drawn(conf, 5)
    # over seeds, every point is drawn
    assert set().union(*(check.drawn(conf, s) for s in range(40))) == \
        set(range(9))
    assert check.drawn({"L": 64, "n_v": 10}, 5) is None
    assert check.drawn({"Ls": [64, 96], "n_vs": [10]}, 5) is None


def test_the_reference_at_drawn_points_is_the_whole_grid_at_them():
    q = dict(Ls=[16, 24], n_vs=[1, 3], deltas=[1.0, math.inf], replicas=2,
             n_steps=32, burn_in=16, backend="pallas_multistep",
             window="exact", k_fuse=16, rd_mode=False, border_both=False,
             steady_frac=0.5, seed=2**32 - 9)
    whole = check.reference_records([q], "cpu")[0]
    part = check.reference_records([q], "cpu", keep={1, 2})[0]
    assert [(r["L"], r["n_v"]) for r in part] == \
        [(16, 3)] * 2 + [(24, 1)] * 2
    assert part == whole[2:6] == check.kept(whole, q, {1, 2})
    assert check.kept(whole, q) is whole
    assert check.kept(whole[:-1], q, {1, 2}) == whole[:-1]
    assert check.compare([check.kept(whole[:-1], q, {1, 2})], [part]) == \
        {"max_rel_gap": math.inf, "exact_fields_differ": math.inf}


def test_a_traced_grid_run_profiles_the_rounds_its_cell_names(
        tiny_root, tmp_path):
    """``trace_rounds`` rounds are traced after one untraced round (which
    has no extension): 3 + 4 x 5 requests, whatever ``--seconds``."""
    cell = harness.load_cell(tiny_root, GRID)["cell"]
    assert cell["trace_rounds"] == 5
    res = harness.run(tiny_root, GRID, 2**31 + 23, 0.01, True, device="cpu",
                      out_dir=tmp_path, t_start=time.perf_counter())
    assert res["correct"] is True
    assert res["attempted"] == 3 + 4 * cell["trace_rounds"]
