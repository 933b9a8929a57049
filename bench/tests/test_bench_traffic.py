"""The traffic generator: each mix's rounds are a function of the seed."""
import itertools

import pytest
from conftest import full_spec

from bench import check, harness, traffic

WORKLOADS = [w["name"] for w in full_spec()["workloads"]]
SEEDS = (0, 2**31 + 12345, 2**40 + 7)


def _rounds(root, name, seed, n=4, warm=False):
    cell = harness.load_cell(root, name)
    gen = traffic.rounds(cell["config"], cell["mix"], cell["cell"], seed,
                         warm=warm)
    return list(itertools.islice(gen, n))


@pytest.mark.parametrize("name", WORKLOADS)
def test_same_seed_same_rounds(full_root, name):
    for seed in SEEDS:
        assert _rounds(full_root, name, seed) == \
            _rounds(full_root, name, seed)


@pytest.mark.parametrize("name", WORKLOADS)
def test_seeds_change_streams_not_sizes(full_root, name):
    runs = [_rounds(full_root, name, seed) for seed in SEEDS]
    streams = {q["seed"] for rnds in runs for rnd in rnds for q in rnd}
    assert len(streams) == len(SEEDS) * 4          # a fresh stream a round
    for rnds in runs:
        sizes = [sorted(traffic.pe_steps(q) for q in rnd) for rnd in rnds[1:]]
        assert sizes == [sizes[0]] * len(sizes)
        assert sizes == [sorted(traffic.pe_steps(q) for q in rnd)
                         for rnd in runs[0][1:]]


@pytest.mark.parametrize("name", WORKLOADS)
def test_warm_rounds_cut_depth_and_other_streams(full_root, name):
    cell = harness.load_cell(full_root, name)
    k = cell["config"]["k_fuse"]
    warm = _rounds(full_root, name, 5, 2, warm=True)
    timed = _rounds(full_root, name, 5, 2)
    for rnd in warm:
        for q in rnd:
            assert q["burn_in"] in (0, k)
            assert q["n_steps"] % k == 0 and q["n_steps"] <= 2 * k
    assert not ({q["seed"] for r in warm for q in r}
                & {q["seed"] for r in timed for q in r})
    assert [sorted(traffic.rows(q) for q in r) for r in warm] == \
        [sorted(traffic.rows(q) for q in r) for r in timed]


def test_exact_mix_round_shape(full_root):
    r0, r1 = _rounds(full_root, "exact_mix.ring10k", 9, 2)
    by = {q["requester"]: q for q in r1}
    assert [q["requester"] for q in r0] == ["alice", "bob", "carol"]
    assert by["carol"] == dict(by["alice"], requester="carol")
    prev = {q["requester"]: q for q in r0}["alice"]
    assert by["dave"]["seed"] == prev["seed"]
    assert by["dave"]["n_steps"] == 2 * prev["n_steps"]
    assert by["dave"]["extends"] == "alice"
    assert by["alice"]["deltas"] == [1.0, 4.0, 16.0, 64.0]
    assert traffic.rows(by["alice"]) == 256


def test_stale_mix_draws_from_the_menu(full_root):
    cell = harness.load_cell(full_root, "stale_mix.ring10k")
    menu = [traffic.as_delta(x) for x in cell["config"]["deltas"]]
    for rnd in _rounds(full_root, "stale_mix.ring10k", 3, 6):
        counts = [len(q["deltas"]) for q in rnd]
        assert counts == [2, 3, 4, 2, 3, 3]
        for q in rnd:
            assert q["window"] == "stale" and q["backend"] == "pallas"
            assert all(d in menu for d in q["deltas"])
            assert q["deltas"] == sorted(q["deltas"], key=menu.index)


def test_sample_holds_a_duplicate_and_an_extension(full_root):
    log = [[{"request": q} for q in rnd]
           for rnd in _rounds(full_root, "exact_mix.ring10k", 4, 5)]
    for seed in range(20):
        picked = [e["request"] for e in check.sample(log, seed)]
        who = [q["requester"] for q in picked]
        assert {"alice", "carol", "dave"} <= set(who)
        assert who.count("dave") == 1
        assert len({q["seed"] for q in picked}) == 1     # one stream


def test_a_delta_off_the_menu_is_refused(full_root):
    cell = harness.load_cell(full_root, "exact_mix.ring10k")
    sizes = dict(cell["cell"], deltas={"a": [3], "b": [4]})
    with pytest.raises(ValueError, match="menu"):
        next(traffic.rounds(cell["config"], cell["mix"], sizes, 0))
