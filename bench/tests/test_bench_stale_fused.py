"""The stale window on B1 as a cell: ``stale_fused_mix.ring1m``'s rounds,
the frozen reference's stale rows against the port's service and its
stale ``reference`` engine at a tiny ring, and the readers of
``b1_roofline`` and ``b1d_roofline`` on synthetic records."""
import itertools
import json
import math

import pytest
import torch
from conftest import ROOT
from test_bench_reference import _request, _served

from bench import check, harness, traffic
from bench.reference import pdes as ref

SEEDS = (0, 2**31 + 12345, 2**40 + 7)


def _rounds(root, name, seed, n=4):
    cell = harness.load_cell(root, name)
    return list(itertools.islice(
        traffic.rounds(cell["config"], cell["mix"], cell["cell"], seed), n))


def test_stale_fused_mix_is_the_exact_mix_in_the_stale_window(full_root):
    """stale_fused_mix.ring1m's rounds are exact_mix.ring1m's, request for
    request and seed for seed, but for the window: stale on B1."""
    for seed in SEEDS:
        stale = _rounds(full_root, "stale_fused_mix.ring1m", seed)
        exact = _rounds(full_root, "exact_mix.ring1m", seed)
        assert [[dict(q, window="exact") for q in r] for r in stale] == exact
        for q in (q for r in stale for q in r):
            assert (q["backend"], q["window"]) == ("pallas_multistep",
                                                   "stale")
    by = {q["requester"]: q for q in _rounds(
        full_root, "stale_fused_mix.ring1m", 3, 2)[1]}
    assert sum(traffic.rows(by[w]) for w in ("alice", "bob")) == 28
    assert traffic.rows(by["dave"]) == 16
    assert (by["alice"]["Ls"], by["alice"]["burn_in"],
            by["alice"]["n_steps"], by["dave"]["n_steps"],
            by["alice"]["k_fuse"]) == ([1 << 20], 512, 512, 1024, 16)


def test_ring1m_stale_is_ring1m_in_its_mixs_window(full_root):
    """The cell's configuration, ring1m_stale, holds every number of
    ring1m and its cuts, and states the window that its mix gives the
    service; only its source and its window set it apart."""
    cell = harness.load_cell(full_root, "stale_fused_mix.ring1m")
    conf = cell["config"]
    ring1m = harness.load_cell(full_root, "exact_mix.ring1m")["config"]
    assert conf["name"] == "ring1m_stale"
    assert conf["window"] == cell["mix"]["window"] == "stale"
    for key, val in ring1m.items():
        if key not in ("name", "about", "guarantees", "source", "assumed"):
            assert conf[key] == val, key
    assert conf["source"] != ring1m["source"]
    spec = json.loads((full_root / "BENCHMARK.json").read_text())
    entry = {c["name"]: c for c in spec["configs"]}["ring1m_stale"]
    assert (entry["source"], entry["reduced"]) == (conf["source"],
                                                   conf["reduced"])


STALE_CASES = {
    "b1_stale": dict(window="stale"),
    "b1_stale_remainder": dict(window="stale", n_steps=37, burn_in=21),
    "plain_stale": dict(backend="reference", window="stale"),
}


@pytest.mark.parametrize("case", STALE_CASES)
def test_reference_equals_the_stale_service(case):
    """The service's stale answers on B1 (its plain version on the CPU)
    and on the port's plain engine, a duplicate, state-cache extensions
    and a request that shares rows: bit for bit the reference's."""
    q = _request(**STALE_CASES[case])
    longer = dict(q, n_steps=2 * q["n_steps"])
    other = dict(q, deltas=[4.0, 16.0])
    reqs = [q, longer, other, q]
    got = _served(reqs)
    want = check.reference_records(reqs, "cpu")
    assert check.compare(got, want) == {"max_rel_gap": 0.0,
                                        "exact_fields_differ": 0}
    exact = check.reference_records([dict(q, window="exact")], "cpu")
    assert check.compare(got[:1], exact)["exact_fields_differ"] > 0


def test_reference_stale_rows_equal_the_port_engine():
    """``run_rows(window="stale")`` against the port's stale ``reference``
    engine, field by field of the reduction's inputs, at L = 48 over a
    remainder chunk in the burn-in and in the record."""
    from repro_torch.core.engine import PDESEngine
    from repro_torch.core.horizon import PDESConfig
    L, K, seed = 48, 8, 77
    trials, deltas = [0, 3, 5, 2**32 - 1], [1.0, 4.0, math.inf, 0.5]
    rows = ref.run_rows(L=L, n_v=10, k_fuse=K, window="stale", seed=seed,
                        burn_in=21, n_steps=37, trials=trials, deltas=deltas,
                        device="cpu")
    eng = PDESEngine(PDESConfig(L=L, n_v=10), backend="reference",
                     window="stale", k_fuse=K, device="cpu")
    d = torch.tensor(deltas)
    t = torch.tensor(trials, dtype=torch.int64)
    st = eng.burn_in(eng.init(4), seed, 21, deltas=d, trial_base=t)
    _, stats = eng.run(st, seed, 37, deltas=d, trial_base=t)
    for f in ("utilization", "gvt"):
        assert (rows[f] == getattr(stats, f).numpy()).all(), f
    for f in ("w2", "wa", "max_dev", "min_dev"):
        assert rows[f] == pytest.approx(getattr(stats, f).numpy(),
                                        rel=1e-5, abs=1e-5), f


def _metric(name):
    return harness.metric_reader(ROOT / "bench", name)


@pytest.mark.parametrize("flags", ["false, false, false",
                                   "false, false, true"])
def test_b1_roofline_reads_the_stale_window_kernels(flags):
    """B1's kernels with the window flag (``kStale``, false or true) are
    B1: ``b1_roofline`` takes their device time as it takes the names
    without it; ``b1d_roofline`` the stream tier's."""
    card = {"sms": 132, "clock_hz": 1.98e9, "clock_from": "card",
            "hbm_bytes_per_s": 3e12}
    rec = {"stats": {"engine_row_steps": 1000},
           "spans": [{"name": "pass", "args": {
               "L": 1 << 20, "n_rows": 10, "n_pad": 0, "n_steps": 100,
               "rows_burned": 0, "burn": 0}}],
           "config": {"L": 1 << 20, "n_v": 100, "k_fuse": 16}, "card": card,
           "responses": [{"request": {"replicas": 1, "burn_in": 0,
                                      "n_steps": 16},
                          "records": [{"L": 1 << 20, "u": 0.5}]}]}
    got = {}
    for args in ("false, false", flags):
        rec["device_ops"] = {
            f"multistep_counter_grid_kernel<{args}>": 0.25,
            f"multistep_counter_stream_kernel<{args}>": 0.5}
        got[args] = (_metric("b1_roofline")(rec),
                     _metric("b1d_roofline")(rec))
    assert got["false, false"] == got[flags]
    assert got[flags][0] == pytest.approx(2 * got[flags][1])
