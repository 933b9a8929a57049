"""B1's share of the card's SMs (``b1.sm_share``) and the counters it
reads: a pass's ``b1_block_chunks`` and ``b1_sm_chunks`` at 2^19 against a
hand count, the card's occupancy and SMs stubbed (the CPU launches
nothing, so a stand-in for B1's wrapper counts each launch as the card's
does), and the reader on synthetic records: the ratio of the sums, and
silent where no pass ran on a split tier or the program lacks the
counters."""
import pytest
from conftest import ROOT

from bench import harness

L = 1 << 19


def _pass(args):
    return {"name": "pass", "dur": 1e5, "args": args}


def _record(spans):
    return {"spans": spans, "device_ops": {}, "card": None}


def test_pass_spans_count_blocks_and_sm_steps_at_2_19(monkeypatch):
    """A 28-row and a 16-row pass at L = 2^19 (10 blocks a ring) with 13
    rings on the card at once and 132 SMs: steps times rings times 10
    blocks, and steps times the waves (3 and 2) times 132, whatever the
    chunks."""
    from repro_torch import obs as tobs
    from repro_torch.experiments.sweep import WindowSweep
    from repro_torch.kernels import pdes_multistep as pm
    from repro_torch.kernels import tiling
    from repro_torch.service import SweepService
    assert tiling.ring_plan(L).blocks == 10
    plain = pm.pdes_multistep_counter

    def counted(tau, *a, k_steps, **kw):
        out = plain(tau, *a, k_steps=k_steps, **kw)
        pm.count_card_share(*tau.shape, k_steps, "card")
        return out

    monkeypatch.setattr(pm, "pdes_multistep_counter", counted)
    monkeypatch.setattr(pm, "rings_at_once", lambda n: {L: 13}[n])
    monkeypatch.setattr(pm, "card_sms", lambda dev: {"card": 132}[dev])
    tel = tobs.Telemetry(tracer=tobs.TraceRecorder())
    svc = SweepService(device="cpu")
    svc.attach_telemetry(tel)
    common = dict(Ls=(L,), n_vs=(100,), replicas=4, burn_in=0, n_steps=4,
                  backend="pallas_multistep", k_fuse=4)
    svc.submit(WindowSweep(deltas=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0),
                           **common), requester="alice")
    svc.drain()
    svc.submit(WindowSweep(deltas=(1.0, 2.0, 4.0, 8.0),
                           **dict(common, k_fuse=2)),
               requester="dave")
    svc.drain()
    args = [e["args"] for e in tel.tracer.events if e["name"] == "pass"]
    assert [(a["n_rows"], a["n_pad"], a["b1_tier"]) for a in args] == \
        [(28, 0, tiling.ring_plan(L).tier), (16, 0, tiling.ring_plan(L).tier)]
    assert [(a["b1_block_chunks"], a["b1_sm_chunks"]) for a in args] == [
        (4 * 28 * 10, 4 * 3 * 132),         # one K = 4 chunk, 3 waves
        (4 * 16 * 10, 4 * 2 * 132)]         # two K = 2 chunks, 2 waves
    read = harness.metric_reader(ROOT / "bench", "b1.sm_share")
    got = read(_record([_pass(a) for a in args]))
    assert got == pytest.approx(100 * (1120 + 640) / (1584 + 1056))


def test_sm_share_reads_the_split_passes_and_is_silent_without_them():
    read = harness.metric_reader(ROOT / "bench", "b1.sm_share")
    grid = _pass({"b1_tier": "grid", "b1_block_chunks": 4480,
                  "b1_sm_chunks": 6336})
    dave = _pass({"b1_tier": "grid", "b1_block_chunks": 2560,
                  "b1_sm_chunks": 4224})
    block = _pass({"b1_tier": "block", "b1_block_chunks": 0,
                   "b1_sm_chunks": 0})
    assert read(_record([grid, dave, block])) == \
        pytest.approx(100 * 7040 / 10560) == pytest.approx(66.666666)
    assert read(_record([grid])) == pytest.approx(100 * 280 / 396)
    assert read(_record([block])) is None       # no split tier ran
    assert read(_record([_pass({"b1_tier": "cluster",
                                "b1_offchip_bytes": 0})])) is None  # parent
    assert read(_record([])) is None
