"""The dry run's trip-count-aware count (``launch.cost.scan``) against the
full trace, on one fake rank.

A dry run on fake tensors counts a loop's body once and scales it by the
trip count, as the reference's HLO cost does; ``CostCounter(scale_loops=
False)`` traces every iteration.  On reduced dense (llama3.2-1b) and
hybrid (zamba2-2.7b) archs, five layer groups deep and 128 tokens long
(4 flash q blocks of 4 kv tiles, 4 cross-entropy chunks, 8 SSD chunks),
the scaled count of a train, prefill and decode step equals the full
trace's: products, eager bytes, collective bytes and messages to a
relative 1e-9, the peak within 1%.  ``test_torch_scan_cost_sharded.py``
does the same on a ``(2, 2)`` mesh of four fake ranks.

Fake process groups are process-global, so the cells run in a subprocess.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.launch.cost import CostCounter, scan
from torch_parity import SRC

SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import lower_cell
    from repro_torch.launch.mesh import fake_world, make_host_mesh

    world, archs, remat = int(sys.argv[1]), sys.argv[2].split(","), sys.argv[3]
    kinds = sys.argv[4].split(",")
    out = {}
    with fake_world(world):
        mesh = make_host_mesh((2, 2) if world == 4 else (1, 1))
        for arch in archs:
            r = get_config(arch).reduced()
            r = dataclasses.replace(
                r, n_layers=(r.hybrid_period or r.group_size) * 5,
                remat=remat)
            over = {f.name: getattr(r, f.name)
                    for f in dataclasses.fields(r)}
            for kind in kinds:
                shape = ShapeConfig(kind + "_t", 128, 4, kind)
                for scale in (True, False):
                    rec, cost = lower_cell(arch, shape, mesh, overrides=over,
                                           scale_loops=scale)
                    out[f"{arch}:{kind}:{scale}"] = dict(
                        flops=cost.flops, bytes=cost.bytes,
                        coll=cost.coll, msgs=cost.coll_msgs,
                        peak=rec["memory"]["peak_gib"], s=rec["lower_s"])
    print(json.dumps(out))
""")


def run_cells(world: int, archs, remat: str = "none",
              kinds=("train", "prefill", "decode")) -> dict:
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(world), ",".join(archs), remat,
         ",".join(kinds)],
        env=dict(os.environ, PYTHONPATH=str(SRC)), capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    return json.loads(proc.stdout.splitlines()[-1])


def assert_scaled_equals_full(out: dict) -> None:
    cells = {k.rsplit(":", 1)[0] for k in out}
    for cell in sorted(cells):
        got, want = out[cell + ":True"], out[cell + ":False"]
        for k in ("flops", "bytes", "msgs"):
            assert got[k] == pytest.approx(want[k], rel=1e-9, abs=0), \
                (cell, k, got[k], want[k])
        for kind, v in want["coll"].items():
            assert got["coll"][kind] == pytest.approx(v, rel=1e-9, abs=0), \
                (cell, kind)
        assert got["peak"] == pytest.approx(want["peak"], rel=0.01), \
            (cell, got["peak"], want["peak"])


@pytest.mark.parametrize("arch", ["llama3.2-1b", "zamba2-2.7b"])
def test_scaled_count_equals_full_trace_one_rank(arch):
    assert_scaled_equals_full(run_cells(1, [arch]))


def test_scan_is_the_plain_loop_without_a_fake_counter():
    """No counter, or one counting real tensors: every iteration runs."""
    calls = []

    def body(i, carry):
        calls.append(i)
        return carry + i, carry * 2

    x = torch.tensor(1.0)
    carry, ys = scan(body, x, 6)
    with CostCounter():
        carry2, ys2 = scan(body, x, 6)
    assert calls == list(range(6)) * 2
    assert torch.equal(carry, carry2) and carry.item() == 16.0
    assert [y.item() for y in ys] == [2, 2, 4, 8, 14, 22]
    assert all(torch.equal(a, b) for a, b in zip(ys, ys2))
