"""Shared fixtures of the benchmark's tests: the paths, and a copy of the
benchmark, the prepared cell added, with every cell cut to a size the CPU
runs in a second."""
import json
import pathlib
import shutil
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

#: Ring length of the tiny copy of a configuration whose ring one B1 block
#: holds (``L`` up to ``MAX_RING_L``, 57,344 PEs), and of one whose ring
#: spans blocks (a cluster or a cooperative grid).
TINY_L_ONE_BLOCK, TINY_L_SPLIT = 64, 96
#: A cell whose files are under ``bench/`` but that ``BENCHMARK.json``
#: leaves out until its runs spread less (PERF.md, Open questions): the
#: tests run it with the entries that would add it.
PREPARED = {"name": "stale_mix.ring10k", "config": "ring10k",
            "traffic": "stale_mix", "chips": 1,
            "why": "six stale sweeps a round: B2, the words hashed outside"}
PREPARED_PER_LAYER = {"name": "b2_roofline", "unit": "%", "better": "higher",
                      "source": "device_trace", "layer": "kernels",
                      "moves": "served_pe_steps_per_s",
                      "workloads": [PREPARED["name"]]}


def full_spec() -> dict:
    """``BENCHMARK.json`` with the prepared cell added to it."""
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"].append(PREPARED)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(PREPARED["name"])
    spec["per_layer"].append(PREPARED_PER_LAYER)
    return spec


def make_full(dst: pathlib.Path) -> pathlib.Path:
    """Copy ``bench/`` to ``dst`` with ``full_spec()`` as its
    ``BENCHMARK.json``; returns ``dst``."""
    shutil.copytree(ROOT / "bench", dst / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "out"))
    (dst / "BENCHMARK.json").write_text(json.dumps(full_spec()))
    return dst


def shrink(root: pathlib.Path) -> pathlib.Path:
    """Cut, in place, every configuration and cell that
    ``root/BENCHMARK.json`` names to a size the CPU runs in a second:
    rings of ``TINY_L_ONE_BLOCK`` or ``TINY_L_SPLIT`` PEs by the
    configuration's own ``L`` (a grid's ``Ls``: the distinct tiny lengths
    of its own, in order), 2 replicas and 32 steps; returns ``root``."""
    from repro_torch.kernels.tiling import MAX_RING_L

    def tiny(L):
        return TINY_L_ONE_BLOCK if L <= MAX_RING_L else TINY_L_SPLIT

    spec = json.loads((root / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = root / c["file"]
        conf = json.loads(path.read_text())
        if "Ls" in conf:
            conf["Ls"] = list(dict.fromkeys(tiny(L) for L in conf["Ls"]))
        else:
            conf["L"] = tiny(conf["L"])
        conf["state_cache_rows"] = 256
        path.write_text(json.dumps(conf))
    for w in spec["workloads"]:
        path = root / "bench" / "cells" / f"{w['name']}.json"
        cell = json.loads(path.read_text())
        cell.update(replicas=2, burn_in=32 if cell["burn_in"] else 0,
                    n_steps=32)
        path.write_text(json.dumps(cell))
    return root


@pytest.fixture(scope="session")
def full_root(tmp_path_factory):
    return make_full(tmp_path_factory.mktemp("full"))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return shrink(make_full(tmp_path_factory.mktemp("bench")))


@pytest.fixture(scope="session")
def spec():
    return full_spec()
