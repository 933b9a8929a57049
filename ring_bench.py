#!/usr/bin/env python3
"""Measurements of the multistep ring kernels (B1, B3) beside chip_smoke.py.

Run on a machine with one NVIDIA GPU and ``nvcc``, from the root of a
checkout::

    python3 ring_bench.py ablate CSRC_DIR
    python3 ring_bench.py drain SRC_DIR [SRC_DIR ...]

``ablate`` splits a ring loop's time.  It copies ``CSRC_DIR`` (the
``src/repro_torch/kernels/csrc`` of some checkout, for example one unpacked
with ``git archive 90ddaa1 src/repro_torch/kernels/csrc``) into
``build/ring_bench/``, makes one variant per entry of ``VARIANTS`` (each a
set of text edits; a variant whose text the sources lack is skipped),
builds B1 and B3 of each with ``nvcc``, and times one K = 16 chunk at
B = 448, N_V = 10 for L = 10,000 and 1000 with CUDA events, as
``chip_smoke.py`` times them.  The variants compute other functions: they
say what a piece of the loop costs and nothing else.

``drain`` times the service drain of ``chip_smoke.py`` phase 3 for the port
in each ``SRC_DIR`` (a checkout's ``src``), in a process of its own, three
times: the first includes the build and the first use of every operator;
the other two are warm.  Give the trees in turns (old, new, new, old).
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import contextlib
import io
import json
import math
import pathlib
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "ring_bench"
B, K, N_V = 448, 16, 10
LS = (10_000, 1000)


def _swap(old: str, new: str):
    """An edit that replaces ``old`` by ``new`` (None where it is absent)."""
    return lambda text: text.replace(old, new) if old in text else None


def _cut(start: str, stop: str):
    """An edit that drops the text from ``start`` up to ``stop``."""
    def edit(text):
        if start not in text or stop not in text:
            return None
        return text[:text.index(start)] + text[text.index(stop):]
    return edit


_LOG = _swap("return __double2float_rn(-log((double)x));",
             "return -__logf(x);")
_MOD = _swap("const uint32_t site = w0 % n_v;",
             "const uint32_t site = w0 >> 28;")
_SUMABS = _cut("    const float mean = __fdiv_rn(bcast[1], (float)L);",
               "    float* tmp = cur;")
_NO_DECODE = _swap("eta_from_w1(ev.w1(), tab)",
                   "__uint_as_float((ev.w1() >> 9) | 0x3c000000u)")
_NO_PICK = _swap("  const uint32_t site = site_of(w0, div);",
                 "  const uint32_t site = w0 & 15;")
_ONE_ENTRY = _swap("const LogEntry t = tab[(b >> 16) & 127u];",
                   "const LogEntry t = tab[0];")
#: Edits of a ring loop, by file.  Of the three-barrier loop (commit
#: 90ddaa1): the fp64 log of the decode replaced by the fp32 fast log, the
#: runtime `% n_v` by a shift, the second pass over shared memory for
#: sumabs dropped, the block's threads changed.  Of the one-barrier loop:
#: the table decode replaced by a few bits of word 1, the multiply-high
#: site pick by a mask, the table read by a read of one entry (no bank
#: conflicts).
VARIANTS = {
    "as given": {},
    "log -> __logf": {"pdes_common.cuh": [_LOG]},
    "% n_v -> shift": {"pdes_common.cuh": [_MOD]},
    "no sumabs pass": {"pdes_ring.cuh": [_SUMABS]},
    "all three": {"pdes_common.cuh": [_LOG, _MOD],
                  "pdes_ring.cuh": [_SUMABS]},
    "256 threads": {"pdes_ring.cuh": [_swap("kRingThreads = 512",
                                            "kRingThreads = 256")]},
    "1024 threads": {"pdes_ring.cuh": [_swap("kRingThreads = 512",
                                             "kRingThreads = 1024")]},
    "no decode": {"pdes_ring.cuh": [_NO_DECODE]},
    "site pick -> mask": {"pdes_common.cuh": [_NO_PICK]},
    "one table entry": {"pdes_common.cuh": [_ONE_ENTRY]},
}


def _make(csrc: pathlib.Path, name: str, edits: dict):
    d = OUT / "".join(c if c.isalnum() else "_" for c in name)
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in csrc.iterdir():
        text = f.read_text()
        for edit in edits.get(f.name, []):
            text = edit(text)
            if text is None:
                return name, None
        (d / f.name).write_text(text)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    libs = {}
    for src in ("pdes_multistep_counter", "pdes_multistep"):
        so = d / f"lib{src}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: {proc.stdout}{proc.stderr}")
        libs[src] = so
    return name, libs


def _launchers(libs, with_warps: bool):
    i32, u32, ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p
    extra = [i32] if with_warps else []
    b1 = ctypes.CDLL(str(libs["pdes_multistep_counter"])) \
        .pdes_multistep_counter_launch
    b1.argtypes = ([ptr] * 5 + [i32] * 3 + extra + [u32] * 5
                   + [ctypes.c_float, i32, i32, ptr])
    b3 = ctypes.CDLL(str(libs["pdes_multistep"])).pdes_multistep_launch
    b3.argtypes = ([ptr] * 4 + [i32] * 3 + extra + [u32, ctypes.c_float]
                   + [i32, i32, ptr])
    return b1, b3


def ablate(csrc: pathlib.Path) -> dict:
    import torch
    import chip_smoke
    from repro_torch.kernels import tiling
    with_warps = "ring_launch_check" in (csrc / "pdes_ring.cuh").read_text()
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(pool.map(lambda kv: _make(csrc, *kv), VARIANTS.items()))
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for L in LS:
        tau = torch.empty(B, L).exponential_(0.25, generator=gen).to(dev)
        dcol = torch.tensor([1.0, 4.0, 16.0, 64.0, math.inf])[
            torch.arange(B) % 5][:, None].to(dev).contiguous()
        tcol = torch.arange(B, dtype=torch.int32)[:, None].to(dev)
        words = torch.randint(-2**31, 2**31 - 1, (K, B, L, 2),
                              dtype=torch.int32, generator=gen).to(dev)
        tau_out, stats = torch.empty_like(tau), torch.empty(6, K, B,
                                                            device=dev)
        warps = (tiling.ring_warps(L),) if with_warps else ()
        for name, libs in built.items():
            if libs is None:
                print(f"[ablate] {name}: the sources lack its text; skipped")
                continue
            b1, b3 = _launchers(libs, with_warps)

            def run_b1(k=K):
                err = b1(tau.data_ptr(), tau_out.data_ptr(), stats.data_ptr(),
                         dcol.data_ptr(), tcol.data_ptr(), B, L, k, *warps,
                         0, 0, 0, 0, N_V, math.inf, 0, 0, stream)
                assert err == 0, err

            def run_b3(k=K):
                err = b3(tau.data_ptr(), words.data_ptr(), tau_out.data_ptr(),
                         stats.data_ptr(), B, L, k, *warps, N_V, 16.0, 0, 0,
                         stream)
                assert err == 0, err

            row = {}
            for kern, run in (("B1", run_b1), ("B3", run_b3)):
                row[kern] = min(chip_smoke.cuda_ms(run, 20) for _ in range(2))
                if name == "as given":
                    row[kern + " 16 x K=1"] = min(chip_smoke.cuda_ms(
                        lambda: [run(1) for _ in range(K)], 5)
                        for _ in range(2))
            out[f"L={L} {name}"] = row
            print(f"[ablate] L={L} {name:17s} " + ", ".join(
                f"{k} {v:.5f} ms" for k, v in row.items()), flush=True)
    return out


def drain_one(src: pathlib.Path) -> list:
    sys.path.insert(0, str(src))
    import torch
    import chip_smoke
    from repro_torch.experiments import sweep
    from repro_torch.kernels import pdes_multistep as pm
    from repro_torch.obs import trace
    from repro_torch.service import api
    assert pathlib.Path(pm.__file__).is_relative_to(src), pm.__file__
    walls = []
    for _ in range(3):
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            chip_smoke.phase_main_path(torch, pm, sweep, api, trace, "cuda",
                                       math.nan)
        line = next(x for x in log.getvalue().splitlines()
                    if x.startswith("[main] drain"))
        walls.append(float(line.split(": ")[1].split(" s wall")[0]))
    return walls


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ring_bench: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    if argv[:1] in (["ablate"], ["drain"]):
        print(chip_smoke.card_line())
    if argv[:1] == ["ablate"] and len(argv) == 2:
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(ablate(pathlib.Path(argv[1]).resolve())))
    elif argv[:1] == ["drain"] and len(argv) >= 2:
        for src in argv[1:]:
            proc = subprocess.run(
                [sys.executable, __file__, "_drain", src],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(proc.stdout + proc.stderr)
            walls = json.loads(proc.stdout.splitlines()[-1])
            print(f"[drain] {src}: wall {walls} s (first includes the build "
                  f"and first use)", flush=True)
    elif argv[:1] == ["_drain"] and len(argv) == 2:
        print(json.dumps(drain_one(pathlib.Path(argv[1]).resolve())))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
