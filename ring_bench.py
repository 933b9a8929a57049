#!/usr/bin/env python3
"""Measurements of the PDES kernels (B1, B2, B3) beside chip_smoke.py.

Run on a machine with one NVIDIA GPU and ``nvcc``, from the root of a
checkout::

    python3 ring_bench.py ablate CSRC_DIR
    python3 ring_bench.py drain SRC_DIR [SRC_DIR ...]
    python3 ring_bench.py step SRC_DIR [SRC_DIR ...]
    python3 ring_bench.py ablate-step CSRC_DIR
    python3 ring_bench.py sass OLD_CSRC_DIR NEW_CSRC_DIR
    python3 ring_bench.py fill

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

``step`` times the one-step kernel (B2) of the port in each ``SRC_DIR``,
in a process of its own, through that tree's ``pdes_step.launch`` at the
shapes of ``STEP_SHAPES`` with CUDA events (the best of two runs of 200
launches, warm), on ``chip_smoke.py`` phase 4's operands.

``ablate-step`` does for B2 what ``ablate`` does for the ring loops: one
variant of ``CSRC_DIR``'s ``pdes_step.cu`` per entry of ``STEP_VARIANTS``
(text edits, or another launch plan than ``tiling.step_plan``'s), each
launched through its library's C symbol and timed at the main path's and
a --pdes-core shard's shapes.

``sass`` compiles B1's and B3's sources of two ``csrc`` trees to cubins
(``nvcc -cubin``, the build's target and optimisation) and compares the
machine code of their one-block, grid and stream ring kernels
(``cuobjdump -sass``, each instantiation's instructions with addresses and
encodings dropped): what shows that a change to the shared loop left those
paths as they were.  An old instantiation is held to the new one of the
same name, or, where the kernel gained a last template flag (B1's
``kStale``), to the new one with that flag false.

``fill`` times B1's grid tier at other block counts than
``tiling.ring_plan``'s, through ``pdes_multistep.counter_launch`` with the
plan given: at 2^20 the least count (19), the plan's (22) and 26 and 33,
at B = 28 and 16; at one length of each other range of least counts that
the plan fills (``FILL_LS``) the least count and the plan's, at two full
waves.  Each plan's τ, ``ucount``, ``min`` and ``max`` are first held bit
for bit to the plain version's, and the sums to rounding, in the exact
and the stale window; then one K = 16 chunk a plan is timed with CUDA events, the
plans in turn, twice, the faster kept.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import contextlib
import functools
import io
import json
import math
import pathlib
import re
import shutil
import subprocess
import sys
from unittest import mock

ROOT = pathlib.Path(__file__).resolve().parent
OUT = ROOT / "build" / "ring_bench"
B, K, N_V = 448, 16, 10
LS = (10_000, 1000)
#: (B, Lc) of ``step``: the main path, a --pdes-core shard, one Δ's
#: replicas, the commavoid edge strip.
STEP_SHAPES = ((448, 10_000), (32, 65_536), (64, 10_000), (32, 16))


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


def _one_kernel(wide: bool):
    """One instantiation for every plan: the wide or the narrow kernel."""
    return _swap("return threads == kMaxThreads ? pdes_step_kernel<true>\n"
                 "                                : pdes_step_kernel<false>;",
                 f"return pdes_step_kernel<{str(wide).lower()}>;")


def _plan(cluster: int, threads: int | None = None):
    """A plan transform: a row in ``cluster`` segments, one block of
    ``threads`` threads each (the plan's own where None)."""
    def transform(p, tiling, lc):
        import dataclasses
        g = threads or p.threads
        seg = 2 * -(-lc // (2 * cluster))
        tile = min(seg, 2 * tiling.STEP_PAIRS * g)
        return dataclasses.replace(
            p, cluster=cluster, threads=g, rows=1, seg=seg, tile=tile,
            keep=tile == seg, smem=4 * tiling.step_group_floats(
                seg, tile == seg))
    return transform


#: Variants of B2: (edits by file, plan transform or None).  The table
#: decode against the library log and against no decode (a few bits of
#: word 1), the wide kernel (pairs of PEs, 40 registers) or the narrow one
#: (a PE a lane, 32 registers) for every plan, the cluster's launch and
#: exchange dropped (its sums are then wrong), and other plans: one block
#: a row, clusters of 4, blocks of 256 or 512 threads.
STEP_VARIANTS = {
    "as given": ({}, None),
    "library log": ({"pdes_step.cu": [_swap(
        "eta_from_w1(w.y, tab))", "eta_from_w1(w.y))")]}, None),
    "no decode": ({"pdes_step.cu": [_swap(
        "eta_from_w1(w.y, tab))",
        "__uint_as_float((w.y >> 9) | 0x3c000000u))")]}, None),
    "wide kernel": ({"pdes_step.cu": [_one_kernel(True)]}, None),
    "narrow kernel": ({"pdes_step.cu": [_one_kernel(False)]}, None),
    "no cluster": ({"pdes_step.cu": [
        _swap("attr->val.clusterDim.x = (unsigned)cluster;",
              "attr->val.clusterDim.x = 1u;"),
        _swap("if (S > 1) {", "if (false) {")]}, None),
    "one block a row": ({}, _plan(1)),
    "1 x 512 threads": ({}, _plan(1, 512)),
    "4 x 256 threads": ({}, _plan(4, 256)),
    "4 x 512 threads": ({}, _plan(4, 512)),
}


def _make(csrc: pathlib.Path, name: str, edits: dict,
          srcs=("pdes_multistep_counter", "pdes_multistep")):
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
    for src in srcs:
        so = d / f"lib{src}.so"
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(so), str(d / f"{src}.cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"{name}: {proc.stdout}{proc.stderr}")
        so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        libs[src] = so
    return name, libs


def _launchers(libs, extra_ints: int, rebase: bool = False,
               stale: bool = False):
    """B1's and B3's C launchers of ``libs``, taking ``extra_ints`` ints
    after K: none (the oldest loops), the warps, or the warps, grid,
    segment and kept PEs (one launcher a kernel, which also takes the
    workspace and its bytes before the stream); B1's with ``rebase`` an
    int more after the rule flags, and with ``stale`` one more after it."""
    i32, u32, ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p
    extra = [i32] * extra_ints
    work = [ptr, ctypes.c_longlong] if extra_ints == 4 else []
    b1 = ctypes.CDLL(str(libs["pdes_multistep_counter"])) \
        .pdes_multistep_counter_launch
    b1.argtypes = ([ptr] * 5 + [i32] * 3 + extra + [u32] * 5
                   + [ctypes.c_float, i32, i32] + [i32] * rebase
                   + [i32] * stale + work
                   + [ptr])
    b3 = ctypes.CDLL(str(libs["pdes_multistep"])).pdes_multistep_launch
    b3.argtypes = ([ptr] * 4 + [i32] * 3 + extra + [u32, ctypes.c_float]
                   + [i32, i32] + work + [ptr])
    return b1, b3


def ablate(csrc: pathlib.Path) -> dict:
    import torch
    import chip_smoke
    from repro_torch.kernels import tiling
    ring = (csrc / "pdes_ring.cuh").read_text()
    extra_ints = (4 if "ring_block_launch" in ring
                  else 1 if "ring_launch_check" in ring else 0)
    work = (None, 0) if extra_ints == 4 else ()  # one block reads none
    rebase = "bool rebase" in ring      # B1 takes the flag, here off
    stale = "kStale" in ring            # B1 takes the window, here exact
    with concurrent.futures.ThreadPoolExecutor(len(VARIANTS)) as pool:
        built = dict(pool.map(lambda kv: _make(csrc, *kv), VARIANTS.items()))
    dev = torch.device("cuda")
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    gen = torch.Generator().manual_seed(0)
    out = {}
    for L in LS:
        plan = tiling.ring_plan(L)
        tau = torch.empty(B, L).exponential_(0.25, generator=gen).to(dev)
        dcol = torch.tensor([1.0, 4.0, 16.0, 64.0, math.inf])[
            torch.arange(B) % 5][:, None].to(dev).contiguous()
        tcol = torch.arange(B, dtype=torch.int32)[:, None].to(dev)
        words = torch.randint(-2**31, 2**31 - 1, (K, B, L, 2),
                              dtype=torch.int32, device=dev,
                              generator=torch.Generator(dev).manual_seed(L))
        tau_out, stats = torch.empty_like(tau), torch.empty(6, K, B,
                                                            device=dev)
        for name, libs in built.items():
            if libs is None:
                print(f"[ablate] {name}: the sources lack its text; skipped")
                continue
            b1, b3 = _launchers(libs, extra_ints, rebase, stale)
            shape = (plan.warps, plan.grid, plan.seg, plan.keep)[:extra_ints]

            def run_b1(k=K):
                err = b1(tau.data_ptr(), tau_out.data_ptr(), stats.data_ptr(),
                         dcol.data_ptr(), tcol.data_ptr(), B, L, k, *shape,
                         0, 0, 0, 0, N_V, math.inf, 0, 0,
                         *(0,) * (rebase + stale), *work, stream)
                assert err == 0, err

            def run_b3(k=K):
                err = b3(tau.data_ptr(), words.data_ptr(), tau_out.data_ptr(),
                         stats.data_ptr(), B, L, k, *shape, N_V, 16.0, 0, 0,
                         *work, stream)
                assert err == 0, err

            row = {}
            for kern, run in (("B1", run_b1), ("B3", run_b3)):
                row[kern] = min(chip_smoke.cuda_ms(run, 20) for _ in range(2))
                if name == "as given":
                    row[kern + " 16 x K=1"] = min(chip_smoke.cuda_ms(
                        lambda: [run(1) for _ in range(K)], 5)
                        for _ in range(2))
            out[f"L={L} {name}"] = row
            print(f"[ablate] L={L} {name:18s} " + ", ".join(
                f"{k} {v:.5f} ms" for k, v in row.items()), flush=True)
    return out


def ablate_step(csrc: pathlib.Path) -> dict:
    import torch
    import chip_smoke
    from repro_torch.core import events
    from repro_torch.kernels import _build, ops, tiling
    with concurrent.futures.ThreadPoolExecutor(len(STEP_VARIANTS)) as pool:
        built = dict(pool.map(
            lambda kv: _make(csrc, "step " + kv[0], kv[1][0], ("pdes_step",)),
            STEP_VARIANTS.items()))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    out = {}
    for b, lc in STEP_SHAPES[:2]:
        _, tau_h, bits, gvt, dcol = chip_smoke._step_inputs(
            torch, ops, events, b, lc, 1, "cuda")
        words = _build.u32_bits(bits).reshape(bits.shape).contiguous()
        base = (gvt + dcol).contiguous()
        o = torch.empty((b, lc), device="cuda")
        st = torch.empty((6, b), device="cuda")
        for name, (_, transform) in STEP_VARIANTS.items():
            libs = built["step " + name]
            if libs is None:
                print(f"[ablate-step] {name}: the sources lack its text; "
                      f"skipped")
                continue
            f = ctypes.CDLL(str(libs["pdes_step"])).pdes_step_launch
            f.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
                          + [ctypes.c_uint32, ctypes.c_float]
                          + [ctypes.c_int] * 9 + [ctypes.c_void_p])
            p = tiling.step_plan(lc)
            if transform is not None:
                p = transform(p, tiling, lc)

            def run():
                return f(tau_h.data_ptr(), words.data_ptr(), base.data_ptr(),
                         o.data_ptr(), st.data_ptr(), b, lc, N_V, 0.0, 0, 0,
                         p.cluster, p.threads, p.rows, p.seg, p.tile,
                         int(p.keep), p.smem, stream)

            err = run()
            if err:
                print(f"[ablate-step] {b}x{lc} {name}: launch refused, CUDA "
                      f"error {err}", flush=True)
                continue
            ms = min(chip_smoke.cuda_ms(run, 200) for _ in range(2))
            dev_ms = min(chip_smoke.device_ms(run, 200) for _ in range(2))
            occ = ctypes.CDLL(str(libs["pdes_step"])).pdes_step_max_clusters(
                p.cluster, p.threads, p.smem)     # the variant's own kernel
            info = _build.parse_ptxas(
                libs["pdes_step"].with_suffix(".log").read_text())
            regs = max(v["registers"] for v in info.values())
            spill = max(v["spill_stores"] for v in info.values())
            out[f"{b}x{lc} {name}"] = dev_ms
            print(f"[ablate-step] {b}x{lc} {name:18s} {dev_ms:.5f} ms "
                  f"(back to back {ms:.5f}; {regs} registers, {spill} B "
                  f"spilled; cluster {p.cluster} tile {p.tile} smem {p.smem}"
                  f", {occ} clusters at once)", flush=True)
    return out


#: (source, __global__ function) of the one-block, grid and stream ring
#: kernels: 15 instantiations, each for three rule flags
RING_KERNELS = (("pdes_multistep_counter", "multistep_counter_kernel"),
                ("pdes_multistep_counter", "multistep_counter_grid_kernel"),
                ("pdes_multistep_counter", "multistep_counter_stream_kernel"),
                ("pdes_multistep", "multistep_kernel"),
                ("pdes_multistep", "multistep_grid_kernel"))


def _sass(csrc: pathlib.Path, name: str, tag: str) -> dict:
    """``{function: [instruction, ...]}`` of ``csrc/<name>.cu``'s cubin, the
    anonymous namespace's hash taken out of the names."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    nvcc = _build._nvcc()
    cubin = OUT / f"sass_{tag}_{name}.cubin"
    OUT.mkdir(parents=True, exist_ok=True)
    subprocess.run([nvcc, *_build.NVCC_FLAGS[:4], "-cubin", "-o", str(cubin),
                    str(csrc / f"{name}.cu")], check=True)
    text = subprocess.run(
        [str(pathlib.Path(nvcc).with_name("cuobjdump")), "-sass", str(cubin)],
        capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "", m.group(1))
            funcs[cur] = []
        elif cur and "/*" in line:
            ins = re.sub(r"/\*[0-9a-f]{4}\*/|/\* 0x[0-9a-f]+ \*/", "",
                         line).strip()
            if ins:
                funcs[cur].append(ins)
    return funcs


def _new_name(f: str, new: dict) -> str:
    """The new tree's name of the old tree's function ``f``: the same, or,
    where a kernel gained a last template flag whose default is false, the
    name with that flag."""
    if f in new:
        return f
    return re.sub(r"I((?:Lb[01]E)+)E", r"I\1Lb0EE", f, count=1)


def sass(old: pathlib.Path, new: pathlib.Path) -> dict:
    out, cubins = {}, {}
    for name, fn in RING_KERNELS:
        if name not in cubins:
            cubins[name] = _sass(old, name, "old"), _sass(new, name, "new")
        a, b = cubins[name]
        seen = set()
        for f in sorted(k for k in a if fn in k):
            g = _new_name(f, b)
            seen.add(g)
            same = a[f] == b.get(g)
            out[f] = same
            print(f"[sass] {f}: {len(a[f])} instructions in the old tree, "
                  f"{len(b.get(g, []))} in the new ({g}), identical: {same}",
                  flush=True)
        for f in sorted(k for k in b if fn in k and k not in seen):
            print(f"[sass] {f}: only in the new tree, {len(b[f])} "
                  f"instructions", flush=True)
    return out


#: ``fill``'s rings: the production ring at its block counts and batches,
#: then (L, least count) of one length of each other range of least
#: counts that ``tiling.ring_plan`` fills: 15 x ``MAX_RING_SEG``, the
#: shortest ring of 17 blocks, 2^21, 2^22, 100 x ``MAX_RING_SEG``.
FILL_PROD = (1 << 20, (19, 22, 26, 33), (28, 16))
FILL_LS = ((854_400, 15), (911_361, 17), (1 << 21, 37), (1 << 22, 74),
           (5_696_000, 100))
FILL_N_V = 100
FILL_DELTAS = (10.0, 30.0, 100.0, 300.0, math.inf)


def _plan_of(pm, plan):
    """``pm``'s launches and occupancy queries take ``plan`` for every L."""
    return mock.patch.object(pm, "ring_plan", lambda L, stream=True: plan)


def fill(dev="cuda") -> list:
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core.horizon import MOMENT_KEYS
    from repro_torch.kernels import _build, ref, tiling
    from repro_torch.kernels import pdes_multistep as pm
    cases = [(FILL_PROD[0], g, b) for b in FILL_PROD[2] for g in FILL_PROD[1]]
    for L, n in FILL_LS:
        assert tiling.ring_blocks(L) == n, (L, tiling.ring_blocks(L))
        g = tiling.ring_plan(L).grid
        cases += [(L, n, 2 * (132 // n)), (L, g, 2 * (132 // n))]
    rows = []
    for L, B in dict.fromkeys((L, B) for L, _, B in cases):
        grids = list(dict.fromkeys(g for l, g, b in cases
                                   if (l, b) == (L, B)))
        plans = {g: tiling.RingPlan(g, tiling._ring_seg(L, g),
                                    tiling.RING_SPLIT_WARPS,
                                    4 * tiling._ring_seg(L, g),
                                    tiling.SMEM_STATIC_SPLIT) for g in grids}
        rng = np.random.default_rng(L + B)
        tau = torch.as_tensor(rng.exponential(4.0, (B, L)).astype(np.float32),
                              device=dev)
        dcol = torch.tensor(FILL_DELTAS, device=dev)[
            torch.arange(B, device=dev) % len(FILL_DELTAS)][:, None]
        tcol = torch.arange(B, device=dev)[:, None]
        tbits = _build.u32_bits(tcol).reshape(B, 1).contiguous()
        out = torch.empty_like(tau)
        stats = torch.empty((6, K, B), device=dev)
        for stale in (False, True):
            kw = dict(k_steps=K, n_v=FILL_N_V, delta=math.inf, stale=stale)
            want = ref.pdes_multistep_counter_ref(
                tau, torch.tensor([[0, 0, 0, 0]]), dcol, tcol, **kw)
            launch = functools.partial(
                pm.counter_launch, tau, out, stats, dcol, tbits, (0, 0, 0, 0),
                n_v=FILL_N_V, delta=math.inf, rd_mode=False,
                border_both=False, stale=stale)
            ms, at_once = {}, {}
            for g, plan in plans.items():
                with _plan_of(pm, plan):
                    at_once[g] = pm.resident_rings(L)
                    launch()
                got = (out, dict(zip(MOMENT_KEYS, stats.unbind(0))))
                chip_smoke._hold_kernel(torch, got, want,
                                        f"B1 {B} x {L} at {g} blocks")
            for _ in range(2):
                for g, plan in plans.items():
                    with _plan_of(pm, plan):
                        t = chip_smoke.cuda_ms(launch, 5)
                    ms[g] = min(ms.get(g, t), t)
            base = ms[grids[0]]
            for g in grids:
                waves = -(-B // at_once[g])
                rate = B * L * K / (ms[g] * 1e-3)
                row = dict(L=L, B=B, window="stale" if stale else "exact",
                           blocks=g, seg=plans[g].seg,
                           rings_at_once=at_once[g], waves=waves, ms=ms[g],
                           vs_least=ms[g] / base, pe_steps_per_s=rate,
                           per_block=rate / (min(B, at_once[g]) * g))
                rows.append(row)
                print(f"[fill] L={L} B={B} {row['window']:5s} {g:3d} blocks "
                      f"of {row['seg']} PEs, {at_once[g]} rings at once, "
                      f"{waves} waves: {ms[g]:.5f} ms, x{row['vs_least']:.4f}"
                      f" of {grids[0]} blocks; {rate:.4g} PE-steps/s, "
                      f"{row['per_block']:.4g} a block at once", flush=True)
    return rows


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


def step_one(src: pathlib.Path) -> dict:
    sys.path.insert(0, str(src))
    import torch
    import chip_smoke
    from repro_torch.core import events
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import pdes_step as ps
    assert pathlib.Path(ps.__file__).is_relative_to(src), ps.__file__
    kw = dict(n_v=N_V, delta=0.0, rd_mode=False, border_both=False)
    out = {}
    for b, lc in STEP_SHAPES:
        _, tau_h, bits, gvt, dcol = chip_smoke._step_inputs(
            torch, ops, events, b, lc, 1, "cuda")
        words = _build.u32_bits(bits).reshape(bits.shape).contiguous()
        base = gvt + dcol
        o = torch.empty((b, lc), device="cuda")
        st = torch.empty((6, b), device="cuda")
        out[f"{b}x{lc}"] = min(chip_smoke.cuda_ms(
            lambda: ps.launch(tau_h, words, base, o, st, **kw), 200)
            for _ in range(2))
    return out


def main(argv) -> int:
    import torch
    if not torch.cuda.is_available():
        print("ring_bench: needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    if argv[:1] in (["ablate"], ["drain"], ["step"], ["ablate-step"],
                    ["sass"], ["fill"]):
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
    elif argv[:1] == ["step"] and len(argv) >= 2:
        for src in argv[1:]:
            proc = subprocess.run(
                [sys.executable, __file__, "_step", src],
                capture_output=True, text=True)
            if proc.returncode:
                raise RuntimeError(proc.stdout + proc.stderr)
            ms = json.loads(proc.stdout.splitlines()[-1])
            print(f"[step] {src}: B2 ms per launch " + ", ".join(
                f"{k} {v:.5f}" for k, v in ms.items()), flush=True)
    elif argv[:1] == ["ablate-step"] and len(argv) == 2:
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(ablate_step(pathlib.Path(argv[1]).resolve())))
    elif argv[:1] == ["sass"] and len(argv) == 3:
        print(json.dumps(sass(*(pathlib.Path(a).resolve() for a in argv[1:]))))
    elif argv == ["fill"]:
        sys.path.insert(0, str(ROOT / "src"))
        print(json.dumps(fill()))
    elif argv[:1] == ["_step"] and len(argv) == 2:
        print(json.dumps(step_one(pathlib.Path(argv[1]).resolve())))
    else:
        print(__doc__, file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
