#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` and drives the port's paths on the card:

0. setup: the card's name and power limit, versions, both kernels' builds
   (one ``nvcc`` per source, started together);
1. decode: the kernels' table-driven η decode against the plain rule on
   the card over all ``2**24`` inputs (bitwise), and the count that differ
   from numpy's fp64 ``log`` on the host; the kernels' division-free site
   pick against ``w0 % n_v`` on the card over ``2**24`` words for each
   n_v of ``SITE_N_VS``;
2. B1 against its plain version: ``pdes_multistep_counter`` at the main
   path's shape (L = 10,000 PEs, B = 448 rings, K = 16 and a K = 5
   remainder chunk), τ/ucount/min/max bitwise, the sums to a stated
   tolerance; then both timed with CUDA events, and the kernel also at
   the paper-figure L = 1000 (``L_PAPER``);
3. B1's path: an in-process ``SweepService`` drain of three requests at
   L = 10,000, N_V = 10 on the ``pallas_multistep`` backend, every
   response bit-identical to a direct ``run_window_sweep``, physics bounds
   asserted, B1's launch count read;
4. B2 against its plain version: ``pdes_step`` at B = 448, Lc = 10,000
   over N_V, ``rd_mode``, ``border_both``, static Δ, a folded Δ column and
   a stale base; τ′/ucount/min/max bitwise, the sums to tolerance; timed
   with CUDA events, with the host-side pieces of one engine step;
5. B2's path, the ``pallas`` backend: (a) 256 exact-window steps bitwise
   equal to ``pallas_multistep``; (b) a stale-window ``SweepService``
   drain, every response equal to a direct run, stale ``u`` at most exact
   ``u`` + 0.01; (c) ``refine_optimal_window`` through one service; B2's
   launch count read over the phase;
6. the threefry generator (``kernels/threefry.py``, no TPU counterpart)
   against its plain version over one K = 16 chunk at B = 448,
   L = 10,000, bitwise; the plain cipher on the card on the Random123
   known-answer vectors; the words against JAX's own, committed below;
   timed;
7. B3 against its plain version: ``pdes_multistep`` on generator words at
   B = 448, L = 10,000, K = 16 and a K = 5 remainder chunk over N_V, Δ,
   ``rd_mode`` and ``border_both``; τ/ucount/min/max bitwise, the sums to
   tolerance; timed, and the kernel also at L = 1000;
8. B3's path: (a) ``ops.simulate`` for 1024 steps with the kernels against
   the same call with the plain versions on the card, bitwise; (b)
   ``simulate`` against ``horizon.run`` at the JAX test's shape and
   tolerances, and at full width over 64 steps (reported, not bitwise);
   (c) ``ensemble.steady_state(backend=None)`` against the
   ``pallas_multistep`` engine at the same depth; B3's and the
   generator's launch counts on (a), the generator's on (c); a profiler
   split of three chunks;
9. the sharded backend (``core/distributed.py``) in this process as the
   one rank of an NCCL process group: (a) the exact mode over 256 steps
   at Δ = 16 and (b) the commavoid mode (K = 16), each bitwise in τ, the
   offsets, ``u`` and ``gvt`` against the ``pallas_multistep`` (exact)
   or stale ``pallas`` engine and held to ``run_reference``, also at the
   JAX test's shape; (c) a ``SweepService(mesh=)`` drain of phase 3's
   requests at phase 5's cut depth, each response bitwise a direct
   ``run_window_sweep(mesh=)`` and equal in ``u`` and GVT rate to
   ``pallas_multistep``; (d) wall per chunk beside the ``pallas``
   backend's, B2's launches, a profile with the NCCL calls' share;
10. the serve daemon, telemetry and ``--mesh``: (a) an in-process
   ``serve_daemon`` (telemetry off) on two intake files, one a round:
   phase 3's three requests, then dave (alice's spec at 2048 steps, her
   burn-in from the state cache), every response equal to a direct run,
   B1's launches read; (b) ``python -m repro_torch.service serve`` with
   the state cache, metrics and trace, crashed by fault injection after
   its first pass and restarted: every response equal to (a)'s bit for
   bit, dave's 256 rows all from the cache, the time to recover split;
   (c) ``python -m repro_torch.obs summarize --check`` on (b)'s files;
   (d) phase 9(c)'s requests through ``python -m repro_torch.service
   --mesh data=1,model=1`` (one NCCL rank), equal to phase 9(c)'s
   responses bit for bit, B2's launches read in the rank, and a mesh
   larger than the GPUs refused with exit 2; (e) (a)'s wall with
   telemetry on against off, five drains each in turns;
11. the language-model serve path (``repro_torch.models``,
   ``repro_torch.serve``; no TPU kernel lies on it, so it adds none): (a)
   llama3.2-1b at full width (16 layers, d 2048, vocab 128,256; fp32
   parameters, bf16 compute), drawn on the card from generator seed 0,
   serving 16 requests through ``ServeEngine`` (8 lanes, Δ = 16): every
   result present and in range; each batch's prefill and every decode
   step timed with CUDA events, tokens/s, peak memory, the idle share of 8
   profiled decode steps, lane utilization beside ``u_RD(Δ)``, and the
   bounds; (b) the same widths cut to 2 layers in fp32 (TF32 off): 64
   tokens fed one by one through ``decode_step`` give ``prefill``'s
   logits to 2e-3; (c) reduced llama3.2-1b, gemma2-2b and mixtral-8x7b in
   fp32 on the card against the same parameters on the CPU: prefill
   logits, the cache and 8 decode steps to rtol 1e-4, and a 4-request
   ``ServeEngine`` drain token for token;
12. the last lines: one JSON object per kernel (times, bound, launches),
   then ``{"ok": true, "device": {...}}``.

Every phase asserts; any failure exits non-zero with no result line.
Without CUDA, or outside a checkout of the repository, it exits 1.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import math
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import textwrap
import time

#: Ring length and volume load of the main path (10x the L = 1000 of the
#: paper-figure benchmarks).
L_MAIN = 10_000
N_V_MAIN = 10
#: The ring length of the paper-figure benchmarks (benchmarks/run.py), at
#: which phases 2 and 7 also time B1 and B3.
L_PAPER = 1000
#: The n_v values at which phase 1 checks the site pick: every shape of its
#: multiply-high constants, up to the largest uint32.
SITE_N_VS = (1, 2, 3, 10, 1000, 2**31 + 1, 2**32 - 1)
#: Rings in the main path's coalesced pass: alice's 4 x 64 + bob's 3 x 64.
REPLICAS = 64
B_MAIN = 7 * REPLICAS
K_MAIN = 16
BURN_MAIN = 4096
STEPS_MAIN = 1024
#: Largest η the decode gives: -ln(2**-25).
ETA_MAX = 17.4
#: The sums (sum, sumsq, sumabs) are reduced in another order by the
#: kernel than by the plain version: relative tolerance, and an absolute
#: one for sumabs of a nearly synchronized ring (near zero), where one ulp
#: of the ring mean moves sumabs by up to (PEs below - PEs above) ulps.
SUM_RTOL = 1e-5
SUM_ATOL = 1e-2
EXACT_KEYS = ("ucount", "min", "max")

#: H100 SXM published peaks: HBM rate, and the fp32 rate outside the
#: tensor cores, the only non-tensor 32-bit rate the datasheet gives; the
#: kernel's integer hash and fp32 work are counted at it.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
#: Operations of the kernel (see the note in its source): per PE-step
#: 23 integer (PE hash, word 0, site pick) and 11 fp32 (rules, moments,
#: sumabs); per PE that updates, 15 more (word 1, decode, log, add).
OPS_PER_PE_STEP = 34
OPS_PER_UPDATE = 15
#: Operations of B2 (see the note in its source): per PE 14 (site pick,
#: border compares, rules, moments, sumabs); per PE that updates, 6 more
#: (decode, log, add).  No hash: the bits come from memory.
STEP_OPS_PER_PE = 14
STEP_OPS_PER_UPDATE = 6
#: The cut depth of phase 5: burn-in and measured steps of the stale drain
#: and of the refinement (default_burn_in asks for 32,143 at Δ = 64), and
#: the steps of the exact-window comparison.
BURN_SLICE = 1024
STEPS_SLICE = 1024
STEPS_EXACT = 256
#: Operations of the generator (see the note in its source): 73 integer
#: operations a word (threefry2x32 and the final xor).
GEN_OPS_PER_WORD = 73
#: Operations of B3 (see the note in its source): as B2's, per PE-step and
#: per PE that updates.
B3_OPS_PER_PE_STEP = 14
B3_OPS_PER_UPDATE = 6
#: Phase 8: the window of B3's path, its simulated steps, the steps of the
#: full-width simulate/horizon.run comparison, and the cut depth of the
#: threefry steady state (default_burn_in asks for 23,036 at Δ = 16).
DELTA_SIM = 16.0
STEPS_SIM = 1024
STEPS_CMP = 64
BURN_THREEFRY = 1024
STEPS_THREEFRY = 1024
#: Chunks in the profiled ``simulate`` call of phase 8: the kernel counts
#: show whether the profiler dropped a launch.
PROFILE_CHUNKS = 3
#: Phase 9: the window and steps of the sharded runs held against the
#: engines, the chunks of each timed call and the rounds of timed calls
#: (host-bound walls: each round runs every path, in turns).  The service
#: drain runs at phase 5's cut depth (``BURN_SLICE``, ``STEPS_SLICE``).
DELTA_SHARDED = 16.0
STEPS_SHARDED = 256
TIMED_CHUNKS = 8
TIMED_ROUNDS = 5
#: Phase 10: dave's measured steps (alice's spec, longer: her stream prefix
#: and burn-in), the rounds of timed drains of (e), each run in turns with
#: telemetry off and on, and the seconds each subprocess is allowed.
STEPS_DAVE = 2048
SERVE_ROUNDS = 5
SUBPROCESS_S = 300
#: Phase 11(a): the model served at full width, the engine's lanes, cache
#: length and window, the requests (prompt lengths and new tokens drawn
#: uniformly from these ranges; every batch's padded length stays within
#: the config's q_block of 512) and the decode steps profiled.
LM_ARCH = "llama3.2-1b"
LM_LANES = 8
LM_MAX_LEN = 1024
LM_DELTA = 16.0
LM_REQUESTS = 16
LM_PROMPT = (64, 512)
LM_NEW = (16, 64)
LM_PROFILE_STEPS = 8
#: The H100 SXM's dense bf16 tensor-core peak (data sheet), for the
#: prefill bound.
BF16_FLOPS_PER_S = 989e12
#: Phase 11(b): layers kept of the full widths, and tokens fed one by one;
#: phase 11(c): the reduced archs held card against CPU, the decode steps
#: compared and the requests drained on both.
LM_CHECK_LAYERS = 2
LM_CHECK_TOKENS = 64
LM_CPU_ARCHS = ("llama3.2-1b", "gemma2-2b", "mixtral-8x7b")
LM_CPU_STEPS = 8
LM_CPU_REQUESTS = 4
#: Tolerances: (b) ``tests/test_models.py``'s decode-against-prefill one;
#: (c) the CPU parity tests' (fp32 sums in another order).
LM_DECODE_TOL = 2e-3
LM_RTOL, LM_ATOL = 1e-4, 1e-5
#: Phase 10(b)'s restart: the CLI's own ``main`` with the clock read
#: (CLOCK_MONOTONIC, shared with the parent) after the torch import and
#: CUDA init, after loading B1's library and around the state cache's
#: load, written to ``STAMPS`` at exit.
RESTART = textwrap.dedent("""
    import json, os, sys, time
    stamps = {}
    import torch
    if os.environ["DEVICE"] == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
    stamps["cuda"] = time.perf_counter()
    from repro_torch.kernels import _build
    if os.environ["DEVICE"] == "cuda":
        _build.load("pdes_multistep_counter")
    stamps["library"] = time.perf_counter()
    from repro_torch.service import state_cache
    from repro_torch.service.__main__ import main
    load = state_cache.StateCache.load

    def timed_load(self, path):
        t0 = time.perf_counter()
        n = load(self, path)
        stamps["cache"] = [t0, time.perf_counter()]
        return n

    state_cache.StateCache.load = timed_load
    try:
        rc = main()
    finally:
        with open(os.environ["STAMPS"], "w") as fh:
            json.dump(stamps, fh)
    sys.exit(rc)
""")
#: Phase 10(d)'s ``--mesh`` drain: the CLI's own ``main``; every rank (the
#: launcher starts copies of this command line) writes B2's launch count
#: to ``COUNTS/rank<r>`` at exit.
COUNTED = textwrap.dedent("""
    import atexit, os, sys
    from repro_torch.kernels import pdes_step
    from repro_torch.service.__main__ import main

    def count():
        path = os.path.join(os.environ["COUNTS"], "rank" + os.environ["RANK"])
        with open(path, "w") as fh:
            fh.write(str(pdes_step.launches))

    if "RANK" in os.environ:
        atexit.register(count)
    sys.exit(main())
""")
#: JAX's own words: (step, b, l, word 0, word 1) of
#: repro.core.horizon.event_bits(jax.random.key(7), step, (448, 10000)),
#: made on the CPU with jax 0.9.0 by
#:   w = np.asarray(horizon.event_bits(jax.random.key(7), jnp.uint32(step),
#:                                     (448, 10000)))
#: and read at w[b, l, 0] and w[b, l, 1].
JAX_WORDS = [
    (3, 0, 0, 0x3B38B794, 0x5108BA83),
    (3, 0, 1, 0xCAA8A765, 0x88E2AE98),
    (3, 223, 5000, 0x96A28762, 0xB9F3F838),
    (3, 447, 9998, 0x8DC79F7C, 0x166EC9EF),
    (3, 447, 9999, 0x60421E03, 0xCA883E06),
    (2147483647, 0, 0, 0x7BF73FCE, 0x9784C588),
    (2147483647, 0, 1, 0xC09C994F, 0x25AD6E62),
    (2147483647, 223, 5000, 0x702F800B, 0xABF74FAC),
    (2147483647, 447, 9998, 0x014826ED, 0x1D12F2E9),
    (2147483647, 447, 9999, 0x82F29DDC, 0xB97A3D6B),
]
#: Random123's known-answer vectors of threefry2x32: (k0, k1, x0, x1) ->
#: (y0, y1).
THREEFRY_KAT = [
    ((0, 0, 0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF,) * 4, (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344, 0x243F6A88, 0x85A308D3),
     (0xC4923A9C, 0x483DF7A0)),
]


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    return 1


def check(ok: bool, msg) -> None:
    """Raise unless ``ok`` (an ``assert`` that ``python -O`` keeps)."""
    if not ok:
        raise AssertionError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sync(torch, dev) -> None:
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` back-to-back calls (CUDA events)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_decode(torch, horizon, pm, dev):
    """Kernel decode == plain rule on the card; count against the host.
    Kernel site pick == ``%`` on the card."""
    import numpy as np
    w1 = torch.arange(1 << 24, device=dev, dtype=torch.int64) << 8
    plain = horizon.decode_eta(w1)
    for table in (False, True):     # B2's library log, B1's and B3's table
        kern = pm.decode_eta_cuda(w1, table=table)
        n_bad = int((kern.view(torch.int32) != plain.view(torch.int32)).sum())
        check(n_bad == 0, f"kernel decode (table={table}) differs from the "
                          f"plain rule on {n_bad} of 2**24 inputs")
    kh = np.arange(1 << 24, dtype=np.uint32)
    x = kh.astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)
    host = (-np.log(x.astype(np.float64))).astype(np.float32)
    got = kern.cpu().numpy()
    diff = np.flatnonzero(got.view(np.int32) != host.view(np.int32))
    print(f"[decode] kernel decodes (library log, table) == plain rule on the "
          f"card on all 2**24 inputs; table decode "
          f"differs from numpy fp64 log on the host on {diff.size} inputs"
          + (f" (first k: {diff[:8].tolist()})" if diff.size else ""))
    gen = torch.Generator(device=dev).manual_seed(1)
    for n_v in SITE_N_VS:
        edges = [0, 1, n_v - 1, n_v, n_v + 1, 2**32 - 2, 2**32 - 1]
        for m in (2, 3, (2**32 - 1) // n_v):
            edges += [m * n_v - 1, m * n_v, m * n_v + 1]
        edges = torch.tensor([e for e in edges if 0 <= e < 2**32],
                             dtype=torch.int64, device=dev)
        words = torch.randint(0, 2**32, ((1 << 24) - edges.numel(),),
                              generator=gen, device=dev, dtype=torch.int64)
        words = torch.cat([edges, words])
        sites = pm.site_pick_cuda(words, n_v)
        n_bad = int((sites != words % n_v).sum())
        check(n_bad == 0, f"kernel site pick differs from % {n_v} on "
                          f"{n_bad} of {words.numel()} words")
    print(f"[decode] kernel site pick == w0 % n_v on the card over 2**24 "
          f"words (edges and random) for n_v in {SITE_N_VS}")
    return int(diff.size)


def _kernel_inputs(torch, rng, B: int, L: int, dev):
    import numpy as np
    tau = rng.exponential(4.0, size=(B, L)).astype(np.float32)
    deltas = np.array([1.0, 4.0, 16.0, 64.0, np.inf], np.float32)
    dcol = deltas[np.arange(B) % deltas.size][:, None]
    trials = np.arange(B, dtype=np.int64)
    trials[-REPLICAS:] = -1 - np.arange(REPLICAS)   # the service's pad indices
    return (torch.as_tensor(tau, device=dev),
            torch.as_tensor(dcol, device=dev),
            torch.as_tensor(trials[:, None], device=dev))


def phase_kernel(torch, pm, ref, build, dev, timer=cuda_ms):
    """Kernel against its plain version at the main path's shape."""
    import numpy as np
    rng = np.random.default_rng(0)
    tau0, dcol, tcol = _kernel_inputs(torch, rng, B_MAIN, L_MAIN, dev)
    # (n_v, rd_mode, border_both, per-row columns or scalar b0 + static Δ)
    cases = [(1, False, False, True), (10, False, False, True),
             (10, True, False, True), (10, False, True, True),
             (10, False, False, False)]
    max_err = 0.0
    for n_v, rd_mode, border_both, cols in cases:
        case = dict(n_v=n_v, rd_mode=rd_mode, border_both=border_both)
        tau = tau0
        step0 = 0xFFFFFFF0            # the step counter wraps mid-run
        for k in (K_MAIN, K_MAIN, K_MAIN, 5):
            ctr = torch.tensor([[7, step0, 0 if cols else 3, 0]])
            args = (tau, ctr, dcol if cols else None, tcol if cols else None)
            kw = dict(k_steps=k, delta=math.inf if cols else 16.0, **case)
            t_k, m_k = pm.pdes_multistep_counter(*args, **kw)
            t_p, m_p = ref.pdes_multistep_counter_ref(*args, **kw)
            what = f"{case} cols={cols} K={k}"
            check(torch.equal(t_k, t_p), f"tau differs: {what}")
            for key in m_p:
                a, b = m_k[key], m_p[key]
                if key in EXACT_KEYS:
                    check(torch.equal(a, b), f"{key} differs: {what}")
                else:
                    check(torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL),
                          f"{key} beyond tolerance: {what}")
                max_err = max(max_err, float((a - b).abs().max()))
            tau = t_k
            step0 = (step0 + k) & 0xFFFFFFFF
    print(f"[kernel] tau/ucount/min/max bitwise equal to the plain version "
          f"over {len(cases)} cases x 4 chunks at B={B_MAIN} L={L_MAIN}; "
          f"max |err| of the sums {max_err:.3g}")

    # timing at the main path's operands: per-row Δ and trial columns
    ctr = torch.tensor([[0, 0, 0, 0]])
    kw = dict(k_steps=K_MAIN, n_v=N_V_MAIN, delta=math.inf)

    def kern():
        return pm.pdes_multistep_counter(tau0, ctr, dcol, tcol, **kw)

    def plain():
        return ref.pdes_multistep_counter_ref(tau0, ctr, dcol, tcol, **kw)

    p1 = timer(plain, 3)
    k1 = timer(kern, 20)
    k2 = timer(kern, 20)
    p2 = timer(plain, 3)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    # the kernel alone, without the wrapper's host work, at both L
    raw = {}
    for L in (L_MAIN, L_PAPER):
        tau_l, dcol_l, tcol_l = ((tau0, dcol, tcol) if L == L_MAIN else
                                 _kernel_inputs(torch, rng, B_MAIN, L, dev))
        tcol_l = build.u32_bits(tcol_l).reshape(B_MAIN, 1).contiguous()
        out = torch.empty_like(tau_l)
        stats = torch.empty((6, K_MAIN, B_MAIN), device=dev)
        raw[L] = min(timer(lambda: pm.counter_launch(
            tau_l, out, stats, dcol_l, tcol_l, (0, 0, 0, 0), n_v=N_V_MAIN,
            delta=math.inf, rd_mode=False, border_both=False), 20)
            for _ in range(2))
    print(f"[kernel] the kernel alone (raw launch): K={K_MAIN} chunk at "
          f"B={B_MAIN} L={L_MAIN} {raw[L_MAIN]:.5f} ms, L={L_PAPER} "
          f"{raw[L_PAPER]:.5f} ms")
    pe_steps = B_MAIN * L_MAIN * K_MAIN
    print(f"[kernel] K={K_MAIN} chunk at B={B_MAIN} L={L_MAIN} N_V={N_V_MAIN}:"
          f" kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
          f"(order plain, kernel, kernel, plain); kernel "
          f"{pe_steps / (k_ms * 1e-3):.4g} PE-steps/s, plain "
          f"{pe_steps / (p_ms * 1e-3):.4g} PE-steps/s")
    _, m = kern()
    ucount = float(m["ucount"].sum())
    n_bytes = 8 * B_MAIN * L_MAIN + 4 * len(m) * K_MAIN * B_MAIN + 8 * B_MAIN
    n_ops = OPS_PER_PE_STEP * pe_steps + OPS_PER_UPDATE * ucount
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    print(f"[kernel] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, "
          f"{n_ops:.4g} operations (utilization {ucount / pe_steps:.4f}) -> "
          f"{ops_ms:.4g} ms")
    print(f"[kernel] kernel at {max(bytes_ms, ops_ms) / k_ms:.3f} of the "
          f"bound")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_main_path(torch, pm, sweep, api, trace, dev, chunk_ms):
    """The service drain on the card, through the kernel.

    ``chunk_ms`` is the kernel's time for one K = 16 chunk at B = 448 from
    phase 2: every chunk of this drain has that shape, so launches x
    ``chunk_ms`` is the kernel's share of the drain.
    """
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_MAIN, burn_in=BURN_MAIN,
                  backend="pallas_multistep", k_fuse=K_MAIN, seed=0)
    specs = {
        "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
        "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
        "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
    }
    svc = api.SweepService(device=dev)
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    sync(torch, dev)
    pm.launches = 0
    t0 = time.perf_counter()
    responses = svc.drain()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = pm.launches
    st = svc.stats
    for resp in responses:
        check(resp.error is None, (resp.requester, resp.error))
    check(launches > 0, "the main path launched no kernel")
    check(st.n_deduped == 1 and st.n_passes == 1, st)
    check(st.rows_computed == B_MAIN, st)
    pe_steps = st.engine_row_steps * L_MAIN
    print(f"[main] drain of {len(responses)} requests: {wall:.3f} s wall, "
          f"{st.n_passes} coalesced pass, {st.rows_computed} rows, "
          f"{pe_steps:.4g} PE-steps, {pe_steps / wall:.4g} PE-steps/s, "
          f"{launches} kernel launches")
    print(f"[main] kernel time {launches} x {chunk_ms:.4f} ms = "
          f"{launches * chunk_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({launches * chunk_ms / (wall * 1e3):.3f} of the drain)")
    tracer = trace.TraceRecorder()
    prev = trace.set_tracer(tracer)
    direct = {}
    for resp in responses:
        spec = resp.spec
        if spec not in direct:
            direct[spec] = sweep.run_window_sweep(spec, device=dev)
        check(resp.result.as_dict() == direct[spec].as_dict(),
              f"{resp.requester}: response differs from a direct run")
        for rec in resp.result.records:
            check(0.0 < rec.u <= 1.0, rec)
            check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
            if math.isfinite(rec.delta):
                check(rec.spread <= rec.delta + ETA_MAX, rec)
            print(f"[main] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    trace.set_tracer(prev)
    for ev in tracer.events:
        print(f"[main] direct run_window_sweep span {ev['name']:7s} "
              f"{ev['dur'] / 1e3:9.3f} ms  {ev.get('args', {})}")
    print("[main] every response equals a direct run_window_sweep "
          "bit for bit; u in (0, 1]; spread <= delta + 17.4")
    return launches


def phase_step(torch, ps, ref, ops, events, build, dev, timer=cuda_ms):
    """B2 against its plain version at the main path's shape, then timed."""
    import numpy as np
    # counter bits with the service's negative pad trials, a Δ column with
    # inf rows, and the exact base
    tau, dcol, tcol = _kernel_inputs(torch, np.random.default_rng(1), B_MAIN,
                                     L_MAIN, dev)
    tau_h = ops.ring_halo(tau)
    bits = events.counter_bits_block(7, 0xFFFFFFFF, tcol[:, 0], 0, B_MAIN,
                                     L_MAIN)
    gvt = torch.amin(tau, dim=-1, keepdim=True)
    stale = gvt - 3.0                 # a stale base below the row minimum
    # (n_v, rd_mode, border_both, window base, static Δ)
    cases = [(1, False, False, gvt, 16.0), (10, False, False, gvt, 16.0),
             (10, False, False, gvt, math.inf), (10, True, False, gvt, 4.0),
             (10, False, True, gvt, 16.0), (10, False, False, stale, 16.0),
             (10, False, False, gvt + dcol, 0.0),
             (10, False, False, stale + dcol, 0.0)]
    max_err = 0.0
    for n_v, rd_mode, border_both, base, delta in cases:
        kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode,
                  border_both=border_both)
        t_k, m_k = ps.pdes_step(tau_h, bits, base, **kw)
        t_p, _, m_p = ref.pdes_step_ref(tau_h, bits, base, **kw)
        what = f"{kw} stale={base is stale}"
        check(torch.equal(t_k, t_p), f"tau' differs: {what}")
        for key in m_p:
            a, b = m_k[key], m_p[key]
            if key in EXACT_KEYS:
                check(torch.equal(a, b), f"{key} differs: {what}")
            else:
                check(torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL),
                      f"{key} beyond tolerance: {what}")
            max_err = max(max_err, float((a - b).abs().max()))
    print(f"[step] tau'/ucount/min/max bitwise equal to the plain version "
          f"over {len(cases)} cases at B={B_MAIN} Lc={L_MAIN}; max |err| of "
          f"the sums {max_err:.3g}")

    # timing at the main path's operands: N_V = 10, the folded Δ column
    base = gvt + dcol
    kw = dict(n_v=N_V_MAIN, delta=0.0, rd_mode=False, border_both=False)
    words = build.u32_bits(bits).reshape(bits.shape).contiguous()
    out = torch.empty((B_MAIN, L_MAIN), dtype=torch.float32, device=dev)
    stats = torch.empty((6, B_MAIN), dtype=torch.float32, device=dev)

    def kern():
        ps.launch(tau_h, words, base, out, stats, **kw)

    def plain():
        return ref.pdes_step_ref(tau_h, bits, base, **kw)

    p1 = timer(plain, 5)
    k1 = timer(kern, 200)
    k2 = timer(kern, 200)
    p2 = timer(plain, 5)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    print(f"[step] one step at B={B_MAIN} Lc={L_MAIN} N_V={N_V_MAIN}: kernel "
          f"{k1:.5f} / {k2:.5f} ms, plain {p1:.4f} / {p2:.4f} ms (order "
          f"plain, kernel, kernel, plain)")

    # the host-side pieces of one `pallas` engine step, at the same shape
    trials = torch.arange(B_MAIN, device=dev)
    pieces = {
        "counter_bits_block": lambda: events.counter_bits_block(
            0, 5, trials, 0, B_MAIN, L_MAIN),
        "int64->uint32 words": lambda: build.u32_bits(bits),
        "ring_halo": lambda: ops.ring_halo(tau),
        "amin (exact GVT)": lambda: torch.amin(tau, dim=-1, keepdim=True),
        "wrapper (int64 bits)": lambda: ps.pdes_step(tau_h, bits, base,
                                                     **kw),
    }
    for name, fn in pieces.items():
        print(f"[step] piece {name:22s} {timer(fn, 20):.5f} ms")
    ucount = float(ps.pdes_step(tau_h, bits, base, **kw)[1]["ucount"].sum())
    n_pe = B_MAIN * L_MAIN
    n_bytes = (4 * B_MAIN * (L_MAIN + 2) + 8 * n_pe + 4 * B_MAIN
               + 4 * n_pe + 4 * 6 * B_MAIN)
    n_ops = STEP_OPS_PER_PE * n_pe + STEP_OPS_PER_UPDATE * ucount
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    print(f"[step] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, {n_ops:.4g} "
          f"operations (utilization {ucount / n_pe:.4f}) -> {ops_ms:.4g} ms; "
          f"kernel at {bytes_ms / k_ms:.3f} of the bytes bound")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms,
                bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def _profile(torch, dev, fn):
    """Device time by kernel over one call of ``fn`` (run once before,
    unprofiled), from torch.profiler; None where the profiler gives no
    device time.  ``comm_host_us`` is the host time of the collectives'
    ``c10d::`` operators in the call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync(torch, dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows, comm_host_us = [], 0.0
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            if ev.key.startswith("c10d::"):
                comm_host_us += ev.cpu_time_total
            continue                  # host ops: their kernels are listed
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.key, ev.count))
    if not rows:
        return None
    rows.sort(reverse=True)
    return dict(wall_us=wall_us, busy_us=sum(r[0] for r in rows), rows=rows,
                comm_host_us=comm_host_us)


def _profile_steps(torch, engine_cls, cfg, dev, deltas, trials):
    """The profiler over one 16-step chunk of the stale `pallas` path."""
    eng = engine_cls(cfg, backend="pallas", window="stale", k_fuse=K_MAIN,
                     device=dev)
    st = eng.init(B_MAIN)
    return _profile(torch, dev, lambda: eng.run(st, 0, K_MAIN, deltas=deltas,
                                                trial_base=trials))


def phase_slice(torch, ps, sweep, api, opt, engine_mod, dev, step_ms):
    """B2's path: the `pallas` backend, exact and stale, with Δ* tuning.

    ``step_ms`` is B2's time for one step at B = 448 from phase 4; every
    step of part (b)'s drain has that shape.
    """
    times = {}
    ps.launches = 0
    # (a) exact window: pallas == pallas_multistep at the service's columns
    deltas = torch.tensor([d for d in (1.0, 4.0, 16.0, 64.0)
                           for _ in range(REPLICAS)]
                          + [d for d in (4.0, 16.0, math.inf)
                             for _ in range(REPLICAS)], device=dev)
    trials = torch.cat([torch.arange(4 * REPLICAS, device=dev),
                        torch.arange(3 * REPLICAS, device=dev)])
    cfg = engine_mod.PDESConfig(L=L_MAIN, n_v=N_V_MAIN)
    runs = {}
    for backend in ("pallas", "pallas_multistep"):
        eng = engine_mod.PDESEngine(cfg, backend=backend, k_fuse=K_MAIN,
                                    device=dev)
        sync(torch, dev)
        t0 = time.perf_counter()
        runs[backend] = eng.run(eng.init(B_MAIN), 0, STEPS_EXACT,
                                deltas=deltas, trial_base=trials)
        sync(torch, dev)
        times[f"a_{backend}"] = time.perf_counter() - t0
    (sa, a), (sb, b) = runs["pallas"], runs["pallas_multistep"]
    for f in ("tau", "offset", "offset_comp"):
        check(torch.equal(getattr(sa, f), getattr(sb, f)),
              f"pallas {f} differs from pallas_multistep")
    bitwise = []
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if f in ("utilization", "gvt"):
            check(torch.equal(x, y), f"pallas {f} differs")
        else:
            check(torch.allclose(x, y, rtol=SUM_RTOL, atol=SUM_ATOL),
                  f"pallas {f} beyond tolerance")
        if torch.equal(x, y):
            bitwise.append(f)
    print(f"[slice a] {STEPS_EXACT} exact-window steps at B={B_MAIN} "
          f"L={L_MAIN}: pallas {times['a_pallas']:.3f} s, pallas_multistep "
          f"{times['a_pallas_multistep']:.3f} s; tau, offsets, utilization "
          f"and gvt bitwise equal; bitwise StepStats fields: {bitwise}")

    # (b) the stale-window service drain
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_SLICE, burn_in=BURN_SLICE, backend="pallas",
                  window="stale", k_fuse=K_MAIN, seed=0)
    specs = {
        "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
        "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
        "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
    }
    svc = api.SweepService(device=dev)
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    sync(torch, dev)
    n0 = ps.launches
    t0 = time.perf_counter()
    responses = svc.drain()
    sync(torch, dev)
    times["b_drain"] = wall = time.perf_counter() - t0
    drain_launches = ps.launches - n0
    st = svc.stats
    for resp in responses:
        check(resp.error is None, (resp.requester, resp.error))
    check(st.n_deduped == 1 and st.n_passes == 1, st)
    check(st.rows_computed == B_MAIN, st)
    pe_steps = st.engine_row_steps * L_MAIN
    print(f"[slice b] stale drain of {len(responses)} requests: {wall:.3f} s "
          f"wall, {st.n_passes} coalesced pass, {st.rows_computed} rows, "
          f"{pe_steps:.4g} PE-steps, {pe_steps / wall:.4g} PE-steps/s, "
          f"{drain_launches} B2 launches")
    print(f"[slice b] B2 time {drain_launches} x {step_ms:.5f} ms = "
          f"{drain_launches * step_ms:.1f} ms of {wall * 1e3:.1f} ms wall "
          f"({drain_launches * step_ms / (wall * 1e3):.4f} of the drain); "
          f"{wall * 1e3 / (BURN_SLICE + STEPS_SLICE):.4f} ms wall per "
          f"engine step")
    t0 = time.perf_counter()
    direct, exact = {}, {}
    for resp in responses:
        spec = resp.spec
        if spec not in direct:
            direct[spec] = sweep.run_window_sweep(spec, device=dev)
            ex = sweep.run_window_sweep(
                sweep.WindowSweep(**{**common, "deltas": spec.deltas,
                                     "backend": "pallas_multistep",
                                     "window": "exact"}), device=dev)
            exact.update({(spec, r.delta): r.u for r in ex.records})
        check(resp.result.as_dict() == direct[spec].as_dict(),
              f"{resp.requester}: response differs from a direct run")
        for rec in resp.result.records:
            check(0.0 < rec.u <= 1.0, rec)
            check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
            if math.isfinite(rec.delta):
                check(rec.spread <= rec.delta + ETA_MAX, rec)
            u_ex = exact[(spec, rec.delta)]
            check(rec.u <= u_ex + 0.01,
                  f"stale u {rec.u} above exact u {u_ex} + 0.01")
            print(f"[slice b] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} (exact {u_ex:.6f}) "
                  f"w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    sync(torch, dev)
    times["b_direct"] = time.perf_counter() - t0
    print(f"[slice b] every stale response equals a direct run_window_sweep "
          f"bit for bit; u in (0, 1]; spread <= delta + 17.4; stale u <= "
          f"exact u + 0.01 (direct and exact runs {times['b_direct']:.3f} s)")

    # (c) Δ* through one service
    coarse = sweep.WindowSweep(
        deltas=(1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0), **common)
    svc = api.SweepService(device=dev)
    t0 = time.perf_counter()
    refined = opt.refine_optimal_window(coarse, service=svc)
    sync(torch, dev)
    times["c_refine"] = time.perf_counter() - t0
    check(refined.bracket[0] <= refined.delta_star <= refined.bracket[1],
          refined)
    check(all(math.isfinite(e) for _, e in refined.evaluations), refined)
    check(svc.stats.rows_from_state_cache > 0,
          "the polish did not use the state cache")
    print(f"[slice c] refine_optimal_window: delta*={refined.delta_star:.6g} "
          f"bracket={refined.bracket} interior={refined.interior} "
          f"rounds={refined.rounds} eff*={refined.eff_star:.6g} "
          f"u*={refined.u_star:.6f} w*={refined.w_star:.6g}; "
          f"{svc.stats.n_requests} probes in {svc.stats.n_passes} passes, "
          f"{svc.stats.rows_from_state_cache} rows from the state cache, "
          f"{times['c_refine']:.3f} s")
    print("[slice c] evaluations (delta, efficiency): "
          + json.dumps([[d, e] for d, e in refined.evaluations]))
    launches = ps.launches
    check(launches > 0, "B2's path launched no kernel")
    total = sum(times.values())
    print(f"[slice] B2 launches over the phase: {launches}; wall "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items())
          + f"; total {total:.3f} s")
    prof = _profile_steps(torch, engine_mod.PDESEngine, cfg, dev, deltas,
                          trials)
    if prof is None:
        print("[slice] torch.profiler gave no device time: idle share "
              "not measured")
    else:
        print(f"[slice] profiler, one {K_MAIN}-step stale chunk at "
              f"B={B_MAIN}: wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
              f"{prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f})")
        for us, key, count in prof["rows"][:12]:
            print(f"[slice] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{key[:90]}")
    return launches



def _bound(n_bytes, n_ops):
    bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / SCALAR_OPS_PER_S * 1e3
    return bytes_ms, ops_ms, dict(
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations")


def phase_generator(torch, tf, prng, dev, timer=cuda_ms):
    """The generator against its plain version, the KATs and JAX's words."""
    cols = torch.tensor([k for k, _ in THREEFRY_KAT], device=dev).T
    y0, y1 = prng.threefry2x32(*cols)
    got = list(zip(y0.tolist(), y1.tolist()))
    check(got == [w for _, w in THREEFRY_KAT],
          f"threefry2x32 fails the known-answer vectors: {got}")
    key = prng.key(7, dev)
    shape = (B_MAIN, L_MAIN)
    step0 = 2**31 - 8                 # the chunk crosses the int32 boundary
    got = tf.threefry_bits(key, step0, K_MAIN, shape)
    want = tf.threefry_bits_plain(key, step0, K_MAIN, shape)
    n_bad = int((got != want).sum())
    check(n_bad == 0, f"generator differs from the plain version on "
                      f"{n_bad} words")
    max_err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    del want
    for step in sorted({w[0] for w in JAX_WORDS}):
        words = tf.threefry_bits(key, step, 1, shape)[0]
        words = words.to(torch.int64).cpu() & 0xFFFFFFFF
        for s, b, l, w0, w1 in JAX_WORDS:
            if s == step:
                pair = (int(words[b, l, 0]), int(words[b, l, 1]))
                check(pair == (w0, w1),
                      f"generator word ({s}, {b}, {l}) {pair} is not JAX's")
    print(f"[gen] threefry2x32 on the card gives the {len(THREEFRY_KAT)} "
          f"known-answer vectors; a K={K_MAIN} chunk at B={B_MAIN} "
          f"L={L_MAIN} (steps {step0}..{step0 + K_MAIN - 1}) equals the "
          f"plain version on all {got.numel()} words; the {len(JAX_WORDS)} "
          f"committed JAX words match")
    del got
    buf = torch.empty((K_MAIN, B_MAIN, L_MAIN, 2), dtype=torch.int32,
                      device=dev)

    def kern():
        return tf.threefry_bits(key, 0, K_MAIN, shape, out=buf)

    def plain():
        return tf.threefry_bits_plain(key, 0, K_MAIN, shape, out=buf)

    p1 = timer(plain, 2)
    k1 = timer(kern, 20)
    k2 = timer(kern, 20)
    p2 = timer(plain, 2)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    n_words = 2 * K_MAIN * B_MAIN * L_MAIN
    n_bytes, n_ops = 4 * n_words + 16, GEN_OPS_PER_WORD * n_words
    bytes_ms, ops_ms, bound = _bound(n_bytes, n_ops)
    print(f"[gen] K={K_MAIN} chunk at B={B_MAIN} L={L_MAIN}: kernel "
          f"{k1:.5f} / {k2:.5f} ms, plain {p1:.4f} / {p2:.4f} ms (order "
          f"plain, kernel, kernel, plain); {n_words / (k_ms * 1e-3):.4g} "
          f"words/s")
    print(f"[gen] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, {n_ops:.4g} "
          f"operations -> {ops_ms:.4g} ms at 67 T/s; kernel at "
          f"{bound['bound_ms'] / k_ms:.3f} of the bound")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, **bound)


def phase_bits_kernel(torch, pm, tf, prng, ref, dev, timer=cuda_ms):
    """B3 against its plain version on generator words, then timed."""
    import numpy as np
    rng = np.random.default_rng(2)
    tau0 = torch.as_tensor(
        rng.exponential(4.0, size=(B_MAIN, L_MAIN)).astype(np.float32),
        device=dev)
    key = prng.key(7, dev)
    shape = (B_MAIN, L_MAIN)
    buf = torch.empty((K_MAIN, *shape, 2), dtype=torch.int32, device=dev)
    # (n_v, Δ, rd_mode, border_both)
    cases = [(1, 16.0, False, False), (10, 16.0, False, False),
             (10, math.inf, False, False), (10, 16.0, True, False),
             (10, 16.0, False, True)]
    max_err = 0.0
    for n_v, delta, rd_mode, border_both in cases:
        kw = dict(n_v=n_v, delta=delta, rd_mode=rd_mode,
                  border_both=border_both)
        tau, step = tau0, 0
        for k in (K_MAIN, 5):
            bits = tf.threefry_bits(key, step, k, shape, out=buf[:k])
            t_k, m_k = pm.pdes_multistep(tau, bits, **kw)
            t_p, m_p = ref.pdes_multistep_ref(tau, bits, **kw)
            what = f"{kw} K={k}"
            check(torch.equal(t_k, t_p), f"tau differs: {what}")
            for name in m_p:
                a, b = m_k[name], m_p[name]
                if name in EXACT_KEYS:
                    check(torch.equal(a, b), f"{name} differs: {what}")
                else:
                    check(torch.allclose(a, b, rtol=SUM_RTOL, atol=SUM_ATOL),
                          f"{name} beyond tolerance: {what}")
                max_err = max(max_err, float((a - b).abs().max()))
            tau, step = t_k, step + k
    print(f"[b3] tau/ucount/min/max bitwise equal to the plain version over "
          f"{len(cases)} cases x chunks K={K_MAIN} and K=5 at B={B_MAIN} "
          f"L={L_MAIN}; max |err| of the sums {max_err:.3g}")

    bits = tf.threefry_bits(key, 0, K_MAIN, shape, out=buf)
    kw = dict(n_v=N_V_MAIN, delta=DELTA_SIM)

    def kern():
        return pm.pdes_multistep(tau0, bits, **kw)

    def plain():
        return ref.pdes_multistep_ref(tau0, bits, **kw)

    p1 = timer(plain, 3)
    k1 = timer(kern, 20)
    k2 = timer(kern, 20)
    p2 = timer(plain, 3)
    k_ms, p_ms = min(k1, k2), min(p1, p2)
    # the kernel alone, without the wrapper's host work, at both L
    raw = {}
    for L in (L_MAIN, L_PAPER):
        tau_l = tau0 if L == L_MAIN else torch.as_tensor(
            rng.exponential(4.0, size=(B_MAIN, L)).astype(np.float32),
            device=dev)
        bits_l = bits if L == L_MAIN else \
            tf.threefry_bits(key, 0, K_MAIN, (B_MAIN, L))
        out = torch.empty_like(tau_l)
        stats = torch.empty((6, K_MAIN, B_MAIN), device=dev)
        raw[L] = min(timer(lambda: pm.bits_launch(
            tau_l, bits_l, out, stats, rd_mode=False, border_both=False,
            **kw), 20) for _ in range(2))
    print(f"[b3] the kernel alone (raw launch): K={K_MAIN} chunk at "
          f"B={B_MAIN} L={L_MAIN} {raw[L_MAIN]:.5f} ms, L={L_PAPER} "
          f"{raw[L_PAPER]:.5f} ms")
    pe_steps = B_MAIN * L_MAIN * K_MAIN
    print(f"[b3] K={K_MAIN} chunk at B={B_MAIN} L={L_MAIN} N_V={N_V_MAIN} "
          f"delta={DELTA_SIM:g}: kernel {k1:.5f} / {k2:.5f} ms, plain "
          f"{p1:.4f} / {p2:.4f} ms (order plain, kernel, kernel, plain); "
          f"{pe_steps / (k_ms * 1e-3):.4g} PE-steps/s")
    ucount = float(kern()[1]["ucount"].sum())
    n_bytes = 8 * pe_steps + 8 * B_MAIN * L_MAIN + 4 * 6 * K_MAIN * B_MAIN
    n_ops = B3_OPS_PER_PE_STEP * pe_steps + B3_OPS_PER_UPDATE * ucount
    bytes_ms, ops_ms, bound = _bound(n_bytes, n_ops)
    print(f"[b3] bound: {n_bytes} bytes -> {bytes_ms:.4g} ms, {n_ops:.4g} "
          f"operations (utilization {ucount / pe_steps:.4f}) -> "
          f"{ops_ms:.4g} ms; kernel at {bytes_ms / k_ms:.3f} of the bytes "
          f"bound, {n_bytes / (k_ms * 1e-3) / 1e12:.3f} TB/s")
    return dict(max_abs_err=max_err, ms=k_ms, plain_ms=p_ms, **bound)


def _profile_chunks(torch, ops, state, key, cfg, dev):
    """The profiler over ``PROFILE_CHUNKS`` K-step ``simulate`` chunks."""
    n_steps = PROFILE_CHUNKS * K_MAIN
    return _profile(torch, dev, lambda: ops.simulate(state, key, cfg, n_steps,
                                                     k_fuse=K_MAIN))


class plain_simulate:
    """Within the block, ``ops.simulate`` runs the plain versions of B3 and
    of the generator on the card, with the same chunking: what the kernels
    are held against."""

    def __init__(self, ops, ref, tf):
        self.ops, self.saved = ops, (ops.pdes_multistep, ops.threefry_bits)
        self.plain = (ref.pdes_multistep_ref, tf.threefry_bits_plain)

    def __enter__(self):
        self.ops.pdes_multistep, self.ops.threefry_bits = self.plain

    def __exit__(self, *exc):
        self.ops.pdes_multistep, self.ops.threefry_bits = self.saved


def phase_threefry_path(torch, ops, pm, tf, ref, horizon, prng, ensemble,
                        dev):
    """B3's path: ``simulate``, ``horizon.run`` and the threefry ensemble."""
    cfg = horizon.PDESConfig(L=L_MAIN, n_v=N_V_MAIN, delta=DELTA_SIM)
    key = prng.key(0, dev)
    st0 = horizon.init_state(cfg, B_MAIN, dev)
    times = {}
    sync(torch, dev)
    pm.bits_launches = tf.launches = 0
    # (a) simulate with the kernels == with the plain versions, bitwise
    t0 = time.perf_counter()
    st_k, out_k = ops.simulate(st0, key, cfg, STEPS_SIM, k_fuse=K_MAIN)
    sync(torch, dev)
    times["a_kernels"] = time.perf_counter() - t0
    a_launches = (pm.bits_launches, tf.launches)
    check(a_launches == (STEPS_SIM // K_MAIN,) * 2,
          f"simulate launched B3 and the generator {a_launches} times")
    with plain_simulate(ops, ref, tf):
        t0 = time.perf_counter()
        st_p, out_p = ops.simulate(st0, key, cfg, STEPS_SIM, k_fuse=K_MAIN)
        sync(torch, dev)
        times["a_plain"] = time.perf_counter() - t0
    check((pm.bits_launches, tf.launches) == a_launches,
          "the plain simulate launched a kernel")
    for f in ("tau", "offset", "offset_comp"):
        check(torch.equal(getattr(st_k, f), getattr(st_p, f)),
              f"simulate {f} differs from the plain versions")
    for name in ("u", "gvt"):
        check(torch.equal(out_k[name], out_p[name]),
              f"simulate {name} differs from the plain versions")
    check(torch.allclose(out_k["w2"], out_p["w2"], rtol=SUM_RTOL,
                         atol=SUM_ATOL), "simulate w2 beyond tolerance")
    u_last = float(out_k["u"][-K_MAIN:].mean())
    check(0.0 < u_last <= 1.0, u_last)
    pe_steps = STEPS_SIM * B_MAIN * L_MAIN
    print(f"[path a] simulate {STEPS_SIM} steps at B={B_MAIN} L={L_MAIN} "
          f"N_V={N_V_MAIN} delta={DELTA_SIM:g}: kernels "
          f"{times['a_kernels']:.3f} s ({times['a_kernels'] * 1e3 * K_MAIN / STEPS_SIM:.4f} "
          f"ms a chunk, {pe_steps / times['a_kernels']:.4g} PE-steps/s), "
          f"plain {times['a_plain']:.3f} s; tau, offsets, u and gvt "
          f"bitwise equal, w2 to tolerance; u over the last chunk "
          f"{u_last:.6f}; launches B3 {a_launches[0]}, generator "
          f"{a_launches[1]}")

    # (b) simulate against horizon.run: the JAX test's shape and bounds ...
    small = horizon.PDESConfig(L=64, n_v=4, delta=8.0)
    for n_steps, k_fuse in ((5, 8), (16, 8), (37, 8), (24, 6)):
        s0 = horizon.init_state(small, 8, dev)
        sa, stats_a = horizon.run(s0, prng.key(3, dev), small, n_steps)
        sb, out_b = ops.simulate(s0, prng.key(3, dev), small, n_steps,
                                 k_fuse=k_fuse)
        check(torch.allclose(stats_a.utilization, out_b["u"], rtol=1e-6,
                             atol=0), f"u: simulate != run ({n_steps})")
        check(torch.allclose(stats_a.w2, out_b["w2"], rtol=1e-4, atol=1e-4),
              f"w2: simulate != run ({n_steps})")
        check(torch.allclose(sa.tau + sa.offset[:, None],
                             sb.tau + sb.offset[:, None], rtol=1e-5,
                             atol=1e-4), f"tau: simulate != run ({n_steps})")
    # ... and at full width from (a)'s burned state: reported, not bitwise
    sync(torch, dev)
    t0 = time.perf_counter()
    sr, stats_r = horizon.run(st_k, key, cfg, STEPS_CMP)
    sync(torch, dev)
    times["b_run"] = time.perf_counter() - t0
    ss, out_s = ops.simulate(st_k, key, cfg, STEPS_CMP, k_fuse=K_MAIN)
    du = (stats_r.utilization.mean(1) - out_s["u"].mean(1)).abs().max()
    du = float(du)
    check(du <= 1e-4, f"ensemble-mean u per step differs by {du}")
    abs_r = sr.tau.double() + sr.offset.double()[:, None]
    abs_s = ss.tau.double() + ss.offset.double()[:, None]
    outside = float(((abs_r - abs_s).abs() > 1e-5 * abs_s.abs()).double()
                    .mean())
    spread = (stats_r.max_dev + stats_r.min_dev).max()
    check(float(spread) <= DELTA_SIM + ETA_MAX, f"spread {float(spread)}")
    print(f"[path b] simulate == horizon.run at L=64 N_V=4 delta=8 B=8 for "
          f"(n_steps, k_fuse) in (5, 8), (16, 8), (37, 8), (24, 6) to the "
          f"JAX test's bounds; at full width over {STEPS_CMP} steps after "
          f"{STEPS_SIM}: max |ensemble-mean u per step| difference {du:.3g}, "
          f"share of PEs outside rtol 1e-5 {outside:.6g}; horizon.run "
          f"{times['b_run'] * 1e3 / STEPS_CMP:.4f} ms a step; largest spread "
          f"{float(spread):.5g} <= delta + 17.4")

    # (c) the threefry ensemble (backend=None) against pallas_multistep
    common = dict(n_trials=B_MAIN, seed=0, burn_in_steps=BURN_THREEFRY,
                  measure_steps=STEPS_THREEFRY, device=dev)
    steps = BURN_THREEFRY + STEPS_THREEFRY
    sync(torch, dev)
    pm.bits_launches = tf.launches = 0
    t0 = time.perf_counter()
    tfry = ensemble.steady_state(cfg, backend=None, **common)
    sync(torch, dev)
    times["c_threefry"] = time.perf_counter() - t0
    c_launches = (pm.bits_launches, tf.launches)
    check(c_launches == (0, steps), f"steady_state(backend=None) launched "
                                    f"B3 and the generator {c_launches} "
                                    f"times, not (0, {steps})")
    t0 = time.perf_counter()
    ctr = ensemble.steady_state(cfg, backend="pallas_multistep",
                                engine_opts={"k_fuse": K_MAIN}, **common)
    sync(torch, dev)
    times["c_counter"] = time.perf_counter() - t0
    for rec in (tfry, ctr):
        check(0.0 < rec.utilization <= 1.0, rec)
        check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
    tol = max(0.01, 6 * math.hypot(tfry.utilization_err,
                                   ctr.utilization_err))
    diff = abs(tfry.utilization - ctr.utilization)
    check(diff <= tol, f"threefry u {tfry.utilization} vs counter u "
                       f"{ctr.utilization}: {diff} > {tol}")
    print(f"[path c] steady_state at B={B_MAIN} L={L_MAIN} N_V={N_V_MAIN} "
          f"delta={DELTA_SIM:g}, burn {BURN_THREEFRY} + measure "
          f"{STEPS_THREEFRY} (default_burn_in {ensemble.default_burn_in(cfg)}"
          f"): threefry u={tfry.utilization:.6f}+-"
          f"{tfry.utilization_err:.2g} w={tfry.w:.5g} "
          f"rate={tfry.rate:.6f} in {times['c_threefry']:.3f} s "
          f"({times['c_threefry'] * 1e3 / steps:.4f} ms a step); counter "
          f"stream (pallas_multistep) u={ctr.utilization:.6f}+-"
          f"{ctr.utilization_err:.2g} w={ctr.w:.5g} rate={ctr.rate:.6f} in "
          f"{times['c_counter']:.3f} s; |du| {diff:.3g} <= {tol:.3g}; "
          f"generator launches {c_launches[1]}, one a step")
    print(f"[path] launches on the simulate path (a): B3 {a_launches[0]}, "
          f"generator {a_launches[1]}; wall "
          + ", ".join(f"{k} {v:.3f} s" for k, v in times.items()))
    prof = _profile_chunks(torch, ops, st_k, key, cfg, dev)
    if prof is None:
        print("[path] torch.profiler gave no device time: idle share "
              "not measured")
    else:
        print(f"[path] profiler, {PROFILE_CHUNKS} {K_MAIN}-step simulate "
              f"chunks at B={B_MAIN}: wall {prof['wall_us'] / 1e3:.3f} ms, "
              f"device busy {prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f})")
        for us, name, count in prof["rows"][:8]:
            print(f"[path] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{name[:90]}")
    return a_launches


def phase_sharded(torch, ps, engine_mod, D, mesh_mod, sweep, api, dev):
    """The sharded backend on the card: one rank of a process group of
    one (NCCL on the card), B2 as each shard's step.  Returns B2's
    launches on the sharded service drain."""
    import datetime
    import torch.distributed as dist
    backend = "nccl" if torch.device(dev).type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        mesh = mesh_mod.make_mesh((1, 1), ("data", "model"), device=dev)
        print(f"[sharded] {backend} process group of one rank, {mesh}")
        return _sharded_runs(torch, ps, engine_mod, D, mesh, sweep, api, dev)
    finally:
        dist.destroy_process_group()


def _sharded_runs(torch, ps, engine_mod, D, mesh, sweep, api, dev):
    cfg = engine_mod.PDESConfig(L=L_MAIN, n_v=N_V_MAIN, delta=DELTA_SHARDED)
    z = torch.zeros(B_MAIN, device=dev)
    tau0 = torch.zeros((B_MAIN, L_MAIN), device=dev)
    phase_launches = 0
    # (a) exact and (b) commavoid against the engines with their rebase
    # schedule (bitwise), and against the unsharded oracle, which never
    # rebases, so its times round differently after the first chunk
    for part, mode, window, backend in (("a", "exact", "exact",
                                         "pallas_multistep"),
                                        ("b", "commavoid", "stale",
                                         "pallas")):
        dc = D.DistConfig(mode=mode, k_chunk=K_MAIN)
        sync(torch, dev)
        ps.launches = 0
        t0 = time.perf_counter()
        tau, off, comp, st = D.run_sharded_state(
            cfg, mesh, n_steps=STEPS_SHARDED, seed=0, dist=dc, tau0=tau0,
            off0=z, comp0=z)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        launches = ps.launches
        phase_launches += launches
        per_step = 1 if mode == "exact" else 3
        check(launches == per_step * STEPS_SHARDED,
              f"sharded {mode} launched B2 {launches} times")
        eng = engine_mod.PDESEngine(cfg, backend=backend, window=window,
                                    k_fuse=K_MAIN, device=dev)
        s_e, st_e = eng.run(eng.init(B_MAIN), 0, STEPS_SHARDED)
        for name, a, b in (("tau", tau, s_e.tau), ("offset", off, s_e.offset),
                           ("offset_comp", comp, s_e.offset_comp),
                           ("u", st["u"], st_e.utilization),
                           ("gvt", st["gvt"], st_e.gvt)):
            check(torch.equal(a, b),
                  f"sharded {mode} {name} differs from {backend}")
        for name in ("w2", "mean_tau", "max_dev", "min_dev"):
            check(torch.allclose(st[name], getattr(st_e, name),
                                 rtol=SUM_RTOL, atol=SUM_ATOL),
                  f"sharded {mode} {name} beyond tolerance of {backend}")
        tau_r, st_r = D.run_reference(
            cfg, n_trials=B_MAIN, n_steps=STEPS_SHARDED, seed=0,
            stale_every=None if mode == "exact" else K_MAIN, device=dev)
        u_s, u_r = st["u"].mean(0), st_r["u"].mean(0)   # per-row time means
        du = abs(float(u_s.mean() - u_r.mean()))
        tol = max(0.01, 6 * math.hypot(float(u_s.std()), float(u_r.std()))
                  / math.sqrt(B_MAIN))
        check(du <= tol, f"sharded {mode} u differs from run_reference by "
                         f"{du} > {tol}")
        same = float((tau + off[:, None] == tau_r).double().mean())
        spread = float((st["max_dev"] + st["min_dev"]).max())
        check(spread <= DELTA_SHARDED + ETA_MAX, f"spread {spread}")
        print(f"[sharded {part}] {mode}: {STEPS_SHARDED} steps at B={B_MAIN}"
              f" L={L_MAIN} N_V={N_V_MAIN} delta={DELTA_SHARDED:g} in "
              f"{wall:.3f} s, {launches} B2 launches; tau, offsets, u and gvt"
              f" bitwise equal to the {backend} engine ({window} window), "
              f"w2/mean/max_dev/min_dev to tolerance; against run_reference "
              f"(no rebase): mean u {float(u_s.mean()):.6f} vs "
              f"{float(u_r.mean()):.6f}, |du| {du:.3g} <= {tol:.3g}, share of"
              f" tau bitwise equal {same:.4f}; largest spread {spread:.5g}")
    # the JAX test's shape against the oracle, to its tolerances
    for delta, n_v, mode, k in ((5.0, 1, "exact", 8), (math.inf, 1, "exact",
                                                      8),
                                (5.0, 10, "commavoid", 4),
                                (10.0, 3, "commavoid", 8)):
        small = engine_mod.PDESConfig(L=32, n_v=n_v, delta=delta)
        t_s, s_s = D.run_sharded(small, mesh, n_trials=6, n_steps=24, seed=7,
                                 dist=D.DistConfig(mode=mode, k_chunk=k))
        t_r, s_r = D.run_reference(small, n_trials=6, n_steps=24, seed=7,
                                   stale_every=None if mode == "exact"
                                   else k, device=dev)
        e_tau = float((t_s - t_r).abs().max())
        e_u = float((s_s["u"] - s_r["u"]).abs().max())
        check(e_tau < 1e-4 and e_u < 1e-6,
              f"{mode} delta={delta} n_v={n_v}: tau {e_tau}, u {e_u}")
    print("[sharded] run_sharded == run_reference at L=32, 6 trials, 24 "
          "steps (tests/test_distributed_pdes.py's cases and bounds)")

    # (c) the service drain of phase 3's requests on the sharded backend
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_SLICE, burn_in=BURN_SLICE, backend="sharded",
                  k_fuse=K_MAIN, seed=0)
    specs = {
        "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
        "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
        "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common),
    }
    svc = api.SweepService(mesh=mesh)
    for who, spec in specs.items():
        svc.submit(spec, requester=who)
    sync(torch, dev)
    ps.launches = 0
    t0 = time.perf_counter()
    responses = svc.drain()
    sync(torch, dev)
    wall = drain_wall = time.perf_counter() - t0
    drain_launches = ps.launches
    phase_launches += drain_launches
    st = svc.stats
    for resp in responses:
        check(resp.error is None, (resp.requester, resp.error))
    check(drain_launches > 0, "the sharded drain launched no B2")
    check(st.n_deduped == 1 and st.n_passes == 1, st)
    check(st.rows_computed == B_MAIN, st)
    pe_steps = st.engine_row_steps * L_MAIN
    print(f"[sharded c] drain of {len(responses)} requests: {wall:.3f} s "
          f"wall, {st.n_passes} coalesced pass, {st.rows_computed} rows, "
          f"{pe_steps:.4g} PE-steps, {pe_steps / wall:.4g} PE-steps/s, "
          f"{drain_launches} B2 launches")
    direct, fused = {}, {}
    t0 = time.perf_counter()
    for resp in responses:
        spec = resp.spec
        if spec not in direct:
            direct[spec] = sweep.run_window_sweep(spec, mesh=mesh)
            fused[spec] = sweep.run_window_sweep(
                sweep.WindowSweep(**{**common, "deltas": spec.deltas,
                                     "backend": "pallas_multistep"}),
                device=dev)
        # JSON spells the NaN wa of the sharded backend alike on both sides
        check(json.dumps(resp.result.as_dict())
              == json.dumps(direct[spec].as_dict()),
              f"{resp.requester}: response differs from a direct run")
        for rec, ref in zip(resp.result.records, fused[spec].records):
            check((rec.u, rec.u_err, rec.rate, rec.rate_err)
                  == (ref.u, ref.u_err, ref.rate, ref.rate_err),
                  f"{resp.requester}: {rec} vs pallas_multistep {ref}")
            check(math.isclose(rec.w2, ref.w2, rel_tol=SUM_RTOL),
                  f"{resp.requester}: w2 {rec.w2} vs {ref.w2}")
            check(0.0 < rec.u <= 1.0, rec)
            check(math.isfinite(rec.w2) and math.isfinite(rec.rate), rec)
            if math.isfinite(rec.delta):
                check(rec.spread <= rec.delta + ETA_MAX, rec)
            print(f"[sharded c] {resp.requester:5s} delta={rec.delta:<5g} "
                  f"u={rec.u:.6f}+-{rec.u_err:.2g} w2={rec.w2:.5g} "
                  f"spread={rec.spread:.5g} rate={rec.rate:.6f}")
    sync(torch, dev)
    print(f"[sharded c] every response equals a direct run_window_sweep("
          f"mesh=) bit for bit; u, u_err, rate, rate_err equal to "
          f"pallas_multistep at the same depth, w2 within {SUM_RTOL:g}; "
          f"u in (0, 1]; spread <= delta + 17.4 (direct runs "
          f"{time.perf_counter() - t0:.3f} s)")

    # (d) wall per chunk, beside the pallas backend's, and a profile
    n_steps = TIMED_CHUNKS * K_MAIN
    walls = {}
    runs = {
        "sharded exact": lambda: D.run_sharded_state(
            cfg, mesh, n_steps=n_steps, seed=0, tau0=tau0, off0=z, comp0=z,
            dist=D.DistConfig(mode="exact", k_chunk=K_MAIN)),
        "sharded commavoid": lambda: D.run_sharded_state(
            cfg, mesh, n_steps=n_steps, seed=0, tau0=tau0, off0=z, comp0=z,
            dist=D.DistConfig(mode="commavoid", k_chunk=K_MAIN))}
    for window in ("exact", "stale"):
        eng = engine_mod.PDESEngine(cfg, backend="pallas", window=window,
                                    k_fuse=K_MAIN, device=dev)
        runs[f"pallas {window}"] = (
            lambda eng=eng: eng.run(eng.init(B_MAIN), 0, n_steps))
    for fn in runs.values():
        fn()
    for r in range(TIMED_ROUNDS):             # in turns, the order flipped
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            sync(torch, dev)
            t0 = time.perf_counter()
            runs[name]()
            sync(torch, dev)
            walls.setdefault(name, []).append(
                (time.perf_counter() - t0) * 1e3 / TIMED_CHUNKS)
    med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
    for name, v in walls.items():
        print(f"[sharded d] wall per {K_MAIN}-step chunk at B={B_MAIN} "
              f"L={L_MAIN}, {name}: median {med[name]:.3f} ms of "
              f"{TIMED_ROUNDS} calls of {TIMED_CHUNKS} chunks ("
              + ", ".join(f"{x:.3f}" for x in v) + ")")
    print(f"[sharded d] medians: sharded exact / pallas exact "
          f"{med['sharded exact'] / med['pallas exact']:.3f}, sharded "
          f"commavoid / pallas stale "
          f"{med['sharded commavoid'] / med['pallas stale']:.3f}")
    print(f"[sharded] B2 launches in the phase (sharded runs a, b, c): "
          f"{phase_launches}")
    one = D.DistConfig(mode="exact", k_chunk=K_MAIN)
    prof = _profile(torch, dev, lambda: D.run_sharded_state(
        cfg, mesh, n_steps=K_MAIN, seed=0, dist=one, tau0=tau0, off0=z,
        comp0=z))
    if prof is None:
        print("[sharded] torch.profiler gave no device time: idle share "
              "not measured")
    else:
        nccl_us = sum(us for us, key, _ in prof["rows"]
                      if "nccl" in key.lower())
        print(f"[sharded] profiler, one {K_MAIN}-step exact chunk at "
              f"B={B_MAIN}: wall {prof['wall_us'] / 1e3:.3f} ms, device busy "
              f"{prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f}); NCCL kernels "
              f"{nccl_us / 1e3:.4f} ms of device time "
              f"({nccl_us / prof['busy_us']:.4f} of busy), c10d operators "
              f"{prof['comm_host_us'] / 1e3:.3f} ms of host time "
              f"({prof['comm_host_us'] / prof['wall_us']:.4f} of wall)")
        for us, key, count in prof["rows"][:10]:
            print(f"[sharded] profiler {us / 1e3:9.3f} ms {count:6d}x  "
                  f"{key[:90]}")
    return drain_launches, {
        "wall": drain_wall,
        "results": {resp.requester: json.dumps(resp.result.as_dict())
                    for resp in responses}}


def _write_queue(path, wire, specs) -> None:
    path.write_text("".join(json.dumps(wire.encode_request(spec, who)) + "\n"
                            for who, spec in specs.items()))


def _lines(path) -> dict:
    """Response lines of a JSONL file by requester (errors fail)."""
    out = {}
    for line in path.read_text().strip().splitlines():
        obj = json.loads(line)
        check("error" not in obj, obj)
        out[obj["requester"]] = obj
    return out


def _run(cmd, env, what, ok=(0,)):
    proc = subprocess.run(cmd, env=env, cwd=env["ROOT"], capture_output=True,
                          text=True, timeout=SUBPROCESS_S)
    check(proc.returncode in ok, f"{what} exited {proc.returncode}:\n"
          f"{proc.stderr[-3000:]}")
    return proc


def _series(metrics_dir) -> dict:
    snap = json.loads((metrics_dir / "metrics.json").read_text())
    return {s["name"]: s for s in snap["series"] if not s["labels"]}


def phase_service(torch, pm, ps, sweep, wire, daemon, api, trace, dev, root,
                  sharded):
    """The serve daemon, telemetry and ``--mesh`` on the card.

    ``sharded`` is phase 9's: its service drain's wall and results.
    Returns B1's launches on the reference drain (a) and B2's in the
    ``--mesh`` CLI drain (d).
    """
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=REPLICAS,
                  n_steps=STEPS_MAIN, burn_in=BURN_MAIN,
                  backend="pallas_multistep", k_fuse=K_MAIN, seed=0)
    alice = sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0), **common)
    q1 = {"alice": alice,
          "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **common),
          "carol": alice}
    q2 = {"dave": dataclasses.replace(alice, n_steps=STEPS_DAVE)}
    specs = {**q1, **q2}
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))
    env = dict(os.environ, PYTHONPATH=str(root / "src"), ROOT=str(root))
    env.pop("RANK", None)
    on_cpu = torch.device(dev).type == "cpu"
    device_args = ["--device", "cpu"] if on_cpu else []

    def intake(name):
        d = work / name / "intake"
        d.mkdir(parents=True)
        _write_queue(d / "q1.jsonl", wire, q1)
        _write_queue(d / "q2.jsonl", wire, q2)
        return d

    def serve(name, telemetry):
        """An in-process daemon over both files; (wall, stats, lines)."""
        d = intake(name)
        cfg = daemon.DaemonConfig(
            intake_dir=str(d), out_path=str(d.parent / "responses.jsonl"),
            poll_interval_s=0.01, idle_exit_rounds=1, max_files_per_round=1,
            metrics_dir=str(d.parent / "metrics") if telemetry else None,
            trace_path=str(d.parent / "trace.json") if telemetry else None)
        log = []
        sync(torch, dev)
        t0 = time.perf_counter()
        stats = daemon.serve_daemon(cfg, service=api.SweepService(device=dev),
                                    log=log.append)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        check(sorted(os.listdir(d)) == ["q1.jsonl.done", "q2.jsonl.done"],
              os.listdir(d))
        return wall, stats, _lines(d.parent / "responses.jsonl"), log

    try:
        # (a) the reference drain, telemetry off, B1's launches read
        pm.launches = 0
        wall_a, st, ref, log = serve("a", telemetry=False)
        b1_launches = pm.launches
        check(b1_launches > 0, "the daemon's drain launched no B1")
        check(set(ref) == set(specs), sorted(ref))
        check(st.n_passes == 2 and st.n_deduped == 1, st)
        check(st.rows_from_state_cache == 4 * REPLICAS, st)
        check(st.rows_burned == B_MAIN, st)
        for line in log:
            print(f"[serve a] {line}")
        direct = {}
        for who, spec in specs.items():
            if spec not in direct:
                direct[spec] = json.dumps(
                    sweep.run_window_sweep(spec, device=dev).as_dict())
            check(json.dumps(ref[who]["result"]) == direct[spec],
                  f"{who}: daemon response differs from a direct run")
            for rec in ref[who]["result"]["records"]:
                check(0.0 < rec["u"] <= 1.0, rec)
        print(f"[serve a] in-process daemon, 2 intake files one a round: "
              f"{wall_a:.3f} s wall, {st.n_passes} passes ({st.rows_burned}"
              f" rows burned, {st.rows_from_state_cache} from the state "
              f"cache), {b1_launches} B1 launches; every response equals a "
              f"direct run_window_sweep bit for bit")

        # (b) crash after the first pass, restart from the state cache
        d = intake("b")
        out, cache = d.parent / "responses.jsonl", d.parent / "cache.npz"
        mdir, tpath = d.parent / "metrics", d.parent / "trace.json"
        args = ["serve", "--intake", str(d), "--out", str(out),
                "--state-cache", str(cache), "--metrics-dir", str(mdir),
                "--trace", str(tpath), "--max-files-per-round", "1",
                "--poll", "0.05", *device_args]
        t0 = time.perf_counter()
        crash = _run([sys.executable, "-m", "repro_torch.service", *args,
                      "--crash-after-passes", "1"], env, "the crash run",
                     ok=(70,))
        wall_crash = time.perf_counter() - t0
        check("fault injection" in crash.stderr, crash.stderr[-2000:])
        check(sorted(os.listdir(d)) == ["q1.jsonl.done", "q2.jsonl"],
              os.listdir(d))
        check(len(_lines(out)) == 3 and cache.exists() and tpath.exists(),
              "the crash run left no responses, cache or trace")
        stamps_path = work / "stamps.json"
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-c", RESTART, *args, "--idle-exit-rounds", "1"],
            env=dict(env, STAMPS=str(stamps_path), DEVICE=dev), cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            while len(out.read_text().splitlines()) < 4:
                check(proc.poll() is None, "the restart exited before dave")
                check(time.perf_counter() - t0 < SUBPROCESS_S,
                      "the restart never answered dave")
                time.sleep(0.002)
            t_dave = time.perf_counter()
            _, err = proc.communicate(timeout=SUBPROCESS_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        check(proc.returncode == 0, f"the restart exited {proc.returncode}:"
              f"\n{err[-3000:]}")
        check(f"restored {B_MAIN} burned row(s)" in err, err[-2000:])
        check(f"{4 * REPLICAS} rows from state cache" in err, err[-2000:])
        got = _lines(out)
        check(got == ref, "crash and restart (telemetry on) differ from the "
                          "uninterrupted drain (telemetry off)")
        series = _series(mdir)
        check(series["repro_service_rows_burned"]["value"] == 0, series)
        check(series["repro_service_rows_from_state_cache"]["value"]
              == 4 * REPLICAS, series)
        stamps = json.loads(stamps_path.read_text())
        events = json.loads(tpath.read_text())["traceEvents"]
        (dave_pass,) = [e for e in events if e["name"] == "pass"]
        check(dave_pass["args"]["rows_from_cache"] == 4 * REPLICAS
              and dave_pass["args"]["rows_burned"] == 0, dave_pass)
        split = {
            "process start, torch import, CUDA init": stamps["cuda"] - t0,
            "library load": stamps["library"] - stamps["cuda"],
            "cache load": stamps["cache"][1] - stamps["cache"][0],
            "dave's pass": dave_pass["dur"] / 1e6}
        recover = t_dave - t0
        split["the rest"] = recover - sum(split.values())
        print(f"[serve b] crash run (pass 1, then os._exit(70)) "
              f"{wall_crash:.3f} s; restart restored {B_MAIN} rows, dave's "
              f"{4 * REPLICAS} rows all from the state cache, 0 burned "
              f"(metrics snapshot); responses equal (a)'s bit for bit")
        print(f"[serve b] time to recover, process start to dave's response "
              f"on disk: {recover:.3f} s = "
              + ", ".join(f"{k} {v:.3f} s" for k, v in split.items()))

        # (c) the summaries of (b)'s files
        summ = _run([sys.executable, "-m", "repro_torch.obs", "summarize",
                     "--check", str(mdir), str(tpath)], env, "summarize")
        check(summ.stdout.count("check ok") == 2, summ.stdout[-2000:])
        for name in ("repro_pass_u", "repro_pass_w2", "repro_pass_gvt_rate",
                     "repro_pass_window_occupancy"):
            check(series[name]["count"] >= 1, f"{name} never observed")
        print("[serve c] summarize --check: metrics and trace ok; <u>, "
              "<w2>, GVT rate and window occupancy observed")

        # (d) --mesh data=1,model=1: phase 9(c)'s requests through the CLI
        mcommon = dict(common, n_steps=STEPS_SLICE, burn_in=BURN_SLICE,
                       backend="sharded")
        mspecs = {
            "alice": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0),
                                       **mcommon),
            "bob": sweep.WindowSweep(deltas=(4.0, 16.0, math.inf), **mcommon),
            "carol": sweep.WindowSweep(deltas=(1.0, 4.0, 16.0, 64.0),
                                       **mcommon)}
        # alice's and bob's specs at seed 1: a second pass of the same
        # shapes in the same rank, to part a fresh process's first-use cost
        # from the pass itself
        warm = {"erin": dataclasses.replace(mspecs["alice"], seed=1),
                "frank": dataclasses.replace(mspecs["bob"], seed=1)}
        queue = work / "mesh.jsonl"
        _write_queue(queue, wire, {**mspecs, **warm})
        counts = work / "counts"
        counts.mkdir()
        mout, mmet, mtr = (work / "mesh_out.jsonl", work / "mesh_metrics",
                           work / "mesh_trace.json")
        t0 = time.perf_counter()
        _run([sys.executable, "-c", COUNTED, str(queue), "--mesh",
              "data=1,model=1", "--out", str(mout), "--metrics-dir",
              str(mmet), "--trace", str(mtr), *device_args],
             dict(env, COUNTS=str(counts)), "the --mesh drain")
        wall_mesh = time.perf_counter() - t0
        b2_launches = int((counts / "rank0").read_text())
        check(sorted(p.name for p in counts.iterdir()) == ["rank0"],
              "one rank")
        check(b2_launches > 0, "the --mesh drain launched no B2")
        mgot = _lines(mout)
        check(set(mgot) == set(mspecs) | set(warm), sorted(mgot))
        for who in mspecs:
            check(json.dumps(mgot[who]["result"])
                  == sharded["results"][who],
                  f"{who}: --mesh response differs from phase 9(c)'s")
        for who in warm:
            for rec in mgot[who]["result"]["records"]:
                check(0.0 < rec["u"] <= 1.0, rec)
                check(rec["delta"] == "inf"
                      or rec["spread"] <= rec["delta"] + ETA_MAX, rec)
        passes = [e for e in json.loads(mtr.read_text())["traceEvents"]
                  if e["name"] == "pass"]
        check([e["args"]["seed"] for e in passes] == [0, 1], passes)
        cold, hot = (e["dur"] / 1e6 for e in passes)
        _run([sys.executable, "-m", "repro_torch.obs", "summarize",
              "--check", str(mmet), str(mtr)], env, "summarize (mesh)")
        print(f"[serve d] python -m repro_torch.service --mesh "
              f"data=1,model=1: {wall_mesh:.3f} s wall (launcher and one "
              f"rank, imports and process group included); its seed-0 pass "
              f"(phase 9(c)'s requests, the rank's first) {cold:.3f} s, the "
              f"seed-1 pass of the same shapes {hot:.3f} s; phase 9(c)'s "
              f"in-process drain {sharded['wall']:.3f} s; {b2_launches} B2 "
              f"launches; every seed-0 response equals phase 9(c)'s bit for "
              f"bit")
        if not on_cpu:
            n = torch.cuda.device_count()
            big = _run([sys.executable, "-m", "repro_torch.service",
                        str(queue), "--mesh", f"data={n + 1},model=1"], env,
                       "the oversized mesh", ok=(2,))
            check(f"needs {n + 1} GPU(s)" in big.stderr
                  and "does not fall back" in big.stderr, big.stderr)
            print(f"[serve d] --mesh data={n + 1},model=1 on {n} GPU(s): "
                  f"exit 2, {big.stderr.strip().splitlines()[-1]}")

        # (e) telemetry on against off, in turns
        walls, writes = {"off": [], "on": []}, []
        # the snapshot and trace writes (tmp, fsync, rename) timed apart
        write_snapshot, save = daemon.write_snapshot, trace.TraceRecorder.save

        def timed(fn):
            def run(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    writes[-1] += time.perf_counter() - t
            return run

        daemon.write_snapshot = timed(write_snapshot)
        trace.TraceRecorder.save = timed(save)
        try:
            for r in range(SERVE_ROUNDS):
                for mode in (("off", "on") if r % 2 == 0 else ("on", "off")):
                    writes.append(0.0)
                    wall, _, lines, _ = serve(f"e{r}{mode}", mode == "on")
                    check(lines == ref, f"telemetry {mode}: responses differ")
                    walls[mode].append(wall)
        finally:
            daemon.write_snapshot, trace.TraceRecorder.save = \
                write_snapshot, save
        writes = [w for w in writes if w]
        med = {k: sorted(v)[len(v) // 2] for k, v in walls.items()}
        for mode, v in walls.items():
            print(f"[serve e] in-process daemon drain, telemetry {mode}: "
                  f"median {med[mode]:.4f} s of {SERVE_ROUNDS} ("
                  + ", ".join(f"{x:.4f}" for x in v) + ")")
        check(len(writes) == SERVE_ROUNDS, writes)
        print(f"[serve e] telemetry on / off: {med['on'] / med['off']:.4f}; "
              f"of each drain with telemetry on, the 3 metrics snapshots and "
              f"the trace save (tmp, fsync, rename) took median "
              f"{sorted(writes)[len(writes) // 2] * 1e3:.2f} ms ("
              + ", ".join(f"{w * 1e3:.2f}" for w in writes)
              + "); responses bitwise equal in every drain")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return b1_launches, b2_launches


def _lm_requests(serve, vocab, n, prompt, new, seed=0):
    """``n`` requests from ``default_rng(seed)``: prompt length, prompt
    tokens and new tokens drawn in turn for each."""
    import numpy as np
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        length = int(rng.integers(prompt[0], prompt[1] + 1))
        reqs.append(serve.Request(
            uid, rng.integers(0, vocab, length).astype(np.int32),
            int(rng.integers(new[0], new[1] + 1))))
    return reqs


def _timed_calls(torch, model, name, store):
    """Record a CUDA event pair and the host clock around every call of
    ``model.<name>`` (an instance attribute over the method; ``del`` it to
    restore)."""
    fn = getattr(model, name)

    def run(*args, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = fn(*args, **kw)
        end.record()
        store.append((start, end, t0, args))
        return out
    setattr(model, name, run)


def _lm_bounds(cfg, B, S):
    """Least ms of a decode step (the bf16 weights read once) and of a
    prefill of B x S tokens (2 FLOP a parameter a token for the layers, the
    output table for the last token only, causal attention's half of the
    QK and PV products), at the H100's published rates."""
    n = cfg.n_params()
    decode_ms = n * 2 / HBM_BYTES_PER_S * 1e3
    table = cfg.vocab_size * cfg.d_model
    layers = n - table
    attn = 2 * B * S * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
    flops = 2 * layers * B * S + 2 * table * B + attn
    return decode_ms, flops / BF16_FLOPS_PER_S * 1e3


def phase_lm_serve(torch, configs, models, serve, theory, dev):
    """Phase 11(a): the LM serve path at full width on the card."""
    import numpy as np
    cfg = configs.get_config(LM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = models.build_model(cfg, device=dev, seed=0)
    model.compute_params()
    sync(torch, dev)
    init_s = time.perf_counter() - t0
    print(f"[lm] {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, hd {cfg.head_dim}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.n_params():,} "
          f"params ({cfg.param_dtype}, compute {cfg.compute_dtype}); drawn "
          f"and cast on the card in {init_s:.3f} s; memory "
          f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    # warm-up outside the timed drain: the first use of every operator
    warm = model.prefill({"tokens": torch.zeros((LM_LANES, 64),
                                                dtype=torch.long, device=dev)})
    model.decode_step(warm[1], torch.zeros((LM_LANES, 1), dtype=torch.long,
                                           device=dev), 64)
    del warm
    sync(torch, dev)
    eng = serve.ServeEngine(model, batch_lanes=LM_LANES, max_len=LM_MAX_LEN,
                            delta=LM_DELTA, seed=0, device=dev)
    reqs = _lm_requests(serve, cfg.vocab_size, LM_REQUESTS, LM_PROMPT, LM_NEW)
    for r in reqs:
        eng.submit(r)
    prefills, decodes = [], []
    _timed_calls(torch, model, "prefill", prefills)
    _timed_calls(torch, model, "decode_step", decodes)
    try:
        t0 = time.perf_counter()
        results = eng.run()
        sync(torch, dev)
        wall = time.perf_counter() - t0
    finally:
        del model.prefill, model.decode_step
    peak = torch.cuda.max_memory_allocated()
    check(sorted(results) == [r.uid for r in reqs],
          f"results for {sorted(results)}, not all {LM_REQUESTS} requests")
    for r in reqs:
        toks = results[r.uid].tokens
        check(1 <= len(toks) <= r.max_new_tokens,
              f"request {r.uid}: {len(toks)} tokens of {r.max_new_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in toks),
              f"request {r.uid}: a token outside the vocabulary")
    util = eng.lane_utilization
    check(0.0 < util <= 1.0, f"lane utilization {util}")
    n_tokens = sum(len(res.tokens) for res in results.values())
    for start, end, _, args in prefills:
        B, S = args[0]["tokens"].shape
        bound = _lm_bounds(cfg, B, S)[1]
        print(f"[lm] prefill {B} x {S}: {start.elapsed_time(end):.3f} ms "
              f"(CUDA events; bound {bound:.3f} ms)")
    step_ms = np.array([s.elapsed_time(e) for s, e, _, _ in decodes])
    host_ms = np.diff([t for _, _, t, _ in decodes]) * 1e3
    decode_bound, prefill_bound = _lm_bounds(cfg, LM_LANES, LM_PROMPT[1])
    print(f"[lm] decode: {len(step_ms)} steps, {np.median(step_ms):.3f} ms a "
          f"step median (CUDA events; min {step_ms.min():.3f}, p90 "
          f"{np.percentile(step_ms, 90):.3f}, max {step_ms.max():.3f}); host "
          f"clock between step starts median {np.median(host_ms):.3f} ms; "
          f"bound {decode_bound:.4f} ms (bf16 weights read once: "
          f"{cfg.n_params():,} x 2 B / {HBM_BYTES_PER_S / 1e12:.2f} TB/s)")
    dense_ms = 2 * cfg.n_params() * LM_LANES * LM_PROMPT[1] \
        / BF16_FLOPS_PER_S * 1e3
    print(f"[lm] drain: {LM_REQUESTS} requests, {n_tokens} tokens generated "
          f"in {wall:.3f} s wall: {n_tokens / wall:.1f} tokens/s; peak "
          f"memory {peak / 2**30:.3f} GiB (max_memory_allocated); prefill "
          f"bound of {LM_LANES} x {LM_PROMPT[1]} tokens {prefill_bound:.3f} ms"
          f" (2 x params x tokens {dense_ms:.3f} ms less the output table "
          f"for all but the last token, plus causal attention)")
    print(f"[lm] lane utilization {util:.4f} beside u_RD({LM_DELTA:g}) = "
          f"{float(theory.u_rd(LM_DELTA)):.4f}")
    logits, cache = model.prefill({"tokens": torch.randint(
        0, cfg.vocab_size, (LM_LANES, LM_PROMPT[1]), device=dev)})
    tok = torch.argmax(logits, -1)[:, None]

    def steps():
        for i in range(LM_PROFILE_STEPS):
            model.decode_step(cache, tok, LM_PROMPT[1] + i)
    prof = _profile(torch, dev, steps)
    if prof is None:
        print("[lm] torch.profiler gave no device time: idle share not "
              "measured")
    else:
        launches = sum(count for _, _, count in prof["rows"])
        print(f"[lm] profiler, {LM_PROFILE_STEPS} decode steps at B="
              f"{LM_LANES}, cache {LM_PROMPT[1]}: wall "
              f"{prof['wall_us'] / 1e3:.3f} ms, device busy "
              f"{prof['busy_us'] / 1e3:.3f} ms (idle share "
              f"{1 - prof['busy_us'] / prof['wall_us']:.3f}), "
              f"{launches / LM_PROFILE_STEPS:.0f} kernel launches a step")
        for us, key, count in prof["rows"][:8]:
            print(f"[lm] profiler {us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")
    del model, eng, logits, cache
    torch.cuda.empty_cache()
    return n_tokens


def _assert_close(got, want, what):
    err = (got.double().cpu() - want.double().cpu()).abs()
    bad = err > LM_ATOL + LM_RTOL * want.double().cpu().abs()
    check(not bool(bad.any()), f"{what}: {int(bad.sum())} elements beyond "
          f"rtol {LM_RTOL}, atol {LM_ATOL} (max abs err {float(err.max())})")
    return float(err.max())


def phase_lm_checks(torch, configs, models, serve, bridge, dev):
    """Phase 11(b) and (c), in fp32 with TF32 off."""
    import numpy as np
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # (b) decode token by token against prefill, the widths cut in depth
        cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                                  n_layers=LM_CHECK_LAYERS,
                                  compute_dtype="float32")
        model = models.build_model(cfg, device=dev, seed=0)
        gen = torch.Generator(device=dev).manual_seed(1)
        toks = torch.randint(0, cfg.vocab_size, (2, LM_CHECK_TOKENS),
                             generator=gen, device=dev)
        want, _ = model.prefill({"tokens": toks})
        cache = model.cache_spec(2, LM_CHECK_TOKENS)
        for i in range(LM_CHECK_TOKENS):
            got, cache = model.decode_step(cache, toks[:, i:i + 1], i)
        err = (got - want).abs()
        check(bool((err <= LM_DECODE_TOL * (1 + want.abs())).all()),
              f"decode against prefill: max abs err {float(err.max())}")
        print(f"[lm] (b) {LM_ARCH} widths, {LM_CHECK_LAYERS} layers, fp32: "
              f"{LM_CHECK_TOKENS} tokens decoded one by one give prefill's "
              f"logits, max abs err {float(err.max()):.3e} (tolerance "
              f"{LM_DECODE_TOL:g})")
        del model, cache
        torch.cuda.empty_cache()
        # (c) card against CPU on one parameter set
        for arch in LM_CPU_ARCHS:
            cfg = configs.get_config(arch).reduced()
            on_cpu = models.build_model(cfg, device="cpu", seed=0)
            on_card = models.build_model(cfg, device=dev, seed=1)
            bridge.lm_params_from_numpy(on_card,
                                        bridge.lm_params_to_numpy(on_cpu))
            rng = np.random.default_rng(2)
            toks = rng.integers(0, cfg.vocab_size, (2, 64))
            lc, cc = on_cpu.prefill({"tokens": torch.as_tensor(toks)})
            lg, cg = on_card.prefill({"tokens": torch.as_tensor(toks,
                                                                device=dev)})
            worst = 0.0
            for step in range(LM_CPU_STEPS + 1):
                what = f"{arch} " + ("prefill" if step == 0
                                     else f"decode step {step}")
                worst = max(worst, _assert_close(lg, lc, what))
                for k in cc:
                    worst = max(worst, _assert_close(cg[k], cc[k],
                                                     f"{what} cache {k}"))
                if step == LM_CPU_STEPS:
                    break
                tok = torch.argmax(lc, -1)[:, None]
                lc, cc = on_cpu.decode_step(cc, tok, 64 + step)
                lg, cg = on_card.decode_step(cg, tok.to(dev), 64 + step)
            drains = []
            for model, device in ((on_cpu, "cpu"), (on_card, dev)):
                eng = serve.ServeEngine(model, batch_lanes=2, max_len=128,
                                        delta=8.0, seed=0, device=device)
                for r in _lm_requests(serve, cfg.vocab_size, LM_CPU_REQUESTS,
                                      (4, 24), (8, 24), seed=3):
                    eng.submit(r)
                drains.append({u: r.tokens for u, r in eng.run().items()})
            check(drains[0] == drains[1], f"{arch}: the card's served "
                  f"tokens differ from the CPU's: {drains}")
            print(f"[lm] (c) {arch} reduced, fp32: card = CPU in prefill "
                  f"logits, cache and {LM_CPU_STEPS} decode steps (max abs "
                  f"err {worst:.3e}); a {LM_CPU_REQUESTS}-request drain "
                  f"gives the same tokens ({sum(map(len, drains[0].values()))}"
                  f" tokens)")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("CUDA is not available: this smoke runs on a GPU")
    root = pathlib.Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch").is_dir():
        return fail(f"no src/repro_torch beside {__file__}: run it from a "
                    f"checkout of the repository")
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core import distributed as D
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import ensemble, events, horizon, prng
    from repro_torch.core import mesh as mesh_mod
    from repro_torch.experiments import optimal_window as opt
    from repro_torch.experiments import sweep
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import pdes_multistep as pm
    from repro_torch.kernels import pdes_step as ps
    from repro_torch.kernels import threefry as tf
    from repro_torch.obs import trace
    from repro_torch.service import api, daemon, wire
    from repro_torch import bridge
    from repro_torch import configs, models, serve
    from repro_torch.core import theory

    card = card_line()
    print(card)
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    names = ("pdes_multistep_counter", "pdes_step", "pdes_multistep",
             "threefry_bits")
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(_build.build, names))   # one nvcc each, at once
    print(f"[setup] built {', '.join(lib.name for lib in libs)} in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib in libs:
        print(lib.with_suffix(".log").read_text().strip())

    t = {}
    t0 = time.perf_counter()
    phase_decode(torch, horizon, pm, "cuda")
    t["1 decode"] = time.perf_counter() - t0
    kstats = phase_kernel(torch, pm, ref, _build, "cuda")
    t["2 B1"] = time.perf_counter() - t0 - sum(t.values())
    b1_launches = phase_main_path(torch, pm, sweep, api, trace, "cuda",
                                  kstats["ms"])
    t["3 B1 path"] = time.perf_counter() - t0 - sum(t.values())
    sstats = phase_step(torch, ps, ref, ops, events, _build, "cuda")
    t["4 B2"] = time.perf_counter() - t0 - sum(t.values())
    b2_launches = phase_slice(torch, ps, sweep, api, opt, engine_mod,
                              "cuda", sstats["ms"])
    t["5 B2 path"] = time.perf_counter() - t0 - sum(t.values())
    gstats = phase_generator(torch, tf, prng, "cuda")
    t["6 generator"] = time.perf_counter() - t0 - sum(t.values())
    b3stats = phase_bits_kernel(torch, pm, tf, prng, ref, "cuda")
    t["7 B3"] = time.perf_counter() - t0 - sum(t.values())
    b3_launches, gen_launches = phase_threefry_path(
        torch, ops, pm, tf, ref, horizon, prng, ensemble, "cuda")
    t["8 B3 path"] = time.perf_counter() - t0 - sum(t.values())
    b2_sharded, sharded = phase_sharded(torch, ps, engine_mod, D, mesh_mod,
                                        sweep, api, "cuda")
    t["9 sharded"] = time.perf_counter() - t0 - sum(t.values())
    b1_serve, b2_serve = phase_service(torch, pm, ps, sweep, wire, daemon, api,
                                       trace, "cuda", root, sharded)
    t["10 serve"] = time.perf_counter() - t0 - sum(t.values())
    phase_lm_serve(torch, configs, models, serve, theory, "cuda")
    phase_lm_checks(torch, configs, models, serve, bridge, "cuda")
    t["11 LM serve"] = time.perf_counter() - t0 - sum(t.values())
    print("[setup] phase wall: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in t.items()))

    kernels = [
        dict(name="pdes_multistep_counter", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_multistep_counter.cu",
             replaces="src/repro/kernels/pdes_multistep.py:169",
             launches=b1_launches + b1_serve, library_ms=None, **kstats),
        dict(name="pdes_step", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_step.cu",
             replaces="src/repro/kernels/pdes_step.py:69",
             launches=b2_launches + b2_sharded + b2_serve, library_ms=None,
             **sstats),
        dict(name="pdes_multistep", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_multistep.cu",
             replaces="src/repro/kernels/pdes_multistep.py:129",
             launches=b3_launches, library_ms=None, **b3stats),
        dict(name="threefry_bits", route="cuda",
             source="src/repro_torch/kernels/csrc/threefry_bits.cu",
             replaces="jax.random.bits (XLA, outside Pallas)",
             launches=gen_launches, library_ms=None, **gstats)]
    print(f"[launches] B1: phase 3 {b1_launches}, phase 10(a) {b1_serve}; "
          f"B2: phase 5 {b2_launches}, phase 9(c) {b2_sharded}, phase 10(d) "
          f"{b2_serve}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
