#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` with
``nvcc`` and drives the port's paths on the card:

0. setup: the card's name and power limit, versions, both kernels' builds
   (one ``nvcc`` per source, started together);
1. decode: B1's η decode against the plain rule on the card over all
   ``2**24`` inputs (bitwise), and the count that differ from numpy's fp64
   ``log`` on the host;
2. B1 against its plain version: ``pdes_multistep_counter`` at the main
   path's shape (L = 10,000 PEs, B = 448 rings, K = 16 and a K = 5
   remainder chunk), τ/ucount/min/max bitwise, the sums to a stated
   tolerance; then both timed with CUDA events;
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
6. the last lines: one JSON object per kernel (times, bound, launches),
   then ``{"ok": true, "device": {...}}``.

Every phase asserts; any failure exits non-zero with no result line.
Without CUDA, or outside a checkout of the repository, it exits 1.
"""
from __future__ import annotations

import concurrent.futures
import json
import math
import pathlib
import subprocess
import sys
import time

#: Ring length and volume load of the main path (10x the L = 1000 of the
#: paper-figure benchmarks).
L_MAIN = 10_000
N_V_MAIN = 10
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
    """Kernel decode == plain rule on the card; count against the host."""
    import numpy as np
    w1 = torch.arange(1 << 24, device=dev, dtype=torch.int64) << 8
    kern = pm.decode_eta_cuda(w1)
    plain = horizon.decode_eta(w1)
    n_bad = int((kern.view(torch.int32) != plain.view(torch.int32)).sum())
    check(n_bad == 0, f"kernel decode differs from the plain rule on "
                      f"{n_bad} of 2**24 inputs")
    kh = np.arange(1 << 24, dtype=np.uint32)
    x = kh.astype(np.float32) * np.float32(2.0**-24) + np.float32(2.0**-25)
    host = (-np.log(x.astype(np.float64))).astype(np.float32)
    got = kern.cpu().numpy()
    diff = np.flatnonzero(got.view(np.int32) != host.view(np.int32))
    print(f"[decode] kernel == plain rule on the card on all 2**24 inputs; "
          f"differs from numpy fp64 log on the host on {diff.size} inputs"
          + (f" (first k: {diff[:8].tolist()})" if diff.size else ""))
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


def phase_kernel(torch, pm, ref, dev, timer=cuda_ms):
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


def _profile_steps(torch, engine_cls, cfg, dev, deltas, trials):
    """Device time by kernel over one 16-step chunk of the stale `pallas`
    path, from torch.profiler; None where the profiler gives no device
    time (the profiler is untried on this machine)."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine_cls(cfg, backend="pallas", window="stale", k_fuse=K_MAIN,
                     device=dev)
    st = eng.init(B_MAIN)
    eng.run(st, 0, K_MAIN, deltas=deltas, trial_base=trials)
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run(st, 0, K_MAIN, deltas=deltas, trial_base=trials)
        sync(torch, dev)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue                  # host ops: their kernels are listed
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0.0))
        if us > 0:
            rows.append((us, ev.key, ev.count))
    if not rows:
        return None
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    return dict(wall_us=wall_us, busy_us=busy, rows=rows)


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
    from repro_torch.core import engine as engine_mod
    from repro_torch.core import events, horizon
    from repro_torch.experiments import optimal_window as opt
    from repro_torch.experiments import sweep
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import pdes_multistep as pm
    from repro_torch.kernels import pdes_step as ps
    from repro_torch.obs import trace
    from repro_torch.service import api

    card = card_line()
    print(card)
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    names = ("pdes_multistep_counter", "pdes_step")
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
    kstats = phase_kernel(torch, pm, ref, "cuda")
    t["2 B1"] = time.perf_counter() - t0 - sum(t.values())
    b1_launches = phase_main_path(torch, pm, sweep, api, trace, "cuda",
                                  kstats["ms"])
    t["3 B1 path"] = time.perf_counter() - t0 - sum(t.values())
    sstats = phase_step(torch, ps, ref, ops, events, _build, "cuda")
    t["4 B2"] = time.perf_counter() - t0 - sum(t.values())
    b2_launches = phase_slice(torch, ps, sweep, api, opt, engine_mod,
                              "cuda", sstats["ms"])
    t["5 B2 path"] = time.perf_counter() - t0 - sum(t.values())
    print("[setup] phase wall: "
          + ", ".join(f"{k} {v:.2f} s" for k, v in t.items()))

    kernels = [
        dict(name="pdes_multistep_counter", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_multistep_counter.cu",
             replaces="src/repro/kernels/pdes_multistep.py:169",
             launches=b1_launches, library_ms=None, **kstats),
        dict(name="pdes_step", route="cuda",
             source="src/repro_torch/kernels/csrc/pdes_step.cu",
             replaces="src/repro/kernels/pdes_step.py:69",
             launches=b2_launches, library_ms=None, **sstats)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
