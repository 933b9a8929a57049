#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from ``src/repro_torch/kernels/csrc`` with
``nvcc`` and drives the port's main path on the card:

0. setup: the card's name and power limit, versions, the kernel's build;
1. decode: the kernel's η decode against the plain rule on the card over
   all ``2**24`` inputs (bitwise), and the count that differ from numpy's
   fp64 ``log`` on the host;
2. kernel against plain version: ``pdes_multistep_counter`` at the main
   path's shape (L = 10,000 PEs, B = 448 rings, K = 16 and a K = 5
   remainder chunk), τ/ucount/min/max bitwise, the sums to a stated
   tolerance; then both timed with CUDA events;
3. main path: an in-process ``SweepService`` drain of three requests at
   L = 10,000, N_V = 10 on the ``pallas_multistep`` backend, every
   response bit-identical to a direct ``run_window_sweep``, physics bounds
   asserted, the kernel's launch count read;
4. the last lines: one JSON object per kernel (times, bound, launches),
   then ``{"ok": true, "device": {...}}``.

Every phase asserts; any failure exits non-zero with no result line.
Without CUDA, or outside a checkout of the repository, it exits 1.
"""
from __future__ import annotations

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
B_MAIN = 448
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
    trials[-64:] = -1 - np.arange(64)          # the service's pad indices
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
    common = dict(Ls=(L_MAIN,), n_vs=(N_V_MAIN,), replicas=64,
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
    from repro_torch.core import horizon
    from repro_torch.experiments import sweep
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import pdes_multistep as pm
    from repro_torch.obs import trace
    from repro_torch.service import api

    card = card_line()
    print(card)
    print(f"[setup] python {sys.version.split()[0]}, torch {torch.__version__},"
          f" CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _build.build("pdes_multistep_counter")
    print(f"[setup] built {lib.name} in {time.perf_counter() - t0:.2f} s")
    print(lib.with_suffix(".log").read_text().strip())

    phase_decode(torch, horizon, pm, "cuda")
    kstats = phase_kernel(torch, pm, ref, "cuda")
    launches = phase_main_path(torch, pm, sweep, api, trace, "cuda",
                               kstats["ms"])

    kernels = [dict(
        name="pdes_multistep_counter", route="cuda",
        source="src/repro_torch/kernels/csrc/pdes_multistep_counter.cu",
        replaces="src/repro/kernels/pdes_multistep.py:169",
        launches=launches, library_ms=None, **kstats)]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
