"""The yardstick of the per-layer metrics: the card's peaks and the
operations and bytes of the kernels' work.

Peaks are read in the traced run itself (:func:`card`).  The instruction
rates come from the card's own SM count and SM clock times the per-SM
rates of compute capability 9.0 (the CUDA C++ Programming Guide's table of
arithmetic instruction throughput): four warp instructions a clock (128
threads' instructions) issue on an SM; the fp32 pipes take 128 of them a
clock (an add, a multiply or a fused multiply-add each counts one), the
32-bit integer pipes 64 (add, logic, shift, compare, multiply).  The
bandwidth is measured: the best of five device-to-device copies of 1 GiB,
twenty times the card's 50 MB L2, read once and written once.

Counts: the kernels' source notes (``csrc/pdes_multistep_counter.cu``,
``csrc/pdes_step.cu``), as ``chip_smoke.py`` counts them, typed where the
note types them.
"""
import math

#: Per SM and clock, compute capability 9.0: instructions issued, and
#: 32-bit integer instructions (the fp32 pipes match the issue rate).
ISSUE_PER_SM_CLOCK = 128
INT32_PER_SM_CLOCK = 64
#: The H100 SXM's highest SM clock, where the card reports none.
SHEET_CLOCK_HZ = 1.98e9
#: B1 (and the algorithm, whatever kernels run it): per PE-step 23 integer
#: (the PE hash, word 0, the site pick) and 11 fp32 (rules, moments); per
#: PE that updates 10 integer (word 1) and 5 fp32 (the decode, the add,
#: the log counted as one).
INT_PER_PE_STEP, FP_PER_PE_STEP = 23, 11
INT_PER_UPDATE, FP_PER_UPDATE = 10, 5
#: B2: per PE 14 (site pick, border compares, rules, moments); per PE that
#: updates 6 more (decode, log, add).  The note does not type them, so
#: they are held to the issue rate alone.  Its words come from memory.
STEP_OPS_PER_PE = 14
STEP_OPS_PER_UPDATE = 6


def card(device) -> dict:
    """The traced run's card: its SM count and SM clock as it reports
    them, and its copy bandwidth as measured now."""
    import torch

    props = torch.cuda.get_device_properties(device)
    khz = getattr(props, "clock_rate", 0)       # cudaDeviceProp, in kHz
    n = 1 << 28                                  # 1 GiB of float32
    src = torch.ones(n, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    best = math.inf
    for _ in range(5):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        dst.copy_(src)
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) * 1e-3)
    del src, dst
    torch.cuda.empty_cache()
    return {"sms": props.multi_processor_count,
            "clock_hz": khz * 1e3 if khz else SHEET_CLOCK_HZ,
            "clock_from": "card" if khz else "sheet",
            "hbm_bytes_per_s": 2 * 4 * n / best}


def ops_seconds(card: dict, n_int: float, n_fp: float) -> float:
    """Least seconds for ``n_int`` 32-bit integer and ``n_fp`` fp32
    instructions: the integer pipes' rate, or the issue rate of all."""
    per_clock = card["sms"] * card["clock_hz"]
    return max(n_int / (INT32_PER_SM_CLOCK * per_clock),
               (n_int + n_fp) / (ISSUE_PER_SM_CLOCK * per_clock))


def utilization(responses) -> float:
    """Mean u of the responses' records, weighted by the PE-steps asked
    (a record's rows times its steps and its own ring length).

    It stands for the share of PE-steps that update; the burn-in's share
    is higher than the steady state's, so work counted with it errs low.
    """
    num = den = 0.0
    for e in responses:
        if e["records"] is None:
            continue
        q = e["request"]
        w = q["replicas"] * (q["burn_in"] + q["n_steps"])
        for r in e["records"]:
            num += r["u"] * w * r["L"]
            den += w * r["L"]
    return num / den if den else 0.0


def span_row_steps(args: dict) -> int:
    """Row-steps of one ``pass`` span: its rows (pads included) times its
    steps, and the rows it burned times the burn-in: the pass's share of
    the service's ``engine_row_steps``.  (The service pads rows only on
    the sharded backend, which no cell runs; the pads of its burn
    sub-pass are not in the span's args.)"""
    return ((args["n_rows"] + args["n_pad"]) * args["n_steps"]
            + args["rows_burned"] * args["burn"])


def row_steps(rec) -> dict:
    """The engine's row-steps in the traced window by ring length: each
    ``pass`` span's (:func:`span_row_steps`) under its own ``L``."""
    out: dict = {}
    for e in rec["spans"]:
        a = e["args"]
        out[a["L"]] = out.get(a["L"], 0) + span_row_steps(a)
    return out


def pe_steps(rec) -> int:
    """PE-steps the engine ran in the traced window."""
    return sum(L * n for L, n in row_steps(rec).items())


def algorithm_ops(rec) -> tuple:
    """The algorithm's (integer, fp32) instructions in the traced window."""
    n, u = pe_steps(rec), utilization(rec["responses"])
    return (n * (INT_PER_PE_STEP + INT_PER_UPDATE * u),
            n * (FP_PER_PE_STEP + FP_PER_UPDATE * u))


def algorithm_s(rec) -> float:
    """Least seconds the card takes for the algorithm's instructions."""
    return ops_seconds(rec["card"], *algorithm_ops(rec))


def b1_bound_s(rec) -> float:
    """Least seconds for B1's work: its instructions, or the rings read and
    written once a K-step launch and six moment floats a row-step."""
    n_bytes = (8 * pe_steps(rec) / rec["config"]["k_fuse"]
               + 4 * 6 * sum(row_steps(rec).values()))
    return max(algorithm_s(rec), n_bytes / rec["card"]["hbm_bytes_per_s"])


def b2_bound_s(rec) -> float:
    """Least seconds for B2's work: its instructions at the issue rate, or
    a row-step's bytes: the haloed ring read (4 (L + 2)), the words
    (8 L), the ring written (4 L), the window base and six moments
    (4 + 24)."""
    ops = pe_steps(rec) * (STEP_OPS_PER_PE + STEP_OPS_PER_UPDATE
                           * utilization(rec["responses"]))
    n_bytes = sum(n * (16 * L + 36) for L, n in row_steps(rec).items())
    return max(ops_seconds(rec["card"], 0, ops),
               n_bytes / rec["card"]["hbm_bytes_per_s"])


def device_seconds(rec, match) -> float:
    """Device seconds of the operations whose names ``match``."""
    return sum(v for k, v in rec["device_ops"].items() if match(k))
