"""Bytes of tau that B1's stream tier reads and writes in device memory a
PE-step: the ``b1_offchip_bytes`` of the service's ``pass`` spans whose
``b1_tier`` is ``stream`` (counted from the plan at each launch: every
block's device rows read and written once a step), summed, over the
PE-steps B1 ran in those passes (the burned rows' burn-in and every row's
measured steps, times L).  A counter of the program, so the plan alone
sets it.  None where no pass ran on the stream tier, or from a program
without the counters."""
from bench import roofline


def read(rec):
    spans = [e["args"] for e in rec["spans"]
             if e.get("args", {}).get("b1_tier") == "stream"
             and "b1_offchip_bytes" in e["args"]]
    pe_steps = sum(a["L"] * roofline.span_row_steps(a) for a in spans)
    if pe_steps <= 0:
        return None
    return sum(a["b1_offchip_bytes"] for a in spans) / pe_steps
