"""Share of the card's SMs that B1's launches on a split ring hold, in
percent: the ``b1_block_chunks`` of the service's ``pass`` spans (K steps
times rings times blocks a ring, at each launch) summed, over their
``b1_sm_chunks`` (K steps times the waves of the rings the card holds at
once times its SMs).  A count of the program, from the plan and the
card's occupancy, so the batches alone set it.  None where no pass ran
on a split tier (cluster, grid or stream), or from a program without the
counters."""


def read(rec):
    spans = [e["args"] for e in rec["spans"]
             if "b1_sm_chunks" in e.get("args", {})]
    sm = sum(a["b1_sm_chunks"] for a in spans)
    if sm <= 0:
        return None
    return 100 * sum(a["b1_block_chunks"] for a in spans) / sm
