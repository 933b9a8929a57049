"""The whole drain's share of the card's peak, in percent: the least
seconds the card takes for the algorithm's instructions in the traced
window (``roofline.algorithm_s``: the same count whatever kernels do the
work, at the integer pipes' and the issue rate) over the window's seconds.
A kernel taken off the path leaves its roofline silent; this still bounds
the whole."""
from bench import roofline


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0 or not rec.get("card"):
        return None
    return 100 * roofline.algorithm_s(rec) / rec["window_s"]
