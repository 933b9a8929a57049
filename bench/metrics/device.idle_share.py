"""The card's idle share of the traced window, in percent: one minus the
union of its activity (kernels, copies, sets), from the profiler."""


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    return 100 * (1 - rec["busy_s"] / rec["window_s"])
