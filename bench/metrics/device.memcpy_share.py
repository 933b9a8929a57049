"""The share of the traced window the card spends copying between host and
device, in percent (``Memcpy HtoD`` and ``DtoH`` device time, from the
profiler): the burned-state cache's round trip and the stats' way home."""
from bench import roofline


def read(rec):
    if rec["busy_s"] <= 0 or rec["window_s"] <= 0:
        return None
    t = roofline.device_seconds(rec, lambda k: "HtoD" in k or "DtoH" in k)
    return 100 * t / rec["window_s"]
