"""B2's share of its roofline (``csrc/pdes_step.cu``), in percent:
``roofline.b2_bound_s`` over B2's device time in the traced window.  Every
engine row-step of a stale cell is one B2 step."""
from bench import roofline


def read(rec):
    t = roofline.device_seconds(rec, lambda k: "pdes_step_kernel" in k)
    if t <= 0 or not rec.get("card"):
        return None
    return 100 * roofline.b2_bound_s(rec) / t
