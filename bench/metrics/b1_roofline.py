"""B1's share of its roofline (``csrc/pdes_multistep_counter.cu``, every
tier), in percent: ``roofline.b1_bound_s`` over B1's device time in the
traced window.  Every engine row-step of an exact cell runs in B1."""
import re

from bench import roofline

KERNEL = re.compile(r"multistep_counter(_cluster|_grid)?_kernel")


def read(rec):
    t = roofline.device_seconds(rec, KERNEL.search)
    if t <= 0 or not rec.get("card"):
        return None
    return 100 * roofline.b1_bound_s(rec) / t
