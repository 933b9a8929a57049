"""B1's stream tier's share of its roofline (``csrc/pdes_multistep_counter.cu``,
``multistep_counter_stream_kernel``: rings past the shared memory of the
card's blocks), in percent: ``roofline.b1_bound_s`` over that kernel's
device time in the traced window.  The bound is the work's, whatever tier
does it: the algorithm's typed instructions, or the rings read and
written once a K-step launch, so the bytes the tier moves through device
memory each step count against it.  None where the kernel did not run."""
import re

from bench import roofline

KERNEL = re.compile(r"multistep_counter_stream_kernel")


def read(rec):
    t = roofline.device_seconds(rec, KERNEL.search)
    if t <= 0 or not rec.get("card"):
        return None
    return 100 * roofline.b1_bound_s(rec) / t
