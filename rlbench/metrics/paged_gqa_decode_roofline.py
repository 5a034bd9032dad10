"""``paged_gqa_decode``'s bound time (yardstick.py, at the shapes of each call in the
window) over its measured device time (the kernels launched inside the
harness's range around the entry point, profiler trace), in %."""
from rlbench.harness import measure as m


def read(st):
    return m.roofline(st, "paged_gqa_decode")
