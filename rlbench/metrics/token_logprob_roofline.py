"""``token_logprob``'s forward: its bound time (yardstick.py, at the shapes
of each call in the window) over its measured device time (the kernels
launched inside the harness's range around the entry point, profiler
trace), in %. The backward runs on autograd's device thread, where the
kernels cannot be matched to the range (``driver.KernelProbes``)."""
from rlbench.harness import measure as m


def read(st):
    return m.roofline(st, "token_logprob")
