"""Device ms inside the sampler (``_sample_rows``, where the engine looks it
up) per decode step, from the profiler's trace of the window."""
from rlbench.harness import measure as m


def read(st):
    t = m.range_s(st, "sample_rows")
    n = m.delta(st, "decode_steps")
    return None if t is None or n <= 0 else 1000.0 * t / n
