"""The window's decode-loop time over its decode steps (the engine's
``decode_steps`` counter), in ms."""
from rlbench.harness import measure as m


def read(st):
    n = m.delta(st, "decode_steps")
    return None if n <= 0 else 1000.0 * m.window_s(st) / n
