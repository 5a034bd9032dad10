"""Completion tokens the engine sampled in the window, over the window (the
engine's ``sampled_tokens`` counter)."""
from rlbench.harness import measure as m


def read(st):
    return m.delta(st, "sampled_tokens") / m.window_s(st)
