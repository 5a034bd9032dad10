"""The wall time of the window's train steps (each GRPO update from the
trainer's pop to its commit) over their number, in ms."""
from rlbench.harness import measure as m


def read(st):
    cs = m.window_commits(st)
    return None if not cs else 1000.0 * sum(c.t1 - c.t0 for c in cs) / len(cs)
