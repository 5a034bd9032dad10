"""Completion tokens in rows whose GRPO update committed, per second, over
all tenants: from the window's first commit to its last, the tokens of
every commit after the first over the time between the two (host clock)."""
from rlbench.harness import measure as m


def read(st):
    cs = m.window_commits(st)
    if len(cs) < 2 or cs[-1].t1 <= cs[0].t1:
        return None
    return sum(c.tokens for c in cs[1:]) / (cs[-1].t1 - cs[0].t1)
