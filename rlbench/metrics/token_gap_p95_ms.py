"""The 95th percentile of the time between consecutive sampled tokens of a
resident row, over every token decoded in the window, each decode step's
gap counted once for every row it advanced (host clock at the end of each
engine step; a row's gaps count from its first step in a slot on)."""
from rlbench.harness import measure as m


def read(st):
    p = m.percentile(m.token_gaps(st), 95)
    return None if p is None else 1000.0 * p
