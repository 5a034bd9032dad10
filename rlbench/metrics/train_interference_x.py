"""The median decode step that overlaps a train step over the median one
that does not, in the window (engine step calls against the trainer's
intervals, host clock)."""
import numpy as np

from rlbench.harness import measure as m


def read(st):
    trains = sorted(m.train_intervals(st))
    if not trains:
        return None
    t0 = np.array([a for a, _ in trains])
    t1 = np.array([b for _, b in trains])
    ins, outs = [], []
    for a, b in st.probes.steps:
        if not m.inside(st, b):
            continue
        k = np.searchsorted(t0, b, side="right") - 1
        hit = k >= 0 and t1[max(k, 0)] >= a
        (ins if hit else outs).append(b - a)
    if not ins or not outs:
        return None
    return float(np.median(ins) / np.median(outs))
