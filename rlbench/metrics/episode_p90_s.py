"""The 90th percentile, over the rows whose update committed in the window,
of the time from the row's submission to its commit (the runtime tracer's
``submitted`` and ``committed`` marks)."""
from rlbench.harness import measure as m


def read(st):
    out = []
    for seq in st.marks.values():
        sub = [t for t, s in seq if s == "submitted"]
        com = [t for t, s in seq if s == "committed"]
        if sub and com and m.inside(st, com[0]):
            out.append(com[0] - sub[0])
    return m.percentile(out, 90)
