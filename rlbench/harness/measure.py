"""Shared arithmetic of the metric readers (``metrics/<name>.py``): what
fell inside the window, percentiles, the window's FLOPs."""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from . import yardstick as ys


def window_s(st) -> float:
    return st.t_close - st.t_open


def inside(st, t: float) -> bool:
    return st.t_open <= t <= st.t_close


def delta(st, counter: str) -> int:
    return st.counters_close[counter] - st.counters_open[counter]


def window_commits(st):
    return sorted((c for c in st.probes.commits if inside(st, c.t1)),
                  key=lambda c: c.t1)


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    if not len(values):
        return None
    return float(np.percentile(np.asarray(values, np.float64), q))


def token_gaps(st) -> np.ndarray:
    t = np.asarray(st.probes.gap_t, np.float64)
    g = np.asarray(st.probes.gap_s, np.float64)
    return g[(t >= st.t_open) & (t <= st.t_close)]


def train_intervals(st) -> List[tuple]:
    return [(c.t0, c.t1) for c in st.probes.commits]


def decode_flops(st) -> float:
    s = st.cell.shape
    return sum(ys.decode_flops(s, rows, keys)
               for t, rows, keys, _ in st.probes.decodes if inside(st, t))


def prefill_flops(st) -> float:
    """The prompts admitted in the window, less the tokens the prefix cache
    served: the hits are spread over the rows in proportion to their
    prompts, and each row's new tokens sit after its hits."""
    s = st.cell.shape
    lens = [p for t, p in st.probes.admitted if inside(st, t)]
    if not lens:
        return 0.0
    hits = delta(st, "prefix_hit_tokens")
    share = min(1.0, hits / float(sum(lens)))
    return sum(ys.seq_flops(s, int(round(p * share)), p) for p in lens)


def train_flops(st) -> float:
    s = st.cell.shape
    return sum(ys.train_flops(s, c.lengths) for c in window_commits(st))


def range_s(st, name: str) -> Optional[float]:
    dt = st.device_trace
    if not dt:
        return None
    v = dt.get("range_s", {}).get(name)
    return v if v else None


def roofline(st, kernel: str) -> Optional[float]:
    """100 x the kernel's bound time over its measured device time."""
    t = range_s(st, kernel)
    if t is None or st.kprobes is None or not st.kprobes.bound.get(kernel):
        return None
    return 100.0 * st.kprobes.bound[kernel] / t
