"""Reduction of a ``torch.profiler`` trace of the window to what the metric
readers need: the card's busy time (the union of its kernels, copies and
sets), each harness range's device time, the kernels by total time, and
the idle gaps by what the host was doing.

A kernel belongs to a range when the host operation that launched it (the
profiler links each device activity to it) started, on that operation's
thread, inside a range of that name. A kernel launched outside any aten
operation (the hand-written kernels' ctypes launchers) has no operation
linked to it: it belongs to a range when it ran inside the device-side span
the profiler draws for that range (from the first to the last kernel the
range launched). The ranges are the ``rlbench::<name>``
``record_function`` spans the harness opens (``driver.py``); ranges of one
name never overlap on one thread. Only kernels and ranges are compared, no
kernel names: a range reads the same work whatever kernel carries it out.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List

import numpy as np

PREFIX = "rlbench::"
RUNTIME = ("cuda", "cu")        # the CUDA runtime's and driver's API calls
HOST_LABELS = ("decode_step", "train_step", "radix_fill_rows",
               "refill_free_slots")


def _short(name: str) -> str:
    n = name[5:] if name.startswith("void ") else name
    for sep in ("<", "("):
        i = n.find(sep)
        if i > 0:
            n = n[:i]
    return n


def _is_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


def reduce_events(events, window_s: float) -> Dict[str, Any]:
    """`events`: the profiler's kineto events (``name()``, ``device_type()``,
    ``start_ns()``, ``duration_ns()``, ``correlation_id()``,
    ``linked_correlation_id()``, ``start_thread_id()``,
    ``is_user_annotation()``). A device event's ``linked_correlation_id``
    names the host operation that launched it, its ``correlation_id`` the
    CUDA API call."""
    ranges: Dict[str, Dict[int, List]] = defaultdict(lambda: defaultdict(list))
    dev_ranges: Dict[str, List] = defaultdict(list)
    owner: Dict[int, tuple] = {}
    dev = []
    for e in events:
        name = e.name()
        if _is_device(e):
            if e.is_user_annotation() or name.startswith(PREFIX):
                if name.startswith(PREFIX):
                    s = e.start_ns()
                    dev_ranges[name[len(PREFIX):]].append((s, s + e.duration_ns()))
                continue
            dev.append((e.start_ns(), e.duration_ns(), name,
                        e.linked_correlation_id()))
            continue
        if name.startswith(RUNTIME):
            continue
        th = e.start_thread_id()
        owner[e.correlation_id()] = (e.start_ns(), th)
        if name.startswith(PREFIX):
            s = e.start_ns()
            ranges[name[len(PREFIX):]][th].append((s, s + e.duration_ns()))
    out: Dict[str, Any] = {"window_s": window_s, "kernels": len(dev)}
    if not dev:
        out.update(busy_s=0.0, range_s={}, device_ops=[], idle_gaps=[])
        return out
    start = np.array([d[0] for d in dev], np.int64)
    dur = np.array([d[1] for d in dev], np.int64)
    # busy: the union of the device intervals
    order = np.argsort(start)
    s, e = start[order], start[order] + dur[order]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    seg_s = s[new]
    idx = np.nonzero(new)[0]
    seg_e = np.append(run_end[idx[1:] - 1], run_end[-1])
    busy = float((seg_e - seg_s).sum()) / 1e9
    out["busy_s"] = busy
    # each range's device time
    # a link of 0 names no operation (the ctypes launches)
    own = [owner.get(d[3], (-1, -1)) if d[3] else (-1, -1) for d in dev]
    own_t = np.array([o[0] for o in own], np.int64)
    own_th = np.array([o[1] for o in own], np.int64)
    linked = own_th >= 0
    end_t = start + dur
    range_s = {}
    anywhere = linked.copy()
    for name in set(ranges) | set(dev_ranges):
        inside = np.zeros(len(dev), bool)
        for th, spans in ranges.get(name, {}).items():
            sp = np.array(sorted(spans), np.int64)
            sel = np.nonzero(linked & (own_th == th))[0]
            t = own_t[sel]
            k = np.searchsorted(sp[:, 0], t, side="right") - 1
            ok = (k >= 0) & (t <= sp[np.clip(k, 0, None), 1])
            inside[sel[ok]] = True
        if dev_ranges.get(name):
            sp = np.array(sorted(dev_ranges[name]), np.int64)
            sel = np.nonzero(~linked)[0]
            k = np.searchsorted(sp[:, 0], start[sel], side="right") - 1
            kk = np.clip(k, 0, None)
            ok = (k >= 0) & (end_t[sel] <= sp[kk, 1])
            inside[sel[ok]] = True
            anywhere[sel[ok]] = True
        range_s[name] = float(dur[inside].sum()) / 1e9
    out["range_s"] = range_s
    out["attributed"] = int(anywhere.sum())
    out["linked"] = int(linked.sum())
    by_name: Dict[str, float] = defaultdict(float)
    for d in dev:
        by_name[_short(d[2])] += d[1] / 1e9
    out["device_ops"] = sorted(([k, v] for k, v in by_name.items()),
                               key=lambda kv: -kv[1])[:10]
    # idle gaps between the device's busy segments, by the host's ranges
    g0, g1 = seg_e[:-1], seg_s[1:]
    mid = (g0 + g1) // 2
    labels = np.full(len(mid), "", dtype=object)
    for name in HOST_LABELS:
        hit = np.zeros(len(mid), bool)
        for spans in ranges.get(name, {}).values():
            sp = np.array(sorted(spans), np.int64)
            k = np.searchsorted(sp[:, 0], mid, side="right") - 1
            hit |= (k >= 0) & (mid <= sp[np.clip(k, 0, None), 1])
        labels[hit] = [f"{x}+{name}" if x else name for x in labels[hit]]
    gaps: Dict[str, float] = defaultdict(float)
    for lab, g in zip(labels, (g1 - g0) / 1e9):
        gaps[lab or "none"] += float(g)
    out["idle_gaps"] = sorted(([k, v] for k, v in gaps.items()),
                              key=lambda kv: -kv[1])[:10]
    return out


def reduce_profile(prof, t_open: float, t_close: float) -> Dict[str, Any]:
    return reduce_events(prof.profiler.kineto_results.events(),
                         t_close - t_open)
