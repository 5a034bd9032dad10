"""Thread-safe, low-overhead span tracer for end-to-end episode tracing
(a copy of ``repro.obs.tracer``, plain Python).

One ``Tracer`` instance is shared by every stage of a run — engine decode
thread, prefill workers, env workers (via the engine pump), the trainer
and the manager — and by the virtual-time simulator (inject its SimClock).
It records three kinds of events into bounded ring buffers under one
lock:

  * lifecycle **marks** — ``mark(trace, state, t)``: a single timestamped
    state transition of one episode.  Per episode the marks are
    CONTIGUOUS: the interval between consecutive marks is attributed to
    the state entered at the first of the pair, so the per-stage
    components partition submission→commit exactly and sum to the
    end-to-end latency by construction (the ±1% acceptance criterion is
    a tautology of this representation, not a measurement accident).
  * **spans** — ``span(track, name, t0, t1, ...)``: a duration on a
    (process, thread) track — one track per pool / worker / slot —
    optionally carrying incoming/outgoing flow ids that become Perfetto
    flow arrows across stage hand-offs (park→env→resume, preempt→
    reinstall).
  * **instants** — point events (e.g. a staleness drop on the manager
    track).

Design constraints (the engine hot loop calls these):

  * every hook site guards with ``if tracer is not None`` — a run
    without tracing pays one pointer compare per *episode event* (not
    per token) and allocates nothing;
  * events are stored as plain tuples appended to ``deque(maxlen=...)``
    ring buffers — no objects, no dict per event; when a buffer wraps,
    the oldest events drop and ``dropped_events`` counts them;
  * timestamps come from an injectable ``clock`` (``time.monotonic`` by
    default, the simulator's virtual clock under simulation) and callers
    on hot paths pass timestamps they already read for stats bookkeeping
    — tracing adds no extra clock calls there;
  * nothing here touches the device: a traced run launches exactly what
    an untraced run launches, and no hook synchronises a stream.

The lock is named ``_trace_lock`` (the JAX package's is ``_lock``): the
repo's lock-order analyzer names a lock by class and attribute, and two
``Tracer`` classes with the same lock attribute would shadow each other.

The canonical lifecycle states, in the order a maximally-eventful
episode visits them (loops allowed where marked):

    submitted -> queued -> [prefill -> ready?] -> (restore|decode)
        -> { parked -> env -> resume_queued -> ... back to prefill/restore
           | preempted -> ... back to prefill/restore }*
        -> completed -> train -> committed | dropped

``export_chrome()`` renders everything as Chrome trace-event JSON
(Perfetto-loadable): real tracks for pools/workers/slots, a synthesized
``episodes`` process with one thread per trace showing the per-stage
component slices, and ``s``/``f`` flow events binding hand-offs across
threads.
"""
from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

# component label charged to the interval that STARTS at each state --
# the partition of an episode's submission->commit latency. Terminal
# states (committed / dropped) start no interval.
COMPONENT_OF = {
    "submitted": "admission_wait",     # built by the runtime, not yet queued
    "queued": "queue_wait",            # in the scheduler queue
    "prefill": "prefill",              # prompt/prefix (re)computation
    "ready": "splice_wait",            # prefilled, waiting for a free slot
    "restore": "restore",              # snapshot/device-page splice-back
    "decode": "decode",                # resident in a decode slot
    "parked": "env_queue_wait",        # parked, waiting for an env worker
    "env": "env",                      # tool call executing
    "resume_queued": "resume_wait",    # response ready, re-queued
    "preempted": "preempt_wait",       # vacated by preemption, re-queued
    "completed": "completed_wait",     # done, waiting for the trainer
    "train": "train",                  # inside the train step
}
TERMINAL_STATES = ("committed", "dropped")


class Tracer:
    """Ring-buffered multi-thread span/mark recorder (see module doc)."""

    def __init__(self, clock=time.monotonic, capacity: int = 1_000_000):
        self._clock = clock
        self._trace_lock = threading.Lock()
        self._marks: deque = deque(maxlen=capacity)    # (trace, state, t)
        self._spans: deque = deque(maxlen=capacity)    # (proc, thread, name,
        #                                    t0, t1, trace, flow_in, flow_out)
        self._instants: deque = deque(maxlen=capacity)  # (proc, thread,
        #                                                  name, t, trace)
        self._traces: Dict[int, str] = {}              # trace -> task_id
        self._flow_kinds: Dict[int, str] = {}          # flow id -> kind
        self._next_trace = 0
        self._next_flow = 0
        self.dropped_events = 0
        self._capacity = capacity

    # -- recording (any thread) ------------------------------------------
    def now(self) -> float:
        return self._clock()

    def new_trace(self, task_id: str) -> int:
        with self._trace_lock:
            tr = self._next_trace
            self._next_trace += 1
            self._traces[tr] = task_id
        return tr

    def next_flow(self, kind: str) -> int:
        """Allocate a flow id for one hand-off arrow; ``kind`` names the
        hand-off (park / resume / preempt) for structure comparisons."""
        with self._trace_lock:
            fid = self._next_flow = self._next_flow + 1
            self._flow_kinds[fid] = kind
        return fid

    def _count_drop(self, buf) -> None:   # held: _trace_lock
        if len(buf) >= self._capacity:
            self.dropped_events += 1

    def mark(self, trace: Optional[int], state: str,
             t: Optional[float] = None) -> None:
        if trace is None:
            return
        if t is None:
            t = self._clock()
        with self._trace_lock:
            self._count_drop(self._marks)
            self._marks.append((trace, state, t))

    def span(self, track: Tuple[str, str], name: str, t0: float, t1: float,
             trace: Optional[int] = None, flow_in: int = 0,
             flow_out: int = 0) -> None:
        with self._trace_lock:
            self._count_drop(self._spans)
            self._spans.append((track[0], track[1], name, t0, t1,
                                -1 if trace is None else trace,
                                flow_in, flow_out))

    def instant(self, track: Tuple[str, str], name: str,
                t: Optional[float] = None,
                trace: Optional[int] = None) -> None:
        if t is None:
            t = self._clock()
        with self._trace_lock:
            self._count_drop(self._instants)
            self._instants.append((track[0], track[1], name, t,
                                   -1 if trace is None else trace))

    # -- snapshots (analysis / tests) ------------------------------------
    def task_of(self, trace: int) -> str:
        with self._trace_lock:
            return self._traces.get(trace, "?")

    def flow_kind(self, fid: int) -> str:
        with self._trace_lock:
            return self._flow_kinds.get(fid, "?")

    def marks(self) -> Dict[int, List[Tuple[float, str]]]:
        """Per-trace time-ordered ``[(t, state), ...]`` lists."""
        with self._trace_lock:
            items = list(self._marks)
        out: Dict[int, List[Tuple[float, str]]] = {}
        for trace, state, t in items:
            out.setdefault(trace, []).append((t, state))
        for seq in out.values():
            seq.sort(key=lambda p: p[0])
        return out

    def spans(self) -> List[Tuple]:
        with self._trace_lock:
            return list(self._spans)

    def state_sequence(self, trace: int) -> List[str]:
        """The episode's time-ordered lifecycle states (parity tests)."""
        return [s for _, s in self.marks().get(trace, [])]

    def flow_kinds_of(self, trace: int) -> List[str]:
        """Outgoing hand-off kinds of one episode, in time order."""
        out = []
        for proc, thread, name, t0, t1, tr, fin, fout in self.spans():
            if tr == trace and fout:
                out.append((t1, self.flow_kind(fout)))
        return [k for _, k in sorted(out, key=lambda p: p[0])]

    # -- export ----------------------------------------------------------
    def components(self) -> Dict[int, Dict]:
        """Per-trace additive latency decomposition, computed from the
        lifecycle marks: ``{trace: {task, t0, t1, terminal,
        components: {label: seconds}}}``. Consecutive marks partition the
        timeline, so ``sum(components.values()) == t1 - t0`` exactly."""
        out: Dict[int, Dict] = {}
        for trace, seq in self.marks().items():
            if len(seq) < 2:
                continue
            comps: Dict[str, float] = {}
            for (ta, sa), (tb, _sb) in zip(seq, seq[1:]):
                label = COMPONENT_OF.get(sa)
                if label is None:      # terminal mid-sequence: stop here
                    break
                comps[label] = comps.get(label, 0.0) + (tb - ta)
            out[trace] = {
                "task": self.task_of(trace),
                "t0": seq[0][0], "t1": seq[-1][0],
                "terminal": seq[-1][1],
                "components": comps,
            }
        return out

    def export_chrome(self) -> Dict:
        """Chrome trace-event JSON (dict) — open in https://ui.perfetto.dev.

        Layout: one process per stage group (rollout / prefill / env /
        manager / train), one thread per track (slot, worker, queue); a
        synthesized ``episodes`` process holds one thread per trace with
        the per-stage component slices; flow ``s``/``f`` pairs draw the
        park→env→resume (and preempt→reinstall) arrows."""
        with self._trace_lock:
            spans = list(self._spans)
            instants = list(self._instants)
            traces = dict(self._traces)
            flow_kinds = dict(self._flow_kinds)
        comp = self.components()
        # common time base: trace ts are µs from the earliest event
        t_min = None
        for _, _, _, t0, _, _, _, _ in spans:
            t_min = t0 if t_min is None else min(t_min, t0)
        for info in comp.values():
            t_min = info["t0"] if t_min is None else min(t_min, info["t0"])
        for _, _, _, t, _ in instants:
            t_min = t if t_min is None else min(t_min, t)
        if t_min is None:
            t_min = 0.0

        def us(t: float) -> float:
            return round((t - t_min) * 1e6, 3)

        events: List[Dict] = []
        pids: Dict[str, int] = {}
        tids: Dict[Tuple[str, str], int] = {}

        def pid_of(proc: str) -> int:
            if proc not in pids:
                pids[proc] = len(pids) + 1
                events.append({"ph": "M", "name": "process_name",
                               "pid": pids[proc],
                               "args": {"name": proc}})
                events.append({"ph": "M", "name": "process_sort_index",
                               "pid": pids[proc],
                               "args": {"sort_index": len(pids)}})
            return pids[proc]

        def tid_of(proc: str, thread: str) -> Tuple[int, int]:
            pid = pid_of(proc)
            key = (proc, thread)
            if key not in tids:
                tids[key] = len([k for k in tids if k[0] == proc]) + 1
                events.append({"ph": "M", "name": "thread_name", "pid": pid,
                               "tid": tids[key], "args": {"name": thread}})
            return pid, tids[key]

        for proc, thread, name, t0, t1, trace, fin, fout in spans:
            pid, tid = tid_of(proc, thread)
            args = {} if trace < 0 else {"trace": trace,
                                         "task": traces.get(trace, "?")}
            events.append({"ph": "X", "cat": proc, "name": name,
                           "pid": pid, "tid": tid, "ts": us(t0),
                           "dur": max(0.001, us(t1) - us(t0)),
                           "args": args})
            if fin:
                events.append({"ph": "f", "bp": "e", "cat": "handoff",
                               "name": flow_kinds.get(fin, "flow"),
                               "id": fin, "pid": pid, "tid": tid,
                               "ts": us(t0)})
            if fout:
                events.append({"ph": "s", "cat": "handoff",
                               "name": flow_kinds.get(fout, "flow"),
                               "id": fout, "pid": pid, "tid": tid,
                               "ts": us(t1)})
        for proc, thread, name, t, trace in instants:
            pid, tid = tid_of(proc, thread)
            args = {} if trace < 0 else {"trace": trace,
                                         "task": traces.get(trace, "?")}
            events.append({"ph": "i", "cat": proc, "name": name, "pid": pid,
                           "tid": tid, "ts": us(t), "s": "t", "args": args})
        # synthesized per-episode component slices (what report.py reads)
        marks_by_trace = self.marks()
        for trace in sorted(comp):
            info = comp[trace]
            pid, tid = tid_of("episodes", f"{info['task']}#{trace}")
            seq = marks_by_trace.get(trace, [])
            for (ta, sa), (tb, _sb) in zip(seq, seq[1:]):
                label = COMPONENT_OF.get(sa)
                if label is None:
                    break
                events.append({"ph": "X", "cat": "episode", "name": label,
                               "pid": pid, "tid": tid, "ts": us(ta),
                               "dur": max(0.001, us(tb) - us(ta)),
                               "args": {"trace": trace, "task": info["task"],
                                        "state": sa,
                                        "terminal": info["terminal"]}})
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped_events,
                              "traces": len(traces)}}

    def dump_json(self, path: str) -> Dict:
        """Write the Chrome trace to ``path``; returns the exported dict."""
        doc = self.export_chrome()
        with open(path, "w") as f:
            json.dump(doc, f)
        return doc
