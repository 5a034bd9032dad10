"""Occupancy-timeline metrics — the paper's evaluation quantities (§5):

  utilization %  — average accelerator AI-core utilization: device-seconds
                   busy × phase compute-intensity / total device-seconds.
                   (Profilers count core-active cycles, which is why even a
                   fully-occupied decode pool reports single-digit %; we
                   model that with per-phase intensity factors.)
  idle %         — fraction of device-seconds with NO job resident.
  steps/hr       — committed train steps per wall-clock hour.
  TTFS           — time-to-first-step per task (submission → first commit).
  TPTS           — time-per-train-step once underway.
  slot util %    — continuous-batching decode-slot occupancy: time-weighted
                   fraction of the engine's decode slots holding a live row
                   (the §4.1 quantity round-fused scheduling wastes at the
                   end-of-round barrier).
  stage busy     — per-stage (prefill / decode / splice) busy seconds of the
                   disaggregated rollout layout (Fig 5): prefill intervals
                   come from the async prefill workers, decode intervals
                   from the decode stream, splice intervals from the
                   scatter-only installs. Under the fused baseline prefill
                   intervals sit ON the decode stream (decode-stall); under
                   ``disagg_prefill`` they overlap it.
  queue depth    — step-function timeline of the prefill-stage queues
                   (waiting + in-prefill, ready-to-splice) — the Fig-5
                   hand-off depths between the two rollout stages — and of
                   the env-interaction stage's queues (waiting, executing).
  env busy/wait  — environment-interaction accounting: "env" intervals are
                   recorded per task (tool dispatch → response), never
                   counted as device-busy (PHASE_INTENSITY 0, excluded from
                   busy/idle). env wait = Σ interval durations (row-seconds
                   spent blocked on tools); env busy = their merged union
                   (wall time with ≥1 tool call outstanding).

Both runtimes (real threads and virtual-time simulator) record through this
same recorder, so benchmark tables are produced by one code path. The
recorder is thread-safe: the disaggregated prefill workers record stage
intervals concurrently with the decode and trainer threads.

A copy of ``repro.core.metrics`` (plain Python). The recorder's lock is
named ``_rec_lock`` (the JAX package's is ``_lock``), for the lock
analyzer, which names a lock by class and attribute.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# AI-core intensity per phase: fraction of peak compute a resident phase
# actually drives (decode is HBM-bound → low; matches paper Table 3 scale).
PHASE_INTENSITY = {
    "decode": 0.08,
    "prefill": 0.45,
    "splice": 0.05,     # scatter-only cache install (HBM copy, no compute)
    "train": 0.40,
    "env": 0.0,
}


@dataclass
class Interval:
    pool: str
    phase: str
    task_id: str
    start: float
    end: float
    devices: float          # device-count occupied (can be fractional in PS)


@dataclass
class PoolSpec:
    name: str
    devices: int


class MetricsRecorder:
    def __init__(self, pools: Dict[str, int]):
        self.pools = dict(pools)
        self.intervals: List[Interval] = []
        self.slot_samples: List[Tuple[float, int, int]] = []  # (t, occ, cap)
        self.queue_samples: List[Tuple[float, int, int]] = []  # (t, pq, rq)
        self.env_samples: List[Tuple[float, int, int]] = []  # (t, wait, exec)
        # (t, used pages, total pages, fragmentation) of the paged KV pool
        self.page_samples: List[Tuple[float, int, int, float]] = []
        self.counters: Dict[str, int] = {}    # preemption/eviction/replay...
        # ONE source of truth for event counters: the
        # engine's RolloutStats (attached by the runtime) is merged into
        # counters_snapshot() alongside the explicit incr() counters, so
        # summarize() never depends on hand-mirrored incr calls staying in
        # sync with the stats fields
        self._rollout_stats = None
        # trainer hand-off accounting (async off-policy trainer):
        # spans the trainer spent blocked in pop, and a step-function
        # timeline of the DISPATCHABLE backlog (whole micro-batches the
        # trainer could pop right now) — together they measure "trainer
        # idle while trainable work existed", the quantity the round barrier
        # wastes. Wait spans are NOT intervals: they must never count as
        # device-busy time.
        self.trainer_waits: List[Tuple[float, float]] = []
        self.backlog_samples: List[Tuple[float, int]] = []  # (t, rows)
        # (t, tenant, state) circuit-breaker transition timeline:
        # closed -> open -> half_open -> closed/abandoned per tenant
        self.breaker_samples: List[Tuple[float, str, str]] = []
        self.t0: Optional[float] = None
        self.t1: Optional[float] = None
        # prefill workers record concurrently with the decode/train threads
        self._rec_lock = threading.Lock()   # guards: intervals/slot_samples/
                                        # queue_samples/env_samples/
                                        # page_samples/counters/trainer_waits/
                                        # backlog_samples

    def incr(self, name: str, n: int = 1):
        """Count a scheduler event (preemptions, adapter_evictions,
        adapter_installs, replays, readmissions, ...)."""
        with self._rec_lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def attach_rollout_stats(self, stats) -> None:
        """Adopt the engine's RolloutStats as a counter source: its integer
        event fields (parks, resumes, restores, prefix_hits, ...) appear in
        counters_snapshot() by field name, live — no mirroring incr()
        required and no end-of-run copy to forget."""
        with self._rec_lock:
            self._rollout_stats = stats

    def counters_snapshot(self) -> Dict[str, int]:
        """Explicit incr() counters merged with the attached RolloutStats'
        nonzero integer fields. Explicit counters win on a name collision
        ("preemptions" counts preemption EVENTS via incr but preempted ROWS
        in the stats — the recorder's own semantics take precedence)."""
        import dataclasses
        with self._rec_lock:
            merged = dict(self.counters)
            stats = self._rollout_stats
        if stats is not None:
            for f in dataclasses.fields(stats):
                v = getattr(stats, f.name)
                if (isinstance(v, int) and not isinstance(v, bool)
                        and v != 0 and f.name not in merged):
                    merged[f.name] = v
        return merged

    def record(self, pool: str, phase: str, task_id: str, start: float,
               end: float, devices: float = None):
        if end <= start:
            return
        devices = devices if devices is not None else self.pools.get(pool, 0)
        with self._rec_lock:
            self.intervals.append(Interval(pool, phase, task_id, start, end,
                                           devices))
            self.t0 = start if self.t0 is None else min(self.t0, start)
            self.t1 = end if self.t1 is None else max(self.t1, end)

    def record_slot_sample(self, t: float, occupied: int, capacity: int):
        """Point sample of continuous-engine slot occupancy (step-function
        timeline: the value holds until the next sample)."""
        if capacity <= 0:
            return
        with self._rec_lock:
            self.slot_samples.append((t, occupied, capacity))

    def record_queue_sample(self, t: float, prefill_q: int, ready_q: int):
        """Point sample of the disaggregated prefill stage's queue depths
        (waiting+in-prefill, ready-to-splice); step-function timeline like
        the slot samples."""
        with self._rec_lock:
            self.queue_samples.append((t, prefill_q, ready_q))

    def record_env_sample(self, t: float, waiting: int, executing: int):
        """Point sample of the env-interaction stage's queue depths
        (requests waiting for a worker, tool calls executing)."""
        with self._rec_lock:
            self.env_samples.append((t, waiting, executing))

    def record_page_sample(self, t: float, used: int, total: int,
                           frag: float):
        """Point sample of the paged KV block pool: pages in use, pool
        size, and internal fragmentation (allocated page slack beyond the
        live cache entries); step-function timeline like the others."""
        if total <= 0:
            return
        with self._rec_lock:
            self.page_samples.append((t, used, total, frag))

    def record_breaker_sample(self, t: float, task_id: str, state: str):
        """One tenant circuit-breaker transition (quarantine story): the
        state holds until the tenant's next transition."""
        with self._rec_lock:
            self.breaker_samples.append((t, task_id, state))

    def breaker_timeline(self, task_id: Optional[str] = None
                         ) -> List[Tuple[float, str, str]]:
        """Breaker transitions in time order, optionally one tenant's."""
        with self._rec_lock:
            return [s for s in self.breaker_samples
                    if task_id is None or s[1] == task_id]

    def record_trainer_wait(self, start: float, end: float):
        """The trainer blocked in pop (no admissible micro-batch) over
        [start, end). Booked separately from intervals so it can never be
        mistaken for device-busy time."""
        if end <= start:
            return
        with self._rec_lock:
            self.trainer_waits.append((start, end))

    def record_train_backlog(self, t: float, rows: int):
        """Point sample of the dispatchable train backlog — rows sitting
        in whole micro-batches the trainer could pop right now (complete
        GRPO groups in ``train_threshold`` multiples per tenant in async
        mode; assembled Q_buffer rounds in sync mode). Step-function
        timeline: sampled at every completion routing, pop, and commit,
        the points where the level can change."""
        with self._rec_lock:
            self.backlog_samples.append((t, rows))

    def trainer_idle_stats(self) -> Dict[str, float]:
        """Trainer idle-while-work-available between the first and last
        train step: seconds the trainer sat in pop while a dispatchable
        micro-batch existed, and that as a fraction of the
        first-commit→last-commit span. Sub-threshold partial assemblies
        are not dispatchable (no trainer could legally train them), so
        trickle-in assembly time never counts against the trainer. This
        is the hand-off latency the event-driven trainer eliminates (the
        async bench gates on trainer_idle_frac ≈ 0)."""
        with self._rec_lock:
            trains = [iv for iv in self.intervals if iv.pool == "train"]
            waits = list(self.trainer_waits)
            samples = list(self.backlog_samples)
        if not trains:
            return {}
        t0 = min(iv.start for iv in trains)
        t1 = max(iv.end for iv in trains)
        if t1 <= t0:
            return {}
        segs: List[Tuple[float, float, int]] = []   # (start, end, backlog)
        samples.sort()          # engine + trainer threads record concurrently
        level, last = 0, None
        for t, lv in samples:
            if last is not None and t > last:
                segs.append((last, t, level))
            level = lv
            last = t
        if last is not None:
            segs.append((last, float("inf"), level))
        idle = 0.0
        for ws, we in waits:
            ws, we = max(ws, t0), min(we, t1)
            if we <= ws:
                continue
            for ss, se, lv in segs:
                if lv <= 0:
                    continue
                s, e = max(ws, ss), min(we, se)
                if e > s:
                    idle += e - s
        return {"trainer_idle_with_work_s": idle,
                "trainer_span_s": t1 - t0,
                "trainer_idle_frac": idle / (t1 - t0)}

    def page_pool_stats(self) -> Dict[str, float]:
        """Time-weighted occupancy (used/total) and fragmentation of the
        paged KV pool over the run (empty dict in dense-cache mode)."""
        with self._rec_lock:
            ps = list(self.page_samples)
        if len(ps) < 2:
            return {}
        occ_w = frag_w = total = 0.0
        for (t0, u, cap, fr), (t1, _, _, _) in zip(ps, ps[1:]):
            dt = max(0.0, t1 - t0)
            occ_w += dt * u / cap
            frag_w += dt * fr
            total += dt
        if total <= 0:
            return {}
        return {"kv_page_occupancy_mean": occ_w / total,
                "kv_page_occupancy_max": max(u / cap
                                             for _, u, cap, _ in ps),
                "kv_page_frag_mean": frag_w / total}

    @staticmethod
    def _depth_stats(samples, names) -> Dict[str, float]:
        """Time-weighted mean + max per column of a step-function
        (t, d0, d1) depth timeline."""
        if len(samples) < 2:
            return {}
        w0 = w1 = total = 0.0
        for (t0, a, b), (t1, _, _) in zip(samples, samples[1:]):
            dt = max(0.0, t1 - t0)
            w0 += dt * a
            w1 += dt * b
            total += dt
        if total <= 0:
            return {}
        return {f"{names[0]}_mean": w0 / total,
                f"{names[0]}_max": float(max(a for _, a, _ in samples)),
                f"{names[1]}_mean": w1 / total,
                f"{names[1]}_max": float(max(b for _, _, b in samples))}

    def queue_depth_stats(self) -> Dict[str, float]:
        """Time-weighted mean + max depth per stage queue over the run
        (prefill + ready queues, and the env stage's queues if sampled)."""
        with self._rec_lock:
            qs = list(self.queue_samples)
            es = list(self.env_samples)
        out = self._depth_stats(qs, ("prefill_q", "ready_q"))
        out.update(self._depth_stats(es, ("env_q", "env_exec")))
        return out

    # -- environment-interaction accounting -----------------------------
    def env_wait_seconds(self) -> float:
        """Σ env-interval durations: row-seconds spent blocked on external
        tools/judges (the per-task split is env_wait_by_task)."""
        with self._rec_lock:
            return sum(iv.end - iv.start for iv in self.intervals
                       if iv.phase == "env")

    def env_wait_by_task(self) -> Dict[str, float]:
        """Per-tenant env-interaction wait seconds (satellite: the global
        aggregate hid which tenant's tools were slow)."""
        out: Dict[str, float] = {}
        with self._rec_lock:
            ivs = list(self.intervals)
        for iv in ivs:
            if iv.phase == "env":
                out[iv.task_id] = out.get(iv.task_id, 0.0) + (iv.end - iv.start)
        return out

    def env_busy_seconds(self) -> float:
        """Merged union of env intervals: wall time with at least one tool
        call outstanding (concurrent calls counted once)."""
        with self._rec_lock:
            spans = sorted((iv.start, iv.end) for iv in self.intervals
                           if iv.phase == "env")
        busy, cur_s, cur_e = 0.0, None, None
        for s, e in spans:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            busy += cur_e - cur_s
        return busy

    def slot_utilization_pct(self) -> float:
        """Time-weighted mean of occupied/capacity over the sampled span."""
        with self._rec_lock:
            ss = list(self.slot_samples)
        if len(ss) < 2:
            return 0.0
        weighted = total = 0.0
        for (t0, occ, cap), (t1, _, _) in zip(ss, ss[1:]):
            dt = max(0.0, t1 - t0)
            weighted += dt * occ / cap
            total += dt
        return 100.0 * weighted / total if total > 0 else 0.0

    # ------------------------------------------------------------------
    def span(self) -> float:
        if self.t0 is None:
            return 0.0
        return self.t1 - self.t0

    def total_device_seconds(self) -> float:
        return sum(self.pools.values()) * self.span()

    def busy_device_seconds(self, pool: str = None,
                            phase: str = None) -> float:
        with self._rec_lock:
            return sum((iv.end - iv.start) * iv.devices
                       for iv in self.intervals
                       if iv.phase != "env"
                       and (pool is None or iv.pool == pool)
                       and (phase is None or iv.phase == phase))

    def utilization_pct(self) -> float:
        """AI-core utilization (paper Table 3 definition)."""
        total = self.total_device_seconds()
        if total <= 0:
            return 0.0
        with self._rec_lock:
            weighted = sum((iv.end - iv.start) * iv.devices
                           * PHASE_INTENSITY.get(iv.phase, 0.3)
                           for iv in self.intervals)
        return 100.0 * weighted / total

    def idle_pct(self) -> float:
        """Fraction of device-seconds with no resident job (merged per pool)."""
        total = self.total_device_seconds()
        if total <= 0:
            return 0.0
        busy = 0.0
        with self._rec_lock:
            ivs = list(self.intervals)
        for pool, ndev in self.pools.items():
            # merge overlapping intervals weighted by occupied devices
            evs: List[Tuple[float, float]] = []
            for iv in ivs:
                if iv.pool != pool or iv.phase == "env":
                    continue
                evs.append((iv.start, min(iv.devices, ndev)))
                evs.append((iv.end, -min(iv.devices, ndev)))
            evs.sort()
            occ, last_t = 0.0, None
            for t, d in evs:
                if last_t is not None and occ > 0:
                    busy += min(occ, ndev) * (t - last_t)
                occ += d
                last_t = t
        return 100.0 * (1.0 - busy / total)


def summarize(manager, rec: MetricsRecorder) -> Dict[str, float]:
    """Standard summary across the paper's metrics."""
    span = rec.span()
    states = [st for _, st in manager.task_items()]
    steps = sum(st.steps_done for st in states)
    ttfs = [st.first_step_at - st.submitted_at
            for st in states if st.first_step_at is not None]
    tpts: List[float] = []
    for st in states:
        ts = st.step_times
        tpts += [b - a for a, b in zip(ts, ts[1:])]
    out = {
        "span_s": span,
        "total_steps": float(steps),
        "steps_per_hr": 3600.0 * steps / span if span else 0.0,
        "utilization_pct": rec.utilization_pct(),
        "idle_pct": rec.idle_pct(),
        "ttfs_mean_s": sum(ttfs) / len(ttfs) if ttfs else 0.0,
        "ttfs_max_s": max(ttfs) if ttfs else 0.0,
        "tpts_mean_s": sum(tpts) / len(tpts) if tpts else 0.0,
        "time_hrs": span / 3600.0,
        "slot_util_pct": rec.slot_utilization_pct(),
    }
    # per-stage busy time of the disaggregated rollout layout (Fig 5)
    for phase in ("prefill", "decode", "splice"):
        busy = rec.busy_device_seconds(pool="rollout", phase=phase)
        if busy > 0:
            out[f"{phase}_busy_s"] = busy
    # environment-interaction stage: wait (row-seconds blocked on tools)
    # and busy (wall time with a tool call outstanding) — never counted as
    # device time (per-task split: rec.env_wait_by_task())
    env_wait = rec.env_wait_seconds()
    if env_wait > 0:
        out["env_wait_s"] = env_wait
        out["env_busy_s"] = rec.env_busy_seconds()
    out.update(rec.queue_depth_stats())
    # trainer hand-off: idle-while-work-available between first and last
    # commit (≈0 for the event-driven trainer; the round barrier's waste)
    out.update(rec.trainer_idle_stats())
    # paged KV pool occupancy/fragmentation gauges: absent under
    # the dense cache; restore-vs-replay counts ride the counters below
    # (n_restores / n_replays / n_replay_tokens_saved / n_snapshot_drops)
    out.update(rec.page_pool_stats())
    # scheduler event counters (zero-valued keys omitted: absent == 0) —
    # the unified snapshot: explicit incr() counters merged with the
    # attached engine RolloutStats (one source of
    # truth). kv_* entries are end-of-run gauges of the prefix cache
    # (shared pages, index-held pages, HBM bytes per resident row) riding
    # the counter channel — emitted without the n_ count prefix.
    for name, n in sorted(rec.counters_snapshot().items()):
        key = name if name.startswith("kv_") else f"n_{name}"
        out[key] = float(n)
    return out
