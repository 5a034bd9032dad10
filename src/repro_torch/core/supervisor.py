"""Stage supervision + tenant circuit breaker.

``StageSupervisor`` watches the worker pools of the threaded stages
(prefill workers, env workers) from the engine's step loop: a stage whose
pool has dead or wedged members first has its stranded in-flight work
recovered (a dead prefill worker's rows re-enter the scheduler queue, a
dead env worker's jobs are re-queued), then is restarted back to full
complement under bounded exponential backoff. A stage that keeps dying
past its restart budget ESCALATES — by default that raises on the caller
(the rollout thread), which surfaces as ``runtime.error`` and feeds the
existing checkpoint-restart path (``recover_inflight``/``load_checkpoint``,
see ``MARLaaSRuntime.run_with_recovery``).

``TenantBreaker`` is the per-tenant circuit breaker behind quarantine:
repeated episode failures (permanent tool errors) trip a tenant OPEN —
the runtime pauses its admission, drains its queued work with counted
drops, and the other tenants keep full throughput. After a cooldown the
breaker HALF-OPENS and the runtime re-admits one probe round; a clean
probe closes the breaker, another failure re-trips it, and a tenant that
trips more than ``max_trips`` times is ABANDONED (marked terminal so the
run can finish without it). State changes are queued as transitions and
applied by exactly one thread (the rollout loop) — the record_* calls
only mutate breaker-internal state, never runtime structures.

``join_or_raise`` lives here (moved from core/runtime.py, which
re-exports it) so the rollout stages can use it for their own shutdown
paths without importing the runtime module — core.runtime already
imports rollout.engine, and rollout.env_stage importing it back would be
a cycle.

A copy of ``repro.core.supervisor`` (plain Python). The breaker's lock is
named ``_breaker_lock`` (the JAX package's is ``_lock``), for the lock
analyzer, which names a lock by class and attribute.
"""
from __future__ import annotations

import faulthandler
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple


def join_or_raise(threads: List[threading.Thread], timeout_s: float = 10.0):
    """Join `threads` within one shared deadline; raise loudly on leaks.

    A thread still alive after the stop flag + join timeout is a wedged
    stage (deadlocked lock, stuck tool call, hung device op). Silently
    returning would leak it into the caller's process — later runs then
    fight it for slots/devices and failures surface far from the cause.
    Instead: dump every thread's stack (faulthandler) and raise."""
    deadline = time.monotonic() + timeout_s
    for t in threads:
        t.join(timeout=max(0.0, deadline - time.monotonic()))
    leaked = [t for t in threads if t.is_alive()]
    if leaked:
        names = ", ".join(t.name for t in leaked)
        faulthandler.dump_traceback(file=sys.stderr)
        raise RuntimeError(
            f"runtime thread(s) still alive {timeout_s:.0f}s after stop: "
            f"{names} — all thread stacks dumped to stderr")


@dataclass
class StagePolicy:
    """Restart budget of one supervised stage."""
    max_restarts: int = 8          # consecutive restarts before escalation
    backoff_base_s: float = 0.02   # first-restart delay
    backoff_max_s: float = 2.0     # backoff ceiling; also the healthy
                                   # streak-reset horizon


class _Stage:
    __slots__ = ("name", "healthy", "recover", "restart", "policy",
                 "escalate", "streak", "total_restarts", "last_restart_at",
                 "next_restart_at")

    def __init__(self, name, healthy, recover, restart, policy, escalate):
        self.name = name
        self.healthy = healthy
        self.recover = recover
        self.restart = restart
        self.policy = policy
        self.escalate = escalate
        self.streak = 0
        self.total_restarts = 0
        self.last_restart_at = 0.0
        self.next_restart_at = 0.0


class StageSupervisor:
    """Liveness/heartbeat supervision of worker-pool stages.

    Thread contract: ``register`` at construction time, then ``tick`` from
    ONE thread only (the engine step loop). The registered callables run
    on that thread; ``healthy``/``recover``/``restart`` must therefore be
    safe to call from it (the stage modules already lock internally)."""

    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 tracer=None):
        self.clock = clock
        self.tracer = tracer
        self._stages: Dict[str, _Stage] = {}
        self.counters: Dict[str, int] = {}   # tick-thread only

    def register(self, name: str, *, healthy: Callable[[], bool],
                 restart: Callable[[], None],
                 recover: Optional[Callable[[], int]] = None,
                 policy: Optional[StagePolicy] = None,
                 escalate: Optional[Callable[[str], None]] = None):
        self._stages[name] = _Stage(name, healthy, recover, restart,
                                    policy or StagePolicy(), escalate)

    def _count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + n

    def tick(self, now: Optional[float] = None) -> bool:
        """One supervision pass; True if any stage restarted. Recovery
        runs BEFORE restart so re-queued work is visible the moment fresh
        workers start popping."""
        now = self.clock() if now is None else now
        acted = False
        for st in self._stages.values():
            if st.healthy():
                # a stage that stayed healthy past the backoff ceiling has
                # genuinely recovered: forgive the streak so a much-later
                # isolated death doesn't escalate
                if st.streak and now - st.last_restart_at \
                        > st.policy.backoff_max_s:
                    st.streak = 0
                continue
            if now < st.next_restart_at:
                continue
            if st.streak >= st.policy.max_restarts:
                msg = (f"stage {st.name!r} died {st.streak} times within "
                       f"its backoff window — restart budget exhausted, "
                       f"escalating to checkpoint-restart")
                self._count(f"{st.name}_escalations")
                if st.escalate is not None:
                    st.escalate(msg)
                    continue
                raise RuntimeError(msg)
            recovered = st.recover() if st.recover is not None else 0
            st.restart()
            st.streak += 1
            st.total_restarts += 1
            st.last_restart_at = now
            backoff = min(st.policy.backoff_max_s,
                          st.policy.backoff_base_s * (2 ** (st.streak - 1)))
            st.next_restart_at = now + backoff
            self._count(f"{st.name}_restarts")
            if recovered:
                self._count(f"{st.name}_jobs_recovered", recovered)
            if self.tracer is not None:
                self.tracer.instant(("supervisor", st.name), "restart", now)
            acted = True
        return acted


# -- per-tenant circuit breaker ------------------------------------------

CLOSED, OPEN, HALF_OPEN, ABANDONED = ("closed", "open", "half_open",
                                      "abandoned")


class _Tenant:
    __slots__ = ("state", "fails", "trips", "opened_at")

    def __init__(self):
        self.state = CLOSED
        self.fails = 0          # consecutive failures while closed/half-open
        self.trips = 0
        self.opened_at = 0.0


class TenantBreaker:
    """Closed -> open after ``fail_threshold`` consecutive episode
    failures; open -> half_open after ``cooldown_s`` (probe); half_open ->
    closed on a clean probe, -> open again on failure, -> abandoned once
    trips exceed ``max_trips``. Thread-safe: record_* may run on the
    rollout thread while ``poll`` advances cooldowns; transitions queue
    internally and ``poll`` hands them to the single applying thread."""

    def __init__(self, *, fail_threshold: int = 5, cooldown_s: float = 2.0,
                 max_trips: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.fail_threshold = fail_threshold
        self.cooldown_s = cooldown_s
        self.max_trips = max_trips
        self.clock = clock
        self._breaker_lock = threading.Lock()   # guards: _tenants/_transitions
        self._tenants: Dict[str, _Tenant] = {}
        self._transitions: List[Tuple[str, str]] = []

    def _get(self, tid: str) -> _Tenant:   # held: _breaker_lock
        t = self._tenants.get(tid)
        if t is None:
            t = self._tenants[tid] = _Tenant()
        return t

    def _trip(self, tid: str, t: _Tenant):   # held: _breaker_lock
        t.trips += 1
        t.fails = 0
        if t.trips > self.max_trips:
            t.state = ABANDONED
            self._transitions.append((tid, ABANDONED))
        else:
            t.state = OPEN
            t.opened_at = self.clock()
            self._transitions.append((tid, OPEN))

    def record_failure(self, tid: str):
        """One failed episode (permanent tool error / failed round)."""
        with self._breaker_lock:
            t = self._get(tid)
            if t.state == CLOSED:
                t.fails += 1
                if t.fails >= self.fail_threshold:
                    self._trip(tid, t)
            elif t.state == HALF_OPEN:
                # the probe failed: re-trip (or abandon past the budget)
                self._trip(tid, t)
            # open/abandoned: in-flight stragglers of the tripped tenant
            # still land here — they must not double-trip

    def record_success(self, tid: str):
        with self._breaker_lock:
            t = self._tenants.get(tid)
            if t is None:
                return
            if t.state == HALF_OPEN:
                t.state = CLOSED
                t.fails = 0
                t.trips = 0          # a clean probe is a full recovery
                self._transitions.append((tid, CLOSED))
            elif t.state == CLOSED:
                t.fails = 0

    def poll(self, now: Optional[float] = None) -> List[Tuple[str, str]]:
        """Advance open->half_open cooldowns, then return (and clear) the
        queued transitions for the applying thread."""
        now = self.clock() if now is None else now
        with self._breaker_lock:
            for tid, t in self._tenants.items():
                if t.state == OPEN and now - t.opened_at >= self.cooldown_s:
                    t.state = HALF_OPEN
                    self._transitions.append((tid, HALF_OPEN))
            out = self._transitions
            self._transitions = []
            return out

    def state(self, tid: str) -> str:
        with self._breaker_lock:
            t = self._tenants.get(tid)
            return t.state if t is not None else CLOSED

    def snapshot(self) -> Dict[str, str]:
        """Non-closed tenants only (closed == no entry == healthy)."""
        with self._breaker_lock:
            return {tid: t.state for tid, t in self._tenants.items()
                    if t.state != CLOSED}
