"""The disaggregated environment-interaction stage (paper §4.1, Fig. 5);
port of ``repro.rollout.env_stage``.

With ``env_stage=True`` a row that samples ``tok.CALL`` is PARKED instead of
freezing in its decode slot for the whole tool latency: the engine vacates
the slot (its generated prefix lives host-side; with the paged cache its
pages stay in the pool or go to a host snapshot) and hands the call to
``EnvStage``, a request/response pipeline between the decode thread and a
pool of ``EnvWorker`` threads:

  decode thread ──park──> request queue ──pop──> EnvWorker pool
       ▲                  (FIFO, per-tenant        latency sleep +
       │                   in-flight caps)         session.call()
       └──resume job <── response queue <──emit────────┘

The engine's pump turns each response into a resume job: the row re-enters
the scheduler queue with its force-feed queue pre-loaded (``RESP … ENDRESP``)
and comes back through the restore, fused-refill or prefill-worker path.
Decode slots are never held by I/O-waiting rows, and the token stream equals
the freeze-in-slot one given the same tool responses.

Fairness: ``max_inflight_per_tenant`` caps how many of one tenant's calls
run at once. Timeouts are driven by the engine: ``expire()`` cancels queued
jobs and flags executing ones, whose late responses are dropped. A
``TransientToolError`` is retried with exponential backoff and jitter on the
queue side (``EnvJob.not_before``); a ``PermanentToolError`` or a spent retry
budget surfaces as ``job.error`` and the engine finishes the row with
``finish_reason="tool_error"``. ``healthy``/``mark_wedged``/``recover_dead``
feed the engine's ``StageSupervisor``. A ``ChaosInjector`` (``chaos``)
kills workers mid-job (``env_worker_kill``: the job stays stranded until the
supervisor recovers it) and injects tool faults (``_chaos_tool_fault``). No
device work happens here.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.supervisor import join_or_raise
from repro_torch.envs.base import (CancelToken, PermanentToolError,
                                   ToolError, TransientToolError,
                                   call_session)


@dataclass
class EnvJob:
    """One parked episode's in-flight environment interaction."""
    row: object                  # engine _Row (host-side episode state)
    query: List[int]             # prompt + generated prefix (ends in CALL)
    task_id: str
    latency: float               # sampled env-interaction latency (seconds)
    submitted_at: float
    started_at: float = 0.0      # worker pickup time
    resolved_at: float = 0.0
    response: Optional[List[int]] = None
    error: Optional[BaseException] = None
    # timeout/abort: the late result is discarded AND the token wakes the
    # executing worker immediately (interruptible latency sleep +
    # cooperative mid-call checks) instead of letting the call run to
    # completion for nothing
    cancel: CancelToken = field(default_factory=CancelToken)
    state: str = "queued"        # queued | executing | done
    worker: int = -1             # executing worker's id (tracer track)
    flow: int = 0                # park→env hand-off arrow (repro_torch.obs)
    attempts: int = 0            # tries so far (retry accounting)
    not_before: float = 0.0      # retry backoff: ineligible until then
    chaos_transient_left: int = 0  # injected consecutive transient fails
    chaos_permanent: bool = False  # injected permanent endpoint failure

    @property
    def cancelled(self) -> bool:
        return self.cancel.cancelled


class EnvWorker(threading.Thread):
    """Env-interaction worker: pops eligible jobs (FIFO within the
    per-tenant cap), applies the sampled external latency, runs the
    episode's stateful session call, and emits the response."""

    def __init__(self, stage: "EnvStage", worker_id: int = 0):
        super().__init__(daemon=True, name=f"env-worker-{worker_id}")
        self.stage = stage
        self.worker_id = worker_id
        self.last_beat = time.monotonic()   # liveness heartbeat (supervisor)
        self.poisoned = False    # marked wedged: excluded from the pool
                                 # complement, its job already recovered
        self.chaos_killed = False

    def run(self):
        stage = self.stage
        chaos = stage.chaos
        while True:
            self.last_beat = time.monotonic()
            job = stage._pop_eligible(worker=self)
            if job is None:
                if stage._stop.is_set():
                    return
                continue
            if chaos is not None and chaos.fire("env_worker_kill"):
                # simulated abrupt death: no _finish, no cleanup — the job
                # stays stranded in _executing (inflight count held) until
                # the supervisor's recover_dead() re-queues it
                self.chaos_killed = True
                return
            if job.latency > 0 and job.attempts == 0 \
                    and not stage.sim_latency:
                # interruptible: a timeout/abort wakes the worker NOW
                # (retries skip the latency — the backoff already ran)
                job.cancel.wait(job.latency)
            resp: List[int] = []
            try:
                if not job.cancelled:
                    stage._chaos_tool_fault(job)
                    resp = list(call_session(job.row.session, job.query,
                                             job.cancel))
            except ToolError as e:
                job.attempts += 1
                if (isinstance(e, TransientToolError)
                        and stage._schedule_retry(job)):
                    continue
                job.error = e
                stage._finish(job, [])
                continue
            except BaseException as e:      # surfaced on the engine thread
                job.error = e
            stage._finish(job, resp)


class EnvStage:
    """Event-driven env-interaction stage shared by one engine.

    Thread contract: ``submit`` / ``drain_resolved`` / ``expire`` /
    ``cancel_all`` / ``recover_dead`` / ``mark_wedged`` are called from
    the engine (decode) thread; workers only touch the queues under the
    stage condition. All host state — no device work happens here, which
    is the point: env I/O never rides the decode stream."""

    def __init__(self, n_workers: int = 2, *,
                 max_inflight_per_tenant: int = 0,
                 sim_latency: bool = False,
                 retry_max: int = 3, retry_episode_cap: int = 0,
                 retry_base_s: float = 0.05, retry_max_s: float = 2.0,
                 seed: int = 0, chaos=None):
        if n_workers < 1:
            raise ValueError("env stage needs at least one worker")
        self.n_workers = n_workers
        self.max_inflight_per_tenant = max_inflight_per_tenant  # 0 = off
        self.sim_latency = sim_latency
        self.retry_max = retry_max              # retries per tool call
        self.retry_episode_cap = retry_episode_cap  # per episode (0 = off)
        self.retry_base_s = retry_base_s
        self.retry_max_s = retry_max_s
        self.chaos = chaos                      # ChaosInjector or None
        self._rng = random.Random(seed)         # retry jitter only — never
                                                # touches token sampling
        # guards: _queue/_executing/_done/_inflight (named apart from the
        # JAX class's _cond: the repo's lock analyzer names locks by class
        # and attribute)
        self._env_cond = threading.Condition()
        self._queue: Deque[EnvJob] = deque()      # FIFO request queue
        self._executing: Dict[int, EnvJob] = {}   # id(job) -> job
        self._done: Deque[EnvJob] = deque()       # response queue
        self._inflight: Dict[str, int] = {}       # tenant -> executing count
        self._stop = threading.Event()
        self._workers: List[EnvWorker] = []
        self._next_wid = 0      # unique worker ids across respawns: a
                                # replacement must not shadow a dead
                                # worker's stranded-job ownership
        self.calls = 0                            # jobs handed to workers
        self.timeouts = 0
        self.retries = 0                          # transient-error retries
        self.recovered = 0                        # jobs re-queued after a
                                                  # worker death/wedge
        self.wedged = 0                           # workers marked wedged

    # -- lifecycle --------------------------------------------------------
    def _ensure_workers(self):
        live = [w for w in self._workers if w.is_alive()]
        ok = [w for w in live if not w.poisoned]
        if len(ok) >= self.n_workers:
            self._workers = live
            return
        self._stop.clear()
        fresh = []
        for _ in range(self.n_workers - len(ok)):
            fresh.append(EnvWorker(self, self._next_wid))
            self._next_wid += 1
        # poisoned-but-alive zombies stay tracked: halt()'s join_or_raise
        # must surface them loudly rather than leak them silently
        self._workers = live + fresh
        for w in fresh:
            w.start()

    def healthy(self) -> bool:
        """Supervisor liveness check: full complement of alive,
        non-wedged workers (a halted/never-started pool is healthy —
        there is nothing to supervise)."""
        if not self._workers:
            return True
        ok = [w for w in self._workers if w.is_alive() and not w.poisoned]
        return len(ok) >= self.n_workers

    def mark_wedged(self, timeout_s: float,
                    now: Optional[float] = None) -> int:
        """Heartbeat check: poison workers stuck in one tool call longer
        than `timeout_s` (0 disables — legitimate long calls are the
        engine timeout's business, not ours). A poisoned worker leaves
        the complement; its job is recovered by ``recover_dead`` and its
        eventual late ``_finish`` is untracked and dropped."""
        if timeout_s <= 0:
            return 0
        now = time.monotonic() if now is None else now
        n = 0
        with self._env_cond:
            by_worker = {j.worker: j for j in self._executing.values()}
            for w in self._workers:
                if not w.is_alive() or w.poisoned:
                    continue
                job = by_worker.get(w.worker_id)
                if (job is not None and job.started_at
                        and now - job.started_at > timeout_s
                        and now - w.last_beat > timeout_s):
                    w.poisoned = True
                    n += 1
        self.wedged += n
        return n

    def recover_dead(self) -> int:
        """Re-queue (at the FRONT) every job stranded in _executing by a
        dead or poisoned worker. The stranded job's cancel token fires —
        a wedged worker's eventual result is a late duplicate — and a
        CLONE carries the row forward, so the orphan object's untracked
        ``_finish`` can never decrement counts twice or double-deliver."""
        with self._env_cond:
            gone = {w.worker_id for w in self._workers
                    if not w.is_alive() or w.poisoned}
            stranded = [j for j in self._executing.values()
                        if j.worker in gone]
            for job in stranded:
                self._executing.pop(id(job), None)
                n = self._inflight.get(job.task_id, 0) - 1
                if n > 0:
                    self._inflight[job.task_id] = n
                else:
                    self._inflight.pop(job.task_id, None)
                cancelled = job.cancelled
                job.cancel.cancel()
                if cancelled:
                    continue     # row already finished (timeout/abort)
                clone = EnvJob(row=job.row, query=job.query,
                               task_id=job.task_id, latency=0.0,
                               submitted_at=job.submitted_at,
                               attempts=job.attempts, flow=job.flow,
                               chaos_transient_left=job.chaos_transient_left,
                               chaos_permanent=job.chaos_permanent)
                self._queue.appendleft(clone)
                self.recovered += 1
            self._env_cond.notify_all()
            return len(stranded)

    def halt(self, timeout_s: float = 30.0):
        """Stop the workers. Queued jobs are cancelled outright — without
        this, workers would drain the whole backlog (latency sleeps
        included) for discarded results before noticing the stop flag,
        stalling the caller's join for the queue's worth of env latency.
        The join goes through ``join_or_raise``: a wedged worker dumps
        every thread's stack and raises instead of silently leaking."""
        self._stop.set()
        with self._env_cond:
            for job in self._queue:
                job.cancel.cancel()
            self._queue.clear()
            # wake executing workers out of their latency sleeps too —
            # their results were going to be discarded anyway
            for job in self._executing.values():
                job.cancel.cancel()
            self._env_cond.notify_all()
        join_or_raise([w for w in self._workers if w.is_alive()],
                      timeout_s=timeout_s)
        self._workers = []

    # -- engine side ------------------------------------------------------
    def submit(self, row, query: List[int], task_id: str,
               latency: float) -> EnvJob:
        """Park one episode: enqueue its tool call for the worker pool."""
        job = EnvJob(row=row, query=query, task_id=task_id, latency=latency,
                     submitted_at=time.monotonic())
        if not self._workers:
            self._ensure_workers()   # lazy first start / post-halt restart;
                                     # mid-run respawns are the supervisor's
                                     # (backoff-gated, work recovered first)
        with self._env_cond:
            self._queue.append(job)
            self._env_cond.notify()
        return job

    def drain_resolved(self) -> List[EnvJob]:
        """Pop every completed (non-cancelled) response."""
        out: List[EnvJob] = []
        with self._env_cond:
            while self._done:
                out.append(self._done.popleft())
        return out

    def expire(self, now: float, timeout_s: float) -> List[EnvJob]:
        """Time out jobs older than `timeout_s`: queued jobs are cancelled
        outright (they never burn a worker); executing jobs are flagged so
        the worker's late result is discarded. Returns the expired jobs —
        the engine evicts their rows with finish_reason tool_timeout."""
        expired: List[EnvJob] = []
        with self._env_cond:
            keep: Deque[EnvJob] = deque()
            for job in self._queue:
                if now - job.submitted_at > timeout_s:
                    job.cancel.cancel()
                    expired.append(job)
                else:
                    keep.append(job)
            self._queue = keep
            for job in self._executing.values():
                if not job.cancelled and now - job.submitted_at > timeout_s:
                    job.cancel.cancel()
                    expired.append(job)
        self.timeouts += len(expired)
        return expired

    def cancel_tenant(self, task_id: str) -> List[EnvJob]:
        """Quarantine/abort one tenant: cancel its queued + executing jobs
        and return them — the engine completes their rows (aborted), and
        executing workers' late results drop on the cancelled flag."""
        out: List[EnvJob] = []
        with self._env_cond:
            keep: Deque[EnvJob] = deque()
            for job in self._queue:
                if job.task_id == task_id:
                    job.cancel.cancel()
                    out.append(job)
                else:
                    keep.append(job)
            self._queue = keep
            for job in self._executing.values():
                if job.task_id == task_id and not job.cancelled:
                    job.cancel.cancel()
                    out.append(job)
            keep_done: Deque[EnvJob] = deque()
            for job in self._done:
                if job.task_id == task_id:
                    job.cancel.cancel()
                    out.append(job)
                else:
                    keep_done.append(job)
            self._done = keep_done
        return out

    def cancel_all(self) -> List[EnvJob]:
        """Abort path (engine drain deadline / shutdown): cancel every
        queued and executing job; returns them for abort accounting."""
        with self._env_cond:
            out = [j for j in self._queue]
            out += list(self._executing.values())
            for j in out:
                j.cancel.cancel()
            self._queue.clear()
            # late worker results are dropped by the cancelled flag;
            # already-resolved-but-undrained responses abort too
            while self._done:
                j = self._done.popleft()
                j.cancel.cancel()
                out.append(j)
        return out

    # -- worker side ------------------------------------------------------
    def _chaos_tool_fault(self, job: EnvJob):
        """Injected tool failures (worker thread). One decision per job at
        its first attempt: permanent beats transient; a transient hit
        fails ``transient_fail_count`` consecutive attempts then lets the
        real call through (retry-then-succeed, bit-identical stream)."""
        chaos = self.chaos
        if chaos is None:
            return
        if (job.attempts == 0 and not job.chaos_permanent
                and job.chaos_transient_left == 0):
            if chaos.fire("tool_error_permanent"):
                job.chaos_permanent = True
            elif chaos.fire("tool_error_transient"):
                job.chaos_transient_left = chaos.cfg.transient_fail_count
        if job.chaos_permanent:
            raise PermanentToolError(
                f"chaos: tool endpoint down for {job.task_id}")
        if job.chaos_transient_left > 0:
            job.chaos_transient_left -= 1
            raise TransientToolError("chaos: transient tool failure")

    def _schedule_retry(self, job: EnvJob) -> bool:
        """Queue-side retry with exponential backoff + jitter. False once
        the per-call (``retry_max``) or per-episode
        (``retry_episode_cap``) budget is spent or the job is cancelled —
        the caller then fails the row. The executing slot is released
        immediately: the backoff costs no worker time."""
        if job.cancelled or job.attempts > self.retry_max:
            return False
        row = job.row
        used = getattr(row, "tool_retries", 0)
        if self.retry_episode_cap and used >= self.retry_episode_cap:
            return False
        backoff = min(self.retry_max_s,
                      self.retry_base_s * (2 ** (job.attempts - 1)))
        with self._env_cond:
            try:
                row.tool_retries = used + 1
            except AttributeError:
                pass      # non-engine row objects (unit tests) without the
                          # slot: per-call cap still bounds the retries
            self.retries += 1
            self._executing.pop(id(job), None)
            n = self._inflight.get(job.task_id, 0) - 1
            if n > 0:
                self._inflight[job.task_id] = n
            else:
                self._inflight.pop(job.task_id, None)
            job.state = "queued"
            job.not_before = time.monotonic() + backoff * (
                1.0 + 0.25 * self._rng.random())
            self._queue.append(job)
            self._env_cond.notify_all()
        return True

    def _pop_eligible(self, worker: Optional[EnvWorker] = None
                      ) -> Optional[EnvJob]:
        """Oldest queued job whose tenant is under the in-flight cap,
        not cancelled, and past its retry backoff. Blocks on the stage
        condition until work or stop. The worker's id lands on the job
        INSIDE the lock — ownership is never observable half-assigned
        (recover_dead keys stranded jobs by it)."""
        with self._env_cond:
            while True:
                if self._stop.is_set():
                    return None
                cap = self.max_inflight_per_tenant
                now = time.monotonic()
                for i, job in enumerate(self._queue):
                    if job.not_before and now < job.not_before:
                        continue
                    if cap and self._inflight.get(job.task_id, 0) >= cap:
                        continue
                    del self._queue[i]
                    job.state = "executing"
                    job.started_at = now
                    if worker is not None:
                        job.worker = worker.worker_id
                    self._executing[id(job)] = job
                    self._inflight[job.task_id] = (
                        self._inflight.get(job.task_id, 0) + 1)
                    self.calls += 1
                    return job
                if self._stop.is_set():
                    return None
                self._env_cond.wait(timeout=0.05)

    def _finish(self, job: EnvJob, response: List[int]):
        with self._env_cond:
            # a job recover_dead already re-queued (as a clone) is
            # UNTRACKED here: a wedged worker limping in late must not
            # decrement counts twice or deliver a duplicate response
            tracked = self._executing.pop(id(job), None) is not None
            if tracked:
                n = self._inflight.get(job.task_id, 0) - 1
                if n > 0:
                    self._inflight[job.task_id] = n
                else:
                    self._inflight.pop(job.task_id, None)
            job.state = "done"
            job.resolved_at = time.monotonic()
            job.response = response
            if tracked and not job.cancelled:
                self._done.append(job)
            # a freed tenant cap slot may unblock a queued sibling
            self._env_cond.notify_all()

    # -- introspection ----------------------------------------------------
    def _live_executing(self) -> List[EnvJob]:  # held: _cond
        """Executing jobs whose row is still in flight. A cancelled job's
        row already completed (tool_timeout/abort) — the worker is merely
        riding out an uninterruptible call whose result will be discarded,
        so it must not keep the engine non-idle or pin the tenant."""
        return [j for j in self._executing.values() if not j.cancelled]

    def depths(self) -> Tuple[int, int]:
        """(queued, executing) — the env stage's two queue depths."""
        with self._env_cond:
            return len(self._queue), len(self._live_executing())

    def count(self) -> int:
        """Rows anywhere in the stage (queued + executing + resolved but
        not yet drained) — feeds the engine's queued()/idle() accounting."""
        with self._env_cond:
            return (len(self._queue) + len(self._live_executing())
                    + len(self._done))

    def tenants(self) -> frozenset:
        with self._env_cond:
            return (frozenset(j.task_id for j in self._queue)
                    | frozenset(j.task_id for j in self._live_executing())
                    | frozenset(j.task_id for j in self._done))

    def rows_for(self, task_id: str) -> List[object]:
        with self._env_cond:
            jobs = ([j for j in self._queue if j.task_id == task_id]
                    + [j for j in self._live_executing()
                       if j.task_id == task_id]
                    + [j for j in self._done if j.task_id == task_id])
        return [j.row for j in jobs]
