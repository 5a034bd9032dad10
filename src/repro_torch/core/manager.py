"""The multi-task manager M (paper §4.2) — the centre of MARLaaS.

Maintains, per task t: LoRA parameters θ_t^(v), optimizer state φ_t^(v) and
the version counter v; plus the trajectory hand-off between the rollout and
training stages. Two trainer feeds exist:

- **Round-synchronous baseline** (``async_mode=False``): the global FIFO
  buffer Q_buffer of full ``TrajectoryBatch`` rounds. ``next_policy(t)``
  yields a given version exactly once, and with the default
  ``max_staleness=0`` the enqueue/commit admission checks reduce to the
  paper's strict per-task on-policy invariant: the rollout engine only
  generates from the latest committed version and an update is only
  accepted for the exact version its trajectories were generated under.

- **Event-driven off-policy feed** (``async_mode=True``): the
  rollout side streams individual completed episodes in via
  ``enqueue_episode`` the moment each row evicts; episodes buffer until
  their GRPO group (``group_size`` same-prompt rows) is complete, then the
  group joins the tenant's ready queue. The trainer drains complete groups
  at its own pace through ``pop_episodes`` and packs micro-batches as soon
  as the tenant's ``min_train_rows`` threshold is met. Staleness is
  bounded: ``next_policy`` may issue up to ``max_staleness + 1`` rollout
  rounds per committed version (so decode never drains between commits),
  and both enqueue and pop apply a drop-or-train admission check — a
  group whose behaviour version lags the committed version by more than
  ``max_staleness`` is dropped and counted, never trained.

Thread-safe: the real runtime drives it from rollout/train threads; the
simulator drives it single-threaded in virtual time. All timestamps come
through the injected `clock` so both modes share metric definitions.

A copy of ``repro.core.manager`` on the port's ``TrajectoryBatch``. The
manager holds each tenant's adapter and optimizer trees (torch tensors) by
reference and never copies or mutates them: a commit replaces the tree.
Its lock and condition are named ``_mgr_lock`` and ``_mgr_cv`` (the JAX
package's are ``_lock`` and ``_cv``), for the lock analyzer, which names a
lock by class and attribute.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from repro_torch.rl.types import TrajectoryBatch


@dataclass
class TaskSpec:
    task_id: str
    env_name: str
    group_size: int = 4
    num_groups: int = 2            # groups per rollout batch
    max_new_tokens: int = 16
    target_steps: int = 20         # requested train steps
    temperature: float = 1.0
    lr: float = 3e-3
    priority: int = 0              # scheduler/preemption tier (higher wins)

    @property
    def rows_per_batch(self) -> int:
        return self.group_size * self.num_groups


@dataclass
class TaskState:
    spec: TaskSpec
    adapters: Any = None            # θ_t^(v)
    opt_state: Any = None           # φ_t^(v)
    version: int = 0
    steps_done: int = 0
    status: str = "pending"         # pending|admitted|preempted|
                                    # quarantined|finished
    rollout_issued_version: int = -1   # highest v handed to the rollout engine
    rounds_issued_for_version: int = 0  # rollout rounds issued under the
                                        # CURRENT version (async staleness
                                        # window; reset on commit)
    rollout_inflight_rows: int = 0     # rows currently resident/queued in the
                                       # continuous engine for this task
    rollout_rows_total: int = 0        # lifetime rows streamed through slots
    stale_rows_dropped: int = 0        # rows refused by the staleness window
    failed_rows: int = 0               # episodes lost to permanent tool
                                       # errors (incl. poisoned-group
                                       # siblings) — counted, never trained
    quarantine_dropped_rows: int = 0   # rows drained while the tenant's
                                       # circuit breaker was open
    abandoned: bool = False            # breaker gave up (trips > max_trips):
                                       # terminal — the run finishes without
                                       # this tenant reaching target_steps
    adapter_slot: Optional[int] = None  # stacked-LoRA slot while resident
    adapter_installs: int = 0          # times the adapter was (re)installed
    preempt_count: int = 0             # admission-driven preemptions suffered
    submitted_at: float = 0.0
    admitted_at: float = 0.0
    first_step_at: Optional[float] = None
    last_step_at: Optional[float] = None
    step_times: List[float] = field(default_factory=list)
    reward_history: List[float] = field(default_factory=list)

    @property
    def done(self) -> bool:
        return self.abandoned or self.steps_done >= self.spec.target_steps


@dataclass
class EpisodeGroup:
    """One complete GRPO group (``group_size`` same-prompt episodes) ready
    to train, as assembled by ``enqueue_episode``. ``version`` is the
    newest behaviour version among the rows (rows are stamped per-row at
    sample time and the stamp survives park/preempt/resume)."""
    task_id: str
    version: int
    rows: List[Any]                # RolloutCompletion-likes, submit order
    seq: int = 0                   # manager-global assembly order (FIFO key)


class MultiTaskManager:
    def __init__(self, clock: Callable[[], float] = None, *,
                 max_staleness: int = 0, min_train_rows: int = 0,
                 async_mode: bool = False):
        import time
        self.clock = clock or time.monotonic
        self.async_mode = async_mode
        self.max_staleness = max_staleness
        self.min_train_rows = min_train_rows
        self.tasks: Dict[str, TaskState] = {}
        self.q_buffer: Deque[TrajectoryBatch] = deque()
        # per-tenant ready queues of complete GRPO groups (async feed) and
        # the partially-assembled groups still waiting for sibling rows
        self.episodes: Dict[str, Deque[EpisodeGroup]] = {}
        self._partial: Dict[Tuple[str, Any], List[Any]] = {}
        self._ep_seq = 0
        # popped-but-uncommitted train work: a trainer crash between pop and
        # commit must not lose the rows (the rollout side already consumed
        # its issue budget for that version — losing them wedges the tenant)
        self._inflight_train: List[Tuple] = []
        # staleness-window drop accounting (drop-or-train decisions)
        self.stale_rows_dropped = 0
        self.stale_groups_dropped = 0
        self.stale_batches_dropped = 0
        self.discarded_tail_rows = 0   # rows arriving after their task done
        # fault accounting: with these two, the conservation invariant
        # extends to completed == trained + stale_dropped + discarded_tails
        # + failed + quarantine_dropped — no episode is ever silently lost
        self.failed_rows = 0           # permanent tool errors + poisoned-
                                       # group siblings
        self.quarantine_dropped_rows = 0
        # rows committed by the trainer (runtime increments on commit);
        # lives here rather than on the runtime so it serializes with the
        # checkpoint manifest and the invariant survives a restart
        self.rows_trained = 0
        # completed rows lost to a checkpoint restart (their round had no
        # serialized batch/group, so it regenerates); load_checkpoint
        # computes this so the invariant stays exact across incarnations
        self.orphaned_rows = 0
        # GRPO groups poisoned by a failed episode: a group missing a row
        # can never train, so late siblings count failed instead of
        # buffering in _partial forever
        self._failed_groups: set = set()
        # optional episode tracer: drop-or-train decisions are
        # terminal lifecycle events — a dropped episode must not look like
        # one still waiting for the trainer
        self.tracer = None
        self._mgr_lock = threading.RLock()  # guards: tasks/q_buffer/episodes
        self._mgr_cv = threading.Condition(self._mgr_lock)

    def _trace_drop(self, episodes, reason: str) -> None:
        tr = self.tracer
        if tr is None:
            return
        t = tr.now()
        for ep in episodes:
            meta = getattr(ep, "meta", None)
            trace = meta.get("trace_id") if isinstance(meta, dict) else None
            if trace is not None:
                tr.mark(trace, "dropped", t)
                tr.instant(("manager", "queue"), reason, t, trace=trace)

    # -- task lifecycle -------------------------------------------------
    def submit(self, spec: TaskSpec, adapters=None, opt_state=None) -> TaskState:
        with self._mgr_lock:
            st = TaskState(spec=spec, adapters=adapters, opt_state=opt_state,
                           submitted_at=self.clock())
            self.tasks[spec.task_id] = st
            self._mgr_cv.notify_all()
            return st

    def admit(self, task_id: str):
        with self._mgr_lock:
            st = self.tasks[task_id]
            if st.status == "pending":
                st.status = "admitted"
                st.admitted_at = self.clock()
                self._mgr_cv.notify_all()

    # -- admission-driven preemption (paper §4.3) -------------------------
    def preempt(self, task_id: str) -> bool:
        """Mark an admitted task preempted: it issues no NEW rollout rounds
        (next_policy returns None) while its already-queued rows replay at
        the engine's leisure. Returns True if the state changed."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            if st.status != "admitted" or st.done:
                return False
            st.status = "preempted"
            st.preempt_count += 1
            self._mgr_cv.notify_all()
            return True

    def readmit(self, task_id: str) -> bool:
        with self._mgr_lock:
            st = self.tasks[task_id]
            if st.status != "preempted":
                return False
            st.status = "finished" if st.done else "admitted"
            self._mgr_cv.notify_all()
            return True

    # -- stacked-LoRA residency (LRU eviction bookkeeping) ----------------
    def adapter_bound(self, task_id: str, slot: int):
        with self._mgr_lock:
            st = self.tasks[task_id]
            st.adapter_slot = slot
            st.adapter_installs += 1

    def adapter_unbound(self, task_id: str):
        with self._mgr_lock:
            self.tasks[task_id].adapter_slot = None

    def resident_adapters(self) -> Dict[str, int]:
        with self._mgr_lock:
            return {tid: st.adapter_slot for tid, st in self.tasks.items()
                    if st.adapter_slot is not None}

    # -- Algorithm 1, line 5: M.next_policy(t) ---------------------------
    def _can_issue(self, st: TaskState) -> bool:   # held: _mgr_lock
        """Whether a rollout round may be issued for `st` right now.

        Sync: each committed version is handed out exactly once (the strict
        on-policy invariant). Async: up to ``max_staleness + 1`` rounds per
        committed version AND no more than that many rounds' worth of rows
        outstanding anywhere in the pipeline (engine + ready/partial queues
        + popped-but-uncommitted train work) — the trainer's commit rate is
        the backpressure that paces rollout — AND never more rows than the
        task's remaining train steps can consume."""
        if not self.async_mode:
            return st.rollout_issued_version < st.version
        window = self.max_staleness + 1
        if st.rounds_issued_for_version >= window:
            return False
        rpb = st.spec.rows_per_batch
        outstanding = (st.rollout_inflight_rows
                       + self._queued_rows(st.spec.task_id))
        if outstanding + rpb > rpb * window:
            return False
        # lifetime-demand cap: pipelining past the LAST useful commit only
        # decodes rows that are discarded as tails at shutdown — stop
        # issuing once the rows already in flight cover every train step
        # the task has left (rounds are the issuance quantum, so compare
        # against outstanding alone: a round may overshoot the tail of the
        # demand by up to rpb - 1 rows, never by a whole round)
        need = ((st.spec.target_steps - st.steps_done)
                * self.train_threshold(st.spec))
        return outstanding < need

    def _queued_rows(self, task_id: str) -> int:   # held: _mgr_lock
        n = sum(len(g.rows) for g in self.episodes.get(task_id, ()))
        n += sum(len(rows) for (tid, _), rows in self._partial.items()
                 if tid == task_id)
        for item in self._inflight_train:
            if item[0] == "episodes" and item[1] == task_id:
                n += sum(len(g.rows) for g in item[2])
        return n

    def next_policy(self, task_id: str):
        """Return (version, adapters) if a rollout round may be generated
        for this task, else None. Sync mode hands each version out ONCE;
        async mode issues up to ``max_staleness + 1`` rounds per version
        (bounded-staleness pipelining)."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            if st.status != "admitted" or st.done:
                return None
            if not self._can_issue(st):
                return None
            st.rollout_issued_version = st.version
            st.rounds_issued_for_version += 1
            return st.version, st.adapters

    def rollout_ready_tasks(self) -> List[str]:
        with self._mgr_lock:
            return [tid for tid, st in self.tasks.items()
                    if st.status == "admitted" and not st.done
                    and self._can_issue(st)]

    # -- continuous-rollout occupancy (slot engine) -----------------------
    def rollout_started(self, task_id: str, rows: int):
        """The streaming worker handed `rows` requests for this task to the
        slot engine (they are queued or resident until completion)."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            st.rollout_inflight_rows += rows
            st.rollout_rows_total += rows

    def rollout_row_done(self, task_id: str):
        with self._mgr_lock:
            st = self.tasks[task_id]
            st.rollout_inflight_rows = max(0, st.rollout_inflight_rows - 1)

    def inflight_rows(self) -> Dict[str, int]:
        with self._mgr_lock:
            return {tid: st.rollout_inflight_rows
                    for tid, st in self.tasks.items()
                    if st.rollout_inflight_rows > 0}

    # -- Algorithm 1, line 8: enqueue (round-synchronous feed) -------------
    def enqueue(self, batch: TrajectoryBatch) -> bool:
        """Admit a full rollout round into Q_buffer, subject to the
        staleness window: a batch whose behaviour version lags the
        committed version by more than ``max_staleness`` (0 = the paper's
        strict on-policy invariant) is dropped and counted, never trained.
        Returns whether the batch was admitted."""
        with self._mgr_lock:
            st = self.tasks[batch.task_id]
            lag = st.version - batch.version
            if lag < 0:
                raise ValueError(
                    f"task {batch.task_id} batch v{batch.version} is newer "
                    f"than committed v{st.version}")
            if st.status == "quarantined":
                self.quarantine_dropped_rows += batch.num_rows
                st.quarantine_dropped_rows += batch.num_rows
                return False
            if st.done or lag > self.max_staleness:
                self.stale_batches_dropped += 1
                self.stale_rows_dropped += batch.num_rows
                st.stale_rows_dropped += batch.num_rows
                return False
            self.q_buffer.append(batch)
            self._mgr_cv.notify_all()
            return True

    # -- Algorithm 1, line 13: pop (global FIFO) --------------------------
    def pop_batch(self, timeout: Optional[float] = None) -> Optional[TrajectoryBatch]:
        """Pop the oldest round, waiting up to `timeout` for one to arrive.

        The wait is a predicate loop (Condition.wait_for re-waits with the
        remaining time after every wake-up): an unrelated ``notify_all``
        (commit, submit, admit, ...) no longer truncates the deadline to
        its first wake. The popped batch is tracked as in-flight until its
        commit — ``recover_inflight`` re-enqueues it if the trainer dies
        in between."""
        with self._mgr_cv:
            if not self.q_buffer and timeout:
                self._mgr_cv.wait_for(lambda: bool(self.q_buffer), timeout)
            if not self.q_buffer:
                return None
            tb = self.q_buffer.popleft()
            self._inflight_train.append(("batch", tb.task_id, tb))
            return tb

    # -- event-driven off-policy feed (async_mode) ------------------------
    def enqueue_episode(self, task_id: str, version: int, group_key,
                        episode) -> bool:
        """One completed rollout episode, stamped with the adapter version
        that generated it. Buffers under `(task_id, group_key)` until all
        ``group_size`` sibling rows arrive, then publishes the complete
        group to the tenant's ready queue. Drop-or-train admission: rows
        for finished tasks and groups beyond the staleness window are
        dropped (with their already-buffered siblings — a group missing a
        row can never train) and counted. Returns whether admitted."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            if st.status == "quarantined":
                buf = self._partial.pop((task_id, group_key), [])
                n = 1 + len(buf)
                self.quarantine_dropped_rows += n
                st.quarantine_dropped_rows += n
                self._trace_drop([episode] + buf, "quarantine_drop")
                return False
            if st.done:
                buf = self._partial.pop((task_id, group_key), [])
                self.discarded_tail_rows += 1 + len(buf)
                self._trace_drop([episode] + buf, "tail_drop")
                return False
            if (task_id, group_key) in self._failed_groups:
                # a sibling already failed: this group can never complete
                self.failed_rows += 1
                st.failed_rows += 1
                self._trace_drop([episode], "failed_drop")
                return False
            lag = st.version - version
            if lag < 0:
                raise ValueError(
                    f"task {task_id} episode v{version} is newer than "
                    f"committed v{st.version}")
            if lag > self.max_staleness:
                buf = self._partial.pop((task_id, group_key), [])
                dropped = 1 + len(buf)
                self.stale_rows_dropped += dropped
                st.stale_rows_dropped += dropped
                self.stale_groups_dropped += 1
                self._trace_drop([episode] + buf, "stale_drop")
                return False
            buf = self._partial.setdefault((task_id, group_key), [])
            buf.append(episode)
            if len(buf) >= st.spec.group_size:
                del self._partial[(task_id, group_key)]
                buf.sort(key=lambda c: getattr(c, "submit_index", 0))
                self._ep_seq += 1
                g = EpisodeGroup(task_id=task_id,
                                 version=max(getattr(c, "version", version)
                                             for c in buf),
                                 rows=buf, seq=self._ep_seq)
                self.episodes.setdefault(task_id, deque()).append(g)
                self._mgr_cv.notify_all()
            return True

    def fail_episode(self, task_id: str, group_key, episode) -> int:
        """One episode finished with a permanent tool error (async feed):
        count it failed, poison its GRPO group (already-buffered siblings
        drop with it; late ones drop on arrival — a group missing a row
        can never train), and return the rows lost."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            buf = self._partial.pop((task_id, group_key), [])
            n = 1 + len(buf)
            self._failed_groups.add((task_id, group_key))
            self.failed_rows += n
            st.failed_rows += n
            self._trace_drop([episode] + buf, "failed_drop")
            return n

    def note_failed(self, task_id: str, n: int = 1):
        """Count rows lost to tool errors outside the async feed (sync
        round assembly books its own group poisoning)."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            self.failed_rows += n
            st.failed_rows += n

    def note_quarantine_dropped(self, task_id: str, n: int = 1):
        """Count rows the engine aborted (or the runtime discarded) while
        the tenant's breaker was open."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            self.quarantine_dropped_rows += n
            st.quarantine_dropped_rows += n

    def round_failed(self, task_id: str):
        """Sync mode: an issued round produced NO trainable rows (every
        episode failed) — re-arm issuance so the tenant isn't wedged
        waiting for a commit that can never come."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            if (st.status == "admitted" and not st.done
                    and st.rollout_issued_version >= st.version):
                st.rollout_issued_version = st.version - 1
                self._mgr_cv.notify_all()

    # -- per-tenant quarantine (circuit breaker) -----------------
    def quarantine(self, task_id: str) -> bool:
        """Breaker tripped open: the tenant issues no new rounds and its
        arriving rows drop (counted) until unquarantined. Other tenants
        are untouched — that isolation is the point."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            if st.status != "admitted" or st.done:
                return False
            st.status = "quarantined"
            self._mgr_cv.notify_all()
            return True

    def unquarantine(self, task_id: str) -> bool:
        """Half-open probe (or full recovery): readmit the tenant and
        re-arm issuance — the quarantined rounds' issue budget was spent
        on drained work, so without the reset the probe round could never
        issue and the breaker would never see an outcome."""
        with self._mgr_lock:
            st = self.tasks.get(task_id)
            if st is None or st.status != "quarantined":
                return False
            st.status = "finished" if st.done else "admitted"
            st.rounds_issued_for_version = 0
            st.rollout_issued_version = st.version - 1
            self._mgr_cv.notify_all()
            return True

    def drain_tenant(self, task_id: str) -> int:
        """Drop one tenant's queued work — ready groups, partial rows,
        buffered sync rounds — with counted drops. Returns rows dropped."""
        with self._mgr_lock:
            return self._drain_tenant_locked(task_id)

    def _drain_tenant_locked(self, task_id: str) -> int:   # held: _mgr_lock
        st = self.tasks[task_id]
        n = 0
        for g in self.episodes.pop(task_id, ()):
            n += len(g.rows)
            self._trace_drop(g.rows, "quarantine_drop")
        for key in [k for k in self._partial if k[0] == task_id]:
            rows = self._partial.pop(key)
            n += len(rows)
            self._trace_drop(rows, "quarantine_drop")
        keep: Deque[TrajectoryBatch] = deque()
        for tb in self.q_buffer:
            if tb.task_id == task_id:
                n += tb.num_rows
            else:
                keep.append(tb)
        self.q_buffer = keep
        self._failed_groups = {k for k in self._failed_groups
                               if k[0] != task_id}
        self.quarantine_dropped_rows += n
        st.quarantine_dropped_rows += n
        return n

    def abandon(self, task_id: str) -> int:
        """Terminal give-up (breaker trips exhausted): drain the tenant's
        queued work and mark it done-without-finishing, so the run can
        complete without it. Returns rows dropped by the drain."""
        with self._mgr_lock:
            st = self.tasks[task_id]
            n = self._drain_tenant_locked(task_id)
            st.abandoned = True
            st.status = "finished"
            self._mgr_cv.notify_all()
            return n

    def train_threshold(self, spec: TaskSpec) -> int:
        """Micro-batch size in rows for one tenant: ``min_train_rows``
        rounded UP to complete GRPO groups (group advantages need all G
        same-prompt rows); 0 = a full round (the synchronous batch size,
        which is what makes ``max_staleness=0`` reduce to the baseline)."""
        if self.min_train_rows <= 0:
            return spec.rows_per_batch
        g = spec.group_size
        return -(-max(self.min_train_rows, g) // g) * g

    def _prune_stale(self) -> None:   # held: _mgr_lock
        """Pop-time drop-or-train decision: discard ready groups whose
        version now lags beyond the window (the trainer advanced while
        they queued), counting every drop."""
        for tid, dq in self.episodes.items():
            st = self.tasks[tid]
            keep: Deque[EpisodeGroup] = deque()
            for g in dq:
                if st.done or st.version - g.version > self.max_staleness:
                    n = len(g.rows)
                    if st.done:
                        self.discarded_tail_rows += n
                        self._trace_drop(g.rows, "tail_drop")
                    else:
                        self.stale_rows_dropped += n
                        st.stale_rows_dropped += n
                        self.stale_groups_dropped += 1
                        self._trace_drop(g.rows, "stale_drop")
                else:
                    keep.append(g)
            self.episodes[tid] = keep

    def _select_ready(self) -> Optional[str]:   # held: _mgr_lock
        """Tenant with a full micro-batch of ready rows, FIFO by oldest
        ready group (assembly order) so no tenant starves."""
        self._prune_stale()
        best, best_seq = None, None
        for tid, dq in self.episodes.items():
            if not dq:
                continue
            st = self.tasks[tid]
            need = self.train_threshold(st.spec)
            if sum(len(g.rows) for g in dq) < need:
                continue
            if best_seq is None or dq[0].seq < best_seq:
                best, best_seq = tid, dq[0].seq
        return best

    def pop_episodes(self, timeout: Optional[float] = None
                     ) -> Optional[Tuple[str, List[EpisodeGroup]]]:
        """Drain one tenant's micro-batch: exactly ``train_threshold``
        rows of complete groups, oldest first (fixed batch shape ⇒ no
        per-step recompile of the train step). Waits up to `timeout`
        on a predicate loop for a tenant to reach its threshold. The
        popped groups are tracked as in-flight until the matching commit
        (``recover_inflight`` restores them after a trainer crash)."""
        with self._mgr_cv:
            tid = self._select_ready()
            if tid is None and timeout:
                self._mgr_cv.wait_for(
                    lambda: self._select_ready() is not None, timeout)
                tid = self._select_ready()
            if tid is None:
                return None
            st = self.tasks[tid]
            need = self.train_threshold(st.spec)
            dq = self.episodes[tid]
            groups: List[EpisodeGroup] = []
            rows = 0
            while dq and rows < need:
                g = dq.popleft()
                groups.append(g)
                rows += len(g.rows)
            self._inflight_train.append(("episodes", tid, groups))
            return tid, groups

    def ready_rows(self, task_id: Optional[str] = None) -> int:
        """Completed-episode rows sitting in ready groups (all tenants or
        one) — the trainer-visible backlog."""
        with self._mgr_lock:
            if task_id is not None:
                return sum(len(g.rows)
                           for g in self.episodes.get(task_id, ()))
            return sum(len(g.rows) for dq in self.episodes.values()
                       for g in dq)

    def partial_rows(self, task_id: Optional[str] = None) -> int:
        """Rows buffered in incomplete GRPO groups (awaiting siblings)."""
        with self._mgr_lock:
            return sum(len(rows) for (tid, _), rows in self._partial.items()
                       if task_id is None or tid == task_id)

    def dispatchable_rows(self) -> int:
        """Rows the trainer could pop RIGHT NOW: whole micro-batches
        (``train_threshold`` multiples of ready complete-group rows) per
        tenant in async mode, assembled rounds in Q_buffer in sync mode.
        This is the backlog stream behind ``trainer_idle_stats`` — rows
        still assembling toward a threshold are NOT dispatchable work (no
        trainer could legally train them), so they never count as time
        the trainer sat on trainable data."""
        with self._mgr_lock:
            if not self.async_mode:
                return sum(tb.num_rows for tb in self.q_buffer)
            n = 0
            for tid, dq in self.episodes.items():
                th = self.train_threshold(self.tasks[tid].spec)
                ready = sum(len(g.rows) for g in dq)
                n += (ready // th) * th
            return n

    def recover_inflight(self) -> int:
        """Re-enqueue popped-but-uncommitted train work at the FRONT of its
        queue — called on trainer-loop (re)entry. Without this, a trainer
        crash between pop and commit silently drops the work while the
        rollout side has already spent its issue budget for that version:
        the tenant deadlocks after restart. Returns items restored."""
        with self._mgr_lock:
            n = len(self._inflight_train)
            for item in reversed(self._inflight_train):
                if item[0] == "batch":
                    self.q_buffer.appendleft(item[2])
                else:
                    dq = self.episodes.setdefault(item[1], deque())
                    for g in reversed(item[2]):
                        dq.appendleft(g)
            self._inflight_train.clear()
            if n:
                self._mgr_cv.notify_all()
            return n

    def rebind_episode_envs(self, envs: Dict[str, object]) -> int:
        """Re-attach live env handles to restored completed episodes
        (checkpointed episodes serialize with ``env=None`` — env objects
        hold RNGs/sessions that don't pickle). Returns rows rebound."""
        n = 0
        with self._mgr_lock:
            for tid, dq in self.episodes.items():
                env = envs.get(tid)
                if env is None:
                    continue
                for g in dq:
                    for c in g.rows:
                        if c.env is None:
                            c.env = env
                            n += 1
        return n

    def _clear_inflight(self, task_id: str) -> None:   # held: _mgr_lock
        """Retire the oldest in-flight train item for `task_id` (its commit
        just landed)."""
        for i, item in enumerate(self._inflight_train):
            if item[1] == task_id:
                del self._inflight_train[i]
                return

    def _purge_task_queues(self, task_id: str) -> None:   # held: _mgr_lock
        """A finished task trains no more: discard its ready groups and
        partial rows (counted — nothing may leak silently), and end their
        traces as dropped. (The JAX manager counts them but leaves their
        traces at `completed`: ROADMAP §3.)"""
        rows = [r for g in self.episodes.pop(task_id, ()) for r in g.rows]
        for key in [k for k in self._partial if k[0] == task_id]:
            rows += self._partial.pop(key)
        self.discarded_tail_rows += len(rows)
        self._trace_drop(rows, "tail_drop")
        self._failed_groups = {k for k in self._failed_groups
                               if k[0] != task_id}

    # -- Algorithm 1, line 15: commit θ,φ^(v+1) ---------------------------
    def commit(self, task_id: str, adapters, opt_state, trained_version: int,
               reward_mean: float = 0.0):
        with self._mgr_lock:
            st = self.tasks[task_id]
            lag = st.version - trained_version
            assert 0 <= lag <= self.max_staleness, (
                f"commit for v{trained_version} but task at v{st.version} "
                f"— outside the max_staleness={self.max_staleness} window")
            st.adapters = adapters
            st.opt_state = opt_state
            st.version += 1
            st.steps_done += 1
            st.rounds_issued_for_version = 0
            self._clear_inflight(task_id)
            now = self.clock()
            if st.first_step_at is None:
                st.first_step_at = now
            st.step_times.append(now)
            st.last_step_at = now
            st.reward_history.append(float(reward_mean))
            if st.done:
                st.status = "finished"
                self._purge_task_queues(task_id)
            self._mgr_cv.notify_all()

    # -- introspection ----------------------------------------------------
    def state(self, task_id: str) -> TaskState:
        """Locked lookup of one task's state (the `tasks` dict is guarded:
        a bare ``mgr.tasks[tid]`` from another thread races `submit`)."""
        with self._mgr_lock:
            return self.tasks[task_id]

    def spec_for(self, task_id: str) -> TaskSpec:
        """Locked spec accessor for the rollout/admission threads."""
        with self._mgr_lock:
            return self.tasks[task_id].spec

    def version_of(self, task_id: str) -> int:
        with self._mgr_lock:
            return self.tasks[task_id].version

    def total_steps_done(self) -> int:
        with self._mgr_lock:
            return sum(st.steps_done for st in self.tasks.values())

    def task_items(self) -> List:
        """Snapshot of (task_id, state) pairs — safe to iterate while other
        threads submit new tasks."""
        with self._mgr_lock:
            return list(self.tasks.items())

    def drop_counters(self) -> Dict[str, int]:
        """Staleness-window accounting (drop-or-train decisions + finished-
        task tails) for the metrics recorder."""
        with self._mgr_lock:
            return {"stale_rows_dropped": self.stale_rows_dropped,
                    "stale_groups_dropped": self.stale_groups_dropped,
                    "stale_batches_dropped": self.stale_batches_dropped,
                    "discarded_tail_rows": self.discarded_tail_rows,
                    "failed_rows": self.failed_rows,
                    "quarantine_dropped_rows": self.quarantine_dropped_rows}

    def all_done(self) -> bool:
        with self._mgr_lock:
            return bool(self.tasks) and all(
                st.done for st in self.tasks.values())

    def active_tasks(self) -> List[str]:
        with self._mgr_lock:
            return [tid for tid, st in self.tasks.items()
                    if st.status == "admitted" and not st.done]

    def pending_tasks(self) -> List[str]:
        with self._mgr_lock:
            return [tid for tid, st in self.tasks.items()
                    if st.status == "pending"]

    def snapshot_versions(self) -> Dict[str, int]:
        with self._mgr_lock:
            return {tid: st.version for tid, st in self.tasks.items()}

    def wait(self, predicate, timeout: float = None) -> bool:
        with self._mgr_cv:
            return self._mgr_cv.wait_for(predicate, timeout)
