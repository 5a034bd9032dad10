"""Real (threaded) MARLaaS runtime: the paper's loop, rollout and GRPO
training as independently scheduled stages on one shared base model (port
of ``repro.core.runtime``).

    submit ──> SlotScheduler queue ──> RolloutWorker thread
                (SRPT/priority/          fused refill (or the splice of
                 starvation order)       worker-prefilled rows) + one decode
                      │   ▲              step over the slot pool, each row
                      │   │ resume job   under its tenant's LoRA adapter
                      ▼   │                   │ completions   │ park on CALL
      PrefillWorker threads   EnvWorker threads ◄─────────────┘
      (disagg_prefill: own    (env_stage: the tool call, then the
       caches and streams)     response re-queues the row)
               Trainer thread  <──────────────┘ (round-synchronous: full
                 PolicyUpdate (LoRA-only       rounds off the FIFO Q_buffer;
                 GRPO), commits v+1            async_train: per-tenant
                                               micro-batches of complete
                                               GRPO groups under a
                                               max_staleness window)

  RolloutWorker thread — streaming (default ``rollout_mode="continuous"``):
    feeds per-task requests into the engine's cross-task queue the moment
    each task's ``next_policy`` version becomes consumable, pumps the
    engine (refill freed slots, one decode step), and routes completions
    to the trainer feed — decode never drains between tenant groups. The
    legacy ``rollout_mode="round"`` fuses one multi-LoRA ``generate()`` per
    round and blocks on its slowest row.
  Trainer thread — pops a round (or, with ``async_train``, a micro-batch of
    complete GRPO groups), runs the task's PolicyUpdate, commits v+1. With
    ``max_staleness=0`` the async trainer reduces token-for-token to the
    round-synchronous one; groups beyond the window are dropped and
    counted, and groups trained at lag ≥ 1 get a truncated importance
    weight (``is_cap``) on the recorded behaviour logprobs.

Scheduling regimes: marlaas (the two threads), multilora_sync (barrier:
fused rollout for all, then train all) and single_disagg (one task at a
time). Per-stage intervals land in the ``MetricsRecorder``; every issued
row's fate is accounted (``row_accounting``). A per-tenant circuit breaker
quarantines a tenant whose episodes keep failing.

The rollout and trainer threads share one card and both launch on the
default stream, so their device work runs in issue order; only the rollout
thread decodes. With ``disagg_prefill`` the prefill workers launch on CUDA
streams of their own beside it (``rollout/prefill.py``), and the decode
step waits for its own stream only; the env workers run no device work.
The engines serve under ``torch.no_grad()`` / ``torch.inference_mode()``,
which are thread-local (each worker thread enters its own), so the trainer
thread keeps autograd. The manager hands the
rollout thread the committed adapter tree by reference; a train step
returns new tensors and ``set_adapters`` copies into the engine's stacked
buffer, so a commit never aliases the tree a decode reads.

``RuntimeConfig.device`` (default "cuda", which raises without a card)
takes the place of the JAX runtime's ``use_kernel``: on the card the
engines run the decode and SGMV kernels and the trainer the
``token_logprob`` kernels; on the CPU every path is the plain version.
With ``paged_kv`` the engine runs the copy-on-write prefix cache by
default, as the JAX runtime does, and admission charges a GRPO group's full
prompt pages once (``prefix_shared``).

Tracing and fault tolerance, as in the JAX runtime: ``trace`` gives every
submission a trace id and sends lifecycle marks and stage spans to
``runtime.tracer`` (``repro_torch.obs``); ``chaos`` builds one
``ChaosInjector`` shared by the engine's stages and the checkpoint store;
``checkpoint_every`` writes an atomic manager snapshot
(``repro_torch.checkpoint``) from the trainer thread after every that many
commits; ``adopt_checkpoint`` restores one into a fresh runtime and
``run_with_recovery`` restarts from the newest one when a run dies.
"""
from __future__ import annotations

import random
import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.bridge import lora_from_jax
from repro_torch.checkpoint.store import (latest_checkpoint, load_checkpoint,
                                          save_checkpoint)
from repro_torch.configs import ModelConfig
from repro_torch.envs.tasks import make_env
from repro_torch.lora.adapters import init_lora
from repro_torch.lora.multilora import AdapterResidency
from repro_torch.models.common import resolve_device, synchronize
from repro_torch.rollout.engine import (ContinuousRolloutEngine, RolloutEngine,
                                        RolloutRequest, to_trajectory_batch)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, batch_from_trajectory,
                                          init_opt_state, make_train_step)
from .admission import AdmissionConfig, AdmissionController
from .chaos import ChaosConfig, ChaosInjector
from .manager import MultiTaskManager, TaskSpec
from .metrics import MetricsRecorder
from .supervisor import (ABANDONED, CLOSED, HALF_OPEN, OPEN,  # noqa: F401
                         TenantBreaker, join_or_raise)


@dataclass
class RuntimeConfig:
    """The JAX runtime's configuration, with ``device`` in place of
    ``use_kernel``."""
    policy: str = "marlaas"           # marlaas | multilora_sync | single_disagg
    rollout_mode: str = "continuous"  # continuous (slot engine) | round (fused)
    max_slots: int = 8                # decode slots in the continuous engine
    max_adapter_slots: int = 8        # stacked-LoRA capacity (tenants resident)
    scheduler: str = "srpt"           # slot-queue pop order: srpt | fifo
    starvation_k: int = 8             # refills before a queued row jumps tiers
    preemption: bool = True           # admission may preempt lower-priority
                                      # tenants' resident rows
    disagg_prefill: bool = False      # async prefill stage (Fig 5): the
                                      # prefills run on worker threads, the
                                      # decode thread only splices; False =
                                      # fused-refill baseline
    prefill_workers: int = 1          # async prefill worker threads
    prefill_chunk: int = 0            # chunked prefill size (0 = whole
                                      # sequence a call); rounded up to 8
    env_stage: bool = False           # disaggregated env-interaction stage:
                                      # rows park on tool calls (slot freed)
                                      # and resume via the prefill path;
                                      # False = freeze-in-slot baseline
    env_workers: int = 2              # env-interaction worker threads
    env_inflight_per_tenant: int = 0  # max concurrent tool calls per tenant
                                      # in the env stage (0 = uncapped)
    max_turns: int = 0                # per-episode tool-turn budget applied
                                      # to every request (0 = env default)
    paged_kv: bool = False            # paged KV-cache block pool: attention
                                      # K/V in shared fixed-size pages + per-
                                      # slot block tables instead of a dense
                                      # [slots, max_len] cache
    kv_page_size: int = 16            # tokens per KV page (max_len must be
                                      # a multiple of it)
    kv_pool_pages: int = 0            # pool size in pages (0 = the dense-
                                      # equivalent max_slots × max_len/page)
    resume_restore: bool = True       # paged only: preemption snapshots KV
                                      # pages to host and resume splices them
                                      # back (no prefill replay)
    snapshot_budget_bytes: int = 0    # host bytes for snapshots (0 = no cap)
    prefix_cache: bool = True         # paged only: the COW prefix cache
    async_train: bool = False         # event-driven off-policy trainer;
                                      # False = round-synchronous baseline
    max_staleness: int = 1            # bounded staleness window (versions);
                                      # 0 reduces token-for-token to the
                                      # synchronous baseline
    min_train_rows: int = 0           # micro-batch threshold in rows
                                      # (rounded UP to complete GRPO groups;
                                      # 0 = a full round)
    is_cap: float = 2.0               # decoupled-PPO importance-weight
                                      # truncation for stale micro-batches
                                      # (active only when async_train and
                                      # max_staleness > 0)
    max_len: int = 96
    device: str = "cuda"              # where the engines and the trainer run
    seed: int = 0
    rollout_pool_devices: int = 1     # metric bookkeeping
    train_pool_devices: int = 1
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 0         # commits between snapshots (0 = off)
    env_threads: int = 4
    trace: bool = False               # end-to-end episode tracing: every
                                      # submission gets a trace id and
                                      # per-stage lifecycle marks + track
                                      # spans land in `runtime.tracer`
                                      # (repro_torch.obs); off by default —
                                      # the hot loops then carry only an
                                      # `is None` check
    trace_capacity: int = 1_000_000   # tracer ring-buffer size (events);
                                      # overflow drops oldest and counts
    chaos: Optional[ChaosConfig] = None   # deterministic fault injection:
                                      # seeded per-site streams kill stage
                                      # workers, fail tool calls, drop
                                      # snapshots, tear checkpoints — None
                                      # = no injector object at all
    tool_retry_max: int = 3           # per-tool-call transient retries
                                      # (exponential backoff + jitter on the
                                      # env-stage queue, no worker blocked)
    tool_retry_base_s: float = 0.05   # first-retry backoff
    tool_retry_max_s: float = 2.0     # backoff ceiling
    tool_retry_episode_cap: int = 0   # total retries per episode across its
                                      # turns (0 = uncapped)
    supervisor_wedge_s: float = 0.0   # env worker with no heartbeat for
                                      # this long while executing is poisoned
                                      # and replaced (0 = liveness only)
    breaker_fail_threshold: int = 5   # consecutive tool-error episodes that
                                      # trip a tenant's circuit breaker open
    breaker_cooldown_s: float = 2.0   # open -> half-open probe delay
    breaker_max_trips: int = 3        # re-trips before the tenant is
                                      # abandoned (drained + marked done)
    checkpoint_keep_last: int = 0     # snapshot retention (0 = keep all)


class FailureInjector:
    """Crashes the trainer after N commits (tests restart-from-checkpoint).

    `fail_point="pre_commit"` instead kills the trainer BETWEEN pop and
    commit of what would be the Nth commit — the window where a popped
    batch used to be lost silently (the manager's in-flight tracking +
    `recover_inflight` is the fix under test)."""

    def __init__(self, fail_after_commits: Optional[int] = None,
                 fail_point: str = "post_commit"):
        assert fail_point in ("post_commit", "pre_commit")
        self.fail_after = fail_after_commits
        self.fail_point = fail_point
        self.commits = 0

    def on_train(self):
        """Called by the trainer after pop, before commit."""
        if (self.fail_point == "pre_commit" and self.fail_after is not None
                and self.commits + 1 >= self.fail_after):
            self.fail_after = None     # one-shot: the restart must succeed
            raise RuntimeError("injected node failure (pre-commit)")

    def on_commit(self):
        self.commits += 1
        if (self.fail_point == "post_commit" and self.fail_after is not None
                and self.commits >= self.fail_after):
            raise RuntimeError("injected node failure")


class MARLaaSRuntime:
    def __init__(self, cfg: ModelConfig, base_params, rcfg: RuntimeConfig,
                 acfg: Optional[AdmissionConfig] = None,
                 train_cfg: Optional[TrainConfig] = None,
                 failure: Optional[FailureInjector] = None):
        self.device = resolve_device(rcfg.device)
        self.cfg = cfg
        self.base_params = base_params
        self.rcfg = rcfg
        self.acfg = acfg or AdmissionConfig(memory_budget_bytes=1e9,
                                            strict=False)
        if rcfg.paged_kv:
            # page-granular admission accounting rides the paged engine
            # (copy, never mutate a caller-shared config object);
            # group-shared prompt charging where the engine shares pages
            # (the port's families are all pure attention)
            import dataclasses as _dc
            self.acfg = _dc.replace(
                self.acfg, paged=True, page_size=rcfg.kv_page_size,
                prefix_shared=(rcfg.prefix_cache
                               and cfg.family not in ("ssm", "hybrid")))
        if rcfg.async_train and rcfg.rollout_mode != "continuous":
            raise ValueError("async_train requires rollout_mode='continuous' "
                             "(the event-driven trainer consumes the slot "
                             "engine's completion stream)")
        self.mgr = MultiTaskManager(
            max_staleness=rcfg.max_staleness if rcfg.async_train else 0,
            min_train_rows=rcfg.min_train_rows,
            async_mode=rcfg.async_train)
        self.admission = AdmissionController(cfg, self.acfg)
        self.rec = MetricsRecorder({"rollout": rcfg.rollout_pool_devices,
                                    "train": rcfg.train_pool_devices})
        self.tracer = None
        if rcfg.trace:
            from repro_torch.obs import Tracer
            self.tracer = Tracer(capacity=rcfg.trace_capacity)
        self.mgr.tracer = self.tracer      # staleness/tail drops mark traces
        self.engine = RolloutEngine(cfg, base_params, max_len=rcfg.max_len,
                                    seed=rcfg.seed, device=self.device)
        self.envs: Dict[str, object] = {}
        self.datagens: Dict[str, random.Random] = {}
        # stored as the JAX runtime stores it: the trainer builds its
        # TrainConfig in _tc and does not read it
        self._train_cfg_base = train_cfg or TrainConfig()
        self._train_steps: Dict[int, object] = {}   # group_size -> step fn
        self._tool_pool = ThreadPoolExecutor(max_workers=rcfg.env_threads)
        # deterministic chaos: one injector shared by every stage (engine
        # worker kills, env-stage tool faults, snapshot drops) and the
        # checkpoint store (torn publishes)
        self.chaos: Optional[ChaosInjector] = (
            ChaosInjector(rcfg.chaos)
            if rcfg.chaos is not None and rcfg.chaos.enabled else None)
        self.cengine = ContinuousRolloutEngine(
            cfg, base_params, max_slots=rcfg.max_slots,
            max_adapters=rcfg.max_adapter_slots, max_len=rcfg.max_len,
            seed=rcfg.seed, tool_executor=self._tool_pool,
            scheduler=rcfg.scheduler, starvation_k=rcfg.starvation_k,
            disagg_prefill=rcfg.disagg_prefill,
            prefill_chunk=rcfg.prefill_chunk,
            prefill_workers=rcfg.prefill_workers,
            env_stage=rcfg.env_stage, env_workers=rcfg.env_workers,
            env_inflight_per_tenant=rcfg.env_inflight_per_tenant,
            tool_retry_max=rcfg.tool_retry_max,
            tool_retry_base_s=rcfg.tool_retry_base_s,
            tool_retry_max_s=rcfg.tool_retry_max_s,
            tool_retry_episode_cap=rcfg.tool_retry_episode_cap,
            paged_kv=rcfg.paged_kv, kv_page_size=rcfg.kv_page_size,
            kv_pool_pages=rcfg.kv_pool_pages,
            resume_restore=rcfg.resume_restore,
            snapshot_budget_bytes=rcfg.snapshot_budget_bytes,
            prefix_cache=rcfg.prefix_cache, on_stage=self._on_stage,
            tracer=self.tracer, chaos=self.chaos,
            supervise_wedge_s=rcfg.supervisor_wedge_s, device=self.device)
        # ONE source of truth for counters: summarize() merges the engine's
        # RolloutStats int fields with the recorder's explicit counters
        self.rec.attach_rollout_stats(self.cengine.stats)
        # LRU tenant -> stacked-LoRA slot map (rollout thread only). The
        # device write happens in _feed_continuous once the consumable
        # version is known (and only when it changed), so the residency's
        # own install hook is a no-op slot assignment.
        self.residency = AdapterResidency(
            rcfg.max_adapter_slots, lambda slot, tree: None,
            on_evict=self._on_adapter_evict)
        self._resident_version: Dict[str, int] = {}   # tenant -> installed v
        # admission-driven preemptions requested by the admission thread,
        # executed on the rollout thread (the engine is single-threaded)
        self._preempt_q: deque = deque()
        # victim decode progress observed at preemption (rollout thread
        # writes, admission tick reads): feeds the remaining-budget-aware
        # readmission re-estimate
        self._preempt_progress: Dict[str, float] = {}
        # per-tenant round counter: GRPO group identity for the episode
        # queue is (round, group-within-round) — rollout thread only
        self._round_seq: Dict[str, int] = {}
        # cumulative completed row count (rollout thread only; the
        # trained-row twin lives on the manager — mgr.rows_trained)
        self._rows_completed = 0
        # per-tenant circuit breaker: tool-error episodes are the failure
        # signal, natural finishes the success signal; transitions are
        # applied on the rollout thread (the only thread that may touch the
        # engine), admission-side effects queued to the admission tick
        self.breaker: Optional[TenantBreaker] = (
            TenantBreaker(fail_threshold=rcfg.breaker_fail_threshold,
                          cooldown_s=rcfg.breaker_cooldown_s,
                          max_trips=rcfg.breaker_max_trips)
            if rcfg.rollout_mode == "continuous" else None)
        # quarantine/readmit/abandon byte accounting requested by the
        # rollout thread, executed by the admission tick
        self._quarantine_admission_q: deque = deque()
        # sync mode: failed-row counts per issued round (tid, version) — a
        # round missing rows can never pack, so its completion check is
        # len(batch) + failed >= rows_per_batch (rollout thread only)
        self._sync_failed: Dict[tuple, int] = {}
        self._stop = threading.Event()
        self.failure = failure
        self.error: Optional[BaseException] = None

    # -- task submission ---------------------------------------------------
    def submit_task(self, spec: TaskSpec, adapters=None, opt_state=None):
        """Register a tenant. Default adapters come from the port's
        ``init_lora`` (other numbers than the JAX package's for the same
        seed: parity tests pass both packages the same trees)."""
        if adapters is None:
            gen = torch.Generator(device=self.device).manual_seed(
                hash(spec.task_id) % (2 ** 31))
            adapters = init_lora(self.cfg, gen, self.device)
        tc = self._tc(spec)
        if opt_state is None:
            opt_state = init_opt_state(self.cfg, tc, self.base_params, adapters)
        self.mgr.submit(spec, adapters, opt_state)
        self.envs[spec.task_id] = make_env(spec.env_name)
        self.datagens[spec.task_id] = random.Random(
            hash((self.rcfg.seed, spec.task_id)) % (2 ** 31))

    def _tc(self, spec: TaskSpec) -> TrainConfig:
        # the importance-weight correction only activates when stale
        # micro-batches are actually admissible — at max_staleness=0 every
        # batch is on-policy and the loss must stay bit-identical to the
        # synchronous baseline. The token_logprob kernels run on the card;
        # the CPU takes the chunked plain path.
        is_cap = (self.rcfg.is_cap
                  if self.rcfg.async_train and self.rcfg.max_staleness > 0
                  else 0.0)
        return TrainConfig(group_size=spec.group_size,
                           use_logprob_kernel=self.device.type == "cuda",
                           is_cap=is_cap,
                           adamw=AdamWConfig(lr=spec.lr))

    def _train_step_for(self, spec: TaskSpec):
        if spec.group_size not in self._train_steps:
            self._train_steps[spec.group_size] = make_train_step(
                self.cfg, self._tc(spec))
        return self._train_steps[spec.group_size]

    # -- request building ----------------------------------------------------
    def _build_requests(self, tids: List[str], adapter_order: Dict[str, int]):
        reqs = []
        for tid in tids:
            spec = self.mgr.spec_for(tid)
            env = self.envs[tid]
            rng = self.datagens[tid]
            for _ in range(spec.num_groups):
                prompt, truth = env.sample_prompt(rng)
                for _ in range(spec.group_size):
                    reqs.append(RolloutRequest(
                        task_id=tid, adapter_index=adapter_order[tid],
                        prompt=prompt, truth=truth, env=env,
                        max_new_tokens=spec.max_new_tokens,
                        temperature=spec.temperature,
                        priority=spec.priority,
                        max_turns=self.rcfg.max_turns or None))
        return reqs

    # -- rollout worker -------------------------------------------------------
    def _rollout_round(self) -> bool:
        """One fused cross-task rollout round. Returns True if work done."""
        ready = self.mgr.rollout_ready_tasks()
        # admission control gates which tenants join the fused batch
        batch_tids, versions, adapters = [], {}, []
        for tid in ready:
            np_ = self.mgr.next_policy(tid)
            if np_ is None:
                continue
            versions[tid] = np_[0]
            adapters.append(np_[1])
            batch_tids.append(tid)
        if not batch_tids:
            return False
        order = {t: i for i, t in enumerate(batch_tids)}
        reqs = self._build_requests(batch_tids, order)
        t0 = time.monotonic()
        results, stats = self.engine.generate(reqs, adapters,
                                              tool_executor=self._tool_pool)
        t1 = time.monotonic()
        self.rec.record("rollout", "decode", "+".join(batch_tids), t0, t1,
                        self.rcfg.rollout_pool_devices)
        for tid in batch_tids:
            tb = to_trajectory_batch(results, tid, versions[tid],
                                     self.mgr.spec_for(tid).group_size,
                                     pad_to=self.rcfg.max_len)
            self.mgr.enqueue(tb)
        return True

    def _rollout_loop(self):
        try:
            if self.rcfg.rollout_mode == "continuous":
                self._rollout_loop_continuous()
                return
            while not self._stop.is_set():
                did = self._rollout_round()
                if not did:
                    if self.mgr.all_done():
                        return
                    time.sleep(0.002)
        except BaseException as e:       # surface to run()
            self.error = e
            self._stop.set()

    # -- streaming rollout worker (continuous slot engine) -----------------
    def _on_stage(self, phase: str, task_id: str, t0: float, t1: float):
        """Engine stage hook: prefill intervals arrive from the async
        prefill workers, splice/refill intervals from the rollout thread —
        the recorder is thread-safe. This is what makes prefill-stage vs
        decode-stage busy time separately measurable (Fig 5)."""
        from .metrics import PHASE_INTENSITY
        if phase not in PHASE_INTENSITY:
            raise ValueError(f"unknown stage phase {phase!r} — add it to "
                             "PHASE_INTENSITY or fix the call site")
        self.rec.record("rollout", phase, task_id, t0, t1,  # noqa: RA105
                        self.rcfg.rollout_pool_devices)

    def _on_adapter_evict(self, tid: str, slot: int):
        self.mgr.adapter_unbound(tid)
        self._resident_version.pop(tid, None)
        self.rec.incr("adapter_evictions")

    def _adapter_in_use(self, tid: str) -> bool:
        """A tenant's adapter may not be evicted while it has rows resident
        or queued in the engine (queued requests carry its slot index)."""
        return (tid in self.cengine.active_tenants()
                or self.mgr.state(tid).rollout_inflight_rows > 0)

    def _feed_continuous(self) -> bool:
        """Submit every consumable (task, version) round into the engine
        queue, acquiring the tenant's stacked-LoRA slot through the LRU
        residency map (idle tenants' adapters are evicted on demand, so
        tenant counts ≫ max_adapter_slots stream through). Called from the
        rollout thread only."""
        fed = False
        for tid in self.mgr.rollout_ready_tasks():
            st = self.mgr.state(tid)
            slot = self.residency.acquire(tid, st.adapters,
                                          in_use=self._adapter_in_use)
            if slot is None:
                continue     # every adapter slot pinned; task stays ready
            if st.adapter_slot != slot:          # fresh slot, not a hit
                self.mgr.adapter_bound(tid, slot)
                self.rec.incr("adapter_installs")
            np_ = self.mgr.next_policy(tid)
            if np_ is None:
                continue
            version, adapters = np_
            # one device write per (tenant, version): skip when the resident
            # copy is already this committed tree
            if self._resident_version.get(tid) != version:
                self.cengine.set_adapters(slot, adapters)
                self._resident_version[tid] = version
            reqs = self._build_requests([tid], {tid: slot})
            # GRPO group identity for the episode queue: (round, group) —
            # stamped into row meta alongside the behaviour version so
            # park/preempt/resume can't lose it
            round_no = self._round_seq.get(tid, 0) + 1
            self._round_seq[tid] = round_no
            group_size = self.mgr.spec_for(tid).group_size
            self.mgr.rollout_started(tid, len(reqs))
            for i, r in enumerate(reqs):
                meta = {"task_id": tid, "version": version,
                        "group": (round_no, i // group_size)}
                if self.tracer is not None:
                    # trace is born at submission: the gap until the engine
                    # pops it off its queue is the admission-wait component
                    tr = self.tracer.new_trace(tid)
                    meta["trace_id"] = tr
                    self.tracer.mark(tr, "submitted")
                self.cengine.submit(r, meta=meta)
            fed = True
        return fed

    def _execute_preemptions(self) -> bool:
        """Apply admission-driven preemptions queued by the admission thread
        (the engine may only be touched from the rollout thread). Records
        each victim's decode progress so the admission tick can
        tighten its parked byte reservation (remaining-budget re-estimate —
        partially decoded rows need less KV headroom at readmission)."""
        did = False
        while self._preempt_q:
            victim = self._preempt_q.popleft()
            n = self.cengine.preempt_tenant(victim)
            if n:
                self.rec.incr("preemptions")
                self.rec.incr("preempted_rows", n)
                did = True
            rows, sampled_mean = self.cengine.queued_progress(victim)
            if rows:
                self._preempt_progress[victim] = sampled_mean
        return did

    def _flush_decode_segment(self, now: float):
        if self._seg_tasks and self._seg_t0 is not None and now > self._seg_t0:
            name = "+".join(sorted(self._seg_tasks))
            self.rec.record("rollout", "decode", name,
                            self._seg_t0, now,
                            self.rcfg.rollout_pool_devices)
            if self.tracer is not None:
                # the fused decode stream as one Perfetto track: each slice
                # is a contiguous occupant-set run (same data the recorder
                # books as decode busy time)
                self.tracer.span(("rollout", "decode"), name,
                                 self._seg_t0, now)
        self._seg_t0 = now
        self._seg_tasks = frozenset()

    def _handle_completion(self, comp, rounds: Dict[tuple, list]) -> bool:
        """Route one engine completion into the trainer feed; True if a
        trainer-visible queue advanced. Every completion is accounted:
        `rollout_row_done` always runs, and rows that can never train
        (finished task, beyond the staleness window) are dropped WITH a
        counter instead of leaking in a partial round."""
        tid = comp.task_id
        self.mgr.rollout_row_done(tid)
        self._rows_completed += 1
        if comp.finish_reason == "quarantined":
            # engine-aborted row of a tripped tenant: counted, never trained
            self.mgr.note_quarantine_dropped(tid, 1)
            return False
        failed = comp.finish_reason == "tool_error"
        if self.breaker is not None:
            if failed:
                self.breaker.record_failure(tid)
            elif comp.finish_reason in ("eos", "budget", "capacity",
                                        "turn_limit"):
                # natural finishes close a half-open probe; degraded-but-
                # finished rows (tool_timeout, straggler) are neutral
                self.breaker.record_success(tid)
        if self.rcfg.async_train:
            if failed:
                # permanent tool error: the episode's GRPO group is poisoned
                # (siblings drop with it — a group missing a row can never
                # train), all counted as failed rows
                self.mgr.fail_episode(tid, comp.meta.get("group"), comp)
                return False
            # event-driven feed: the episode joins its GRPO group in the
            # per-tenant queue the moment it evicts — no round assembly
            advanced = self.mgr.enqueue_episode(tid, comp.version,
                                                comp.meta.get("group"), comp)
            self.rec.record_train_backlog(time.monotonic(),
                                          self.mgr.dispatchable_rows())
            return advanced
        st = self.mgr.state(tid)
        key = (tid, comp.version)
        if st.done or st.version - comp.version > self.mgr.max_staleness:
            # this round can never train: drop the completion AND any
            # already-buffered siblings (previously they sat in `rounds`
            # forever — the partial-entry leak)
            stale = rounds.pop(key, [])
            self._sync_failed.pop(key, None)
            self.rec.incr("orphaned_completions", 1 + len(stale))
            return False
        spec = self.mgr.spec_for(tid)
        if failed:
            self._sync_failed[key] = self._sync_failed.get(key, 0) + 1
            self.mgr.note_failed(tid, 1)
        else:
            rounds.setdefault(key, []).append(comp)
        batch = rounds.get(key, [])
        n_failed = self._sync_failed.get(key, 0)
        if len(batch) + n_failed < spec.rows_per_batch:
            return False
        rounds.pop(key, None)
        self._sync_failed.pop(key, None)
        if n_failed:
            # a round missing rows can never pack into full GRPO groups:
            # the surviving siblings drop with the failures and issuance is
            # re-armed so the tenant isn't wedged waiting for a commit
            if batch:
                self.mgr.note_failed(tid, len(batch))
            self.mgr.round_failed(tid)
            return False
        # completions arrive in eviction order; GRPO groups are contiguous
        # rows sharing a prompt, so restore submission order before packing
        batch.sort(key=lambda c: c.submit_index)
        tb = to_trajectory_batch(batch, tid, comp.version, spec.group_size,
                                 pad_to=self.rcfg.max_len)
        if self.tracer is not None:
            tb.meta["trace_ids"] = self._trace_ids_of(batch)
        self.mgr.enqueue(tb)
        self.rec.record_train_backlog(time.monotonic(),
                                      self.mgr.dispatchable_rows())
        return True

    @staticmethod
    def _trace_ids_of(completions) -> List[int]:
        """Trace ids riding a batch's completion metas (traced rows only)."""
        return [c.meta["trace_id"] for c in completions
                if isinstance(c.meta, dict) and "trace_id" in c.meta]

    def _poll_breaker(self, rounds: Dict[tuple, list]):
        """Apply pending circuit-breaker transitions (rollout thread only —
        quarantine aborts the tenant's engine rows, and the engine is
        single-threaded). Admission byte accounting is queued to the
        admission tick; everything else happens here."""
        now = time.monotonic()
        for tid, state in self.breaker.poll(now):
            self.rec.record_breaker_sample(now, tid, state)
            if self.tracer is not None:
                self.tracer.instant(("supervisor", "breaker"),
                                    f"{tid}:{state}", now)
            if state == OPEN:
                self.rec.incr("quarantine_trips")
                self.mgr.quarantine(tid)
                # in-flight rows abort through the normal completion path
                # (finish_reason "quarantined" -> counted drops); queued
                # manager work drains with counted drops too
                self.cengine.abort_tenant(tid)
                self.mgr.drain_tenant(tid)
                for key in [k for k in rounds if k[0] == tid]:
                    self.mgr.note_quarantine_dropped(tid,
                                                     len(rounds.pop(key)))
                for key in [k for k in self._sync_failed if k[0] == tid]:
                    del self._sync_failed[key]
                self._quarantine_admission_q.append(("quarantine", tid))
            elif state == HALF_OPEN:
                self.rec.incr("quarantine_probes")
                self.mgr.unquarantine(tid)     # probe round may issue
                self._quarantine_admission_q.append(("readmit", tid))
            elif state == CLOSED:
                self.rec.incr("quarantine_recoveries")
            elif state == ABANDONED:
                self.rec.incr("quarantine_abandoned")
                self.cengine.abort_tenant(tid)
                self.mgr.abandon(tid)          # done-without-finishing: the
                                               # admission tick releases its
                                               # parked bytes via st.done

    def _rollout_loop_continuous(self):
        eng = self.cengine
        rounds: Dict[tuple, list] = {}      # (tid, v) -> completions so far
        clean = False                       # exited via all-done, not stop
        self._seg_tasks: frozenset = frozenset()
        self._seg_t0: Optional[float] = None
        last_slot_sample = None
        last_queue_sample = None
        last_env_sample = None
        last_page_sample = None
        while not self._stop.is_set():
            self._execute_preemptions()
            fed = self._feed_continuous()
            progressed = eng.step()
            now = time.monotonic()
            occ, cap = eng.occupancy()
            # step-function timeline: sample only on occupancy change (idle
            # spins would otherwise append hundreds of samples per second)
            if (occ, cap) != last_slot_sample:
                self.rec.record_slot_sample(now, occ, cap)
                last_slot_sample = (occ, cap)
            qd = eng.queue_depths()
            if qd != last_queue_sample:
                self.rec.record_queue_sample(now, *qd)
                last_queue_sample = qd
            if self.rcfg.env_stage:
                ed = eng.env_depths()
                if ed != last_env_sample:
                    self.rec.record_env_sample(now, *ed)
                    last_env_sample = ed
            if self.rcfg.paged_kv:
                ps = eng.page_stats()
                key = (ps["kv_pages_used"], round(ps["kv_page_frag"], 3))
                if key != last_page_sample:
                    self.rec.record_page_sample(
                        now, int(ps["kv_pages_used"]),
                        int(ps["kv_pages_total"]), ps["kv_page_frag"])
                    last_page_sample = key
            # decode timeline: one interval per contiguous occupant-set run,
            # task_id joined with "+" (fused multi-tenant decode)
            tasks_now = eng.occupant_tasks()
            if tasks_now != self._seg_tasks:
                self._flush_decode_segment(now)
                self._seg_tasks = tasks_now
            for comp in eng.drain_completions():
                if self._handle_completion(comp, rounds):
                    progressed = True
            if self.breaker is not None:
                self._poll_breaker(rounds)
            if not progressed and not fed:
                if self.mgr.all_done() and eng.idle():
                    clean = True
                    break
                time.sleep(0.002)
        # final drain: the stop flag can land while completions sit in the
        # engine's out-queue — without this they vanished with the thread,
        # inflight-row counters never returned to zero, and a restart
        # over-counted occupancy (the shutdown half of the rounds-dict leak)
        for comp in eng.drain_completions():
            self._handle_completion(comp, rounds)
        if clean:
            # drain invariants: a clean all-done exit must leave no orphaned
            # completions and every inflight-row counter back at zero
            assert not rounds, (
                f"partial rounds leaked at clean shutdown: "
                f"{[(k, len(v)) for k, v in rounds.items()]}")
            leftover = self.mgr.inflight_rows()
            assert not leftover, (
                f"inflight-row counters nonzero at clean shutdown: {leftover}")
            assert self.mgr.partial_rows() == 0, "partial GRPO groups leaked"
        elif rounds:
            # aborted run (stop flag / injected failure): rows already
            # completed for never-finished rounds are surfaced, not lost
            self.rec.incr("orphaned_completions",
                          sum(len(v) for v in rounds.values()))
            rounds.clear()
        now = time.monotonic()
        occ, cap = eng.occupancy()
        self.rec.record_slot_sample(now, occ, cap)   # close the timeline
        self.rec.record_queue_sample(now, *eng.queue_depths())
        if self.rcfg.paged_kv:
            ps = eng.page_stats()
            self.rec.record_page_sample(now, int(ps["kv_pages_used"]),
                                        int(ps["kv_pages_total"]),
                                        ps["kv_page_frag"])
            # restore-vs-replay counts reach summarize() straight from
            # RolloutStats via rec.counters_snapshot() (single source of
            # truth); sharing gauges ride the counter channel as end-of-run values
            for name in ("kv_shared_pages", "kv_prefix_pages",
                         "kv_hbm_bytes_per_row"):
                if ps.get(name):
                    self.rec.incr(name, int(ps[name]))
        # stage-supervision accounting -> summary counters (merged before
        # the halts below: a wedged worker makes a halt raise)
        # supervisor.counters is tick-thread-only (this thread) — it is not
        # the recorder's lock-guarded dict of the same name
        for name, n in eng.supervisor.counters.items():  # noqa: RA102
            if n:
                self.rec.incr(f"supervisor_{name}", n)
        if eng._env is not None:
            for name in ("retries", "recovered", "wedged"):
                n = getattr(eng._env, name)
                if n:
                    self.rec.incr(f"env_{name}", n)
        if self.chaos is not None:
            for site, n in self.chaos.counts().items():
                if n:
                    self.rec.incr(f"chaos_{site}", n)
        if self.rcfg.env_stage:
            self.rec.record_env_sample(now, *eng.env_depths())
            eng._env.halt()     # env workers die with the rollout loop
        self._flush_decode_segment(now)
        if self.rcfg.disagg_prefill:
            eng._halt_stage()   # prefill workers die with the rollout loop

    # -- trainer ---------------------------------------------------------------
    def _train_one(self, tb, trained_version: Optional[int] = None) -> None:
        if self.failure:
            self.failure.on_train()    # pre-commit fail point: the popped
                                       # batch is in-flight right now
        if trained_version is None:
            trained_version = tb.version
        st = self.mgr.state(tb.task_id)
        tc = self._tc(st.spec)
        step_fn = self._train_step_for(st.spec)
        # the loss mask when the batch carries one; the behaviour logprobs
        # only under the decoupled-PPO correction (min(exp(old_lp -
        # behavior_lp), is_cap), recorded at sample time)
        batch = batch_from_trajectory(tb, tc, self.device)
        trace_ids = (tb.meta.get("trace_ids", ())
                     if self.tracer is not None else ())
        t0 = time.monotonic()
        if self.tracer is not None:
            for tr in trace_ids:
                self.tracer.mark(tr, "train", t0)
        new_adapters, new_opt, metrics = step_fn(self.base_params, st.adapters,
                                                 st.opt_state, batch)
        synchronize(self.device)       # the interval is the step's device time
        t1 = time.monotonic()
        self.rec.record("train", "train", tb.task_id, t0, t1,
                        self.rcfg.train_pool_devices)
        self.mgr.commit(tb.task_id, new_adapters, new_opt, trained_version,
                        reward_mean=float(np.mean(tb.rewards)))
        if self.tracer is not None:
            t_commit = self.tracer.now()
            self.tracer.span(("train", "trainer"), tb.task_id, t0, t_commit,
                             flow_in=0, flow_out=0)
            for tr in trace_ids:
                self.tracer.mark(tr, "committed", t_commit)
        self.mgr.rows_trained += tb.num_rows
        self.rec.record_train_backlog(time.monotonic(),
                                      self.mgr.dispatchable_rows())
        if self.failure:
            self.failure.on_commit()
        if (self.rcfg.checkpoint_dir and self.rcfg.checkpoint_every and
                self.mgr.total_steps_done()
                % self.rcfg.checkpoint_every == 0):
            # the committed trees are new tensors (a commit never writes in
            # place), so the copy to host reads a tree no thread writes
            save_checkpoint(self.rcfg.checkpoint_dir, self.mgr,
                            keep_last_n=self.rcfg.checkpoint_keep_last,
                            chaos=self.chaos)

    def _train_loop(self):
        try:
            # a previous trainer incarnation may have died between pop and
            # commit (injected failure / crash): restore its popped work to
            # the queue head before consuming anything new, else the tenant
            # whose issue budget is already spent deadlocks
            requeued = self.mgr.recover_inflight()
            if requeued:
                self.rec.incr("train_work_recovered", requeued)
            if self.rcfg.async_train:
                self._train_loop_async()
                return
            while not self._stop.is_set():
                t0 = time.monotonic()
                tb = self.mgr.pop_batch(timeout=0.05)
                if tb is None:
                    self.rec.record_trainer_wait(t0, time.monotonic())
                    if self.mgr.all_done():
                        return
                    continue
                self.rec.record_train_backlog(time.monotonic(),
                                              self.mgr.dispatchable_rows())
                self._train_one(tb)
        except BaseException as e:
            self.error = e
            self._stop.set()

    def _train_loop_async(self):
        """Event-driven trainer: pop one tenant's micro-batch
        of complete GRPO groups the moment its `min_train_rows` threshold
        is met — never waits for full-round assembly, so trainer idle time
        between commits is bounded by decode throughput, not by the
        slowest row of a round."""
        while not self._stop.is_set():
            t0 = time.monotonic()
            item = self.mgr.pop_episodes(timeout=0.05)
            if item is None:
                self.rec.record_trainer_wait(t0, time.monotonic())
                if self.mgr.all_done():
                    return
                continue
            self.rec.record_train_backlog(time.monotonic(),
                                          self.mgr.dispatchable_rows())
            tid, groups = item
            rows = [r for g in groups for r in g.rows]
            # eviction order -> submission order (same sort as the
            # synchronous packer: at max_staleness=0 the micro-batch is the
            # full round, token-for-token)
            rows.sort(key=lambda c: c.submit_index)
            oldest = min(g.version for g in groups)
            newest = max(g.version for g in groups)
            spec = self.mgr.spec_for(tid)
            tb = to_trajectory_batch(rows, tid, newest, spec.group_size,
                                     pad_to=self.rcfg.max_len)
            if self.tracer is not None:
                tb.meta["trace_ids"] = self._trace_ids_of(rows)
            if self.mgr.version_of(tid) - oldest > 0:
                self.rec.incr("stale_rows_trained", len(rows))
            # commit is checked against the OLDEST behaviour version in the
            # micro-batch — the conservative end of the staleness window
            self._train_one(tb, trained_version=oldest)

    # -- admission (priority-ordered, preemption-capable) ------------------
    def _pending_by_priority(self) -> List[str]:
        pending = self.mgr.pending_tasks()
        pending.sort(key=lambda t: -self.mgr.spec_for(t).priority)
        return pending

    def _expected_gen(self, tid: str) -> Optional[float]:
        """Expected completion length for page-granular admission charges
        (paged engine only): the engine's per-tenant length EMA — cold
        tenants charge their full budget, warm tenants what they actually
        generate, so admission packs tighter as history accrues."""
        if not self.rcfg.paged_kv:
            return None
        spec = self.mgr.spec_for(tid)
        return self.cengine.predictor.predict(tid, spec.max_new_tokens)

    def _try_admit_with_preemption(self, tid: str) -> bool:
        """Admit `tid`, preempting strictly-lower-priority admitted tasks
        (lowest first) until its byte estimate fits. A preempted victim's
        resident rows are evicted on the rollout thread and replay later;
        its bytes move to the admission controller's preempted set for
        re-admission once capacity frees."""
        spec = self.mgr.spec_for(tid)
        if self.admission.try_admit(spec, 32, self._expected_gen(tid)):
            return True
        if not (self.rcfg.preemption
                and self.rcfg.rollout_mode == "continuous"):
            return False
        items = dict(self.mgr.task_items())
        victims = [t2 for t2, s2 in items.items()
                   if s2.status == "admitted" and not s2.done
                   and s2.spec.priority < spec.priority]
        victims.sort(key=lambda t2: (items[t2].spec.priority,
                                     -items[t2].admitted_at))
        # feasibility: don't preempt anyone unless evicting ALL eligible
        # victims would actually fit the newcomer (else thrash for nothing)
        from .admission import task_state_bytes
        need = task_state_bytes(self.cfg, spec, 32,
                                self.acfg.kv_dtype_bytes)
        freeable = sum(self.admission.admitted_bytes(t2) for t2 in victims)
        if (self.admission.used_bytes - freeable + need
                > self.acfg.memory_budget_bytes):
            return False
        for victim in victims:
            self.admission.preempt(victim)
            self.mgr.preempt(victim)
            self._preempt_q.append(victim)     # engine evicts on its thread
            if self.admission.try_admit(spec, 32,
                                        self._expected_gen(tid)):
                return True
        return False

    def _admission_tick(self):
        """One admission pass: release finished, re-admit preempted, admit
        pending (highest priority first, preempting if allowed)."""
        # quarantine byte accounting requested by the rollout thread: a
        # tripped tenant's reservation parks (frees budget for the healthy),
        # a half-open probe re-charges it — soft, retried next tick if full
        while self._quarantine_admission_q:
            action, tid = self._quarantine_admission_q.popleft()
            if action == "quarantine":
                self.admission.quarantine(tid)
            elif action == "readmit":
                if not self.admission.try_unquarantine(tid):
                    self._quarantine_admission_q.append(("readmit", tid))
                    break              # budget full now; retry next tick
        for tid, st in self.mgr.task_items():
            if st.done and (tid in self.admission.admitted()
                            or tid in self.admission.preempted()):
                self.admission.release(tid)
                self.mgr.readmit(tid)          # preempted+done -> finished
        for tid in sorted(self.admission.preempted(),
                          key=lambda t: -self.mgr.spec_for(t).priority):
            # remaining-budget-aware re-estimate: rows
            # already partially decoded shrink the reservation re-charged at
            # readmission, so preempted tenants pack back in tighter
            progress = self._preempt_progress.pop(tid, None)
            if self.rcfg.paged_kv:
                # ACTUAL page counts (snapshot pages + page-rounded replay
                # prefixes) replace the model-derived estimate entirely —
                # the paged engine knows exactly what restore will allocate
                actual = self.cengine.queued_state_bytes(
                    tid, self.acfg.kv_dtype_bytes)
                if actual:
                    self.admission.reestimate_preempted_bytes(tid, actual)
            elif progress is not None:
                self.admission.reestimate_preempted(
                    tid, self.mgr.spec_for(tid), progress, 32)
            if self.admission.try_readmit(tid):
                self.mgr.readmit(tid)
                self.rec.incr("readmissions")
        for tid in self._pending_by_priority():
            if self._try_admit_with_preemption(tid):
                self.mgr.admit(tid)

    # -- run loops --------------------------------------------------------------
    def run(self, timeout_s: float = 600.0):
        """Run to completion under the configured policy."""
        for tid in self._pending_by_priority():
            spec = self.mgr.spec_for(tid)
            wl_prompt = 32
            if (self.rcfg.policy == "marlaas"
                    and not self.admission.try_admit(spec, wl_prompt,
                                                     self._expected_gen(tid))
                    and self.acfg.strict):
                continue                      # stays pending until release
            self.mgr.admit(tid)
        if self.rcfg.policy == "marlaas":
            self._run_async(timeout_s)
        elif self.rcfg.policy == "multilora_sync":
            self._run_sync(timeout_s)
        elif self.rcfg.policy == "single_disagg":
            self._run_sequential(timeout_s)
        else:
            raise ValueError(self.rcfg.policy)
        # staleness-window drop-or-train accounting -> summary counters
        # (n_stale_rows_dropped / n_stale_groups_dropped / ...)
        for name, n in self.mgr.drop_counters().items():
            if n:
                self.rec.incr(name, n)
        if self.error:
            raise self.error

    @property
    def _rows_trained(self) -> int:
        # checkpoint-restart moved the canonical counter onto the manager
        # (it serializes with the manifest); kept as a read-only alias
        return self.mgr.rows_trained

    def row_accounting(self) -> Dict[str, int]:
        """Every issued row's terminal fate. The conservation invariant the
        chaos tests assert exactly:

            completed == trained + stale_dropped + discarded_tails
                         + failed + quarantine_dropped [+ orphaned]

        `orphaned` is nonzero only on aborted runs — rows stranded at the
        stop flag, or completed rows a checkpoint restart could not carry
        over (their round regenerates; `Manager.orphaned_rows` counts the
        lost copies). A clean single-incarnation run retires every row
        through one of the other paths."""
        d = self.mgr.drop_counters()
        c = self.rec.counters_snapshot()
        return {
            "completed": sum(st.rollout_rows_total
                             for _, st in self.mgr.task_items()),
            "trained": self.mgr.rows_trained,
            "stale_dropped": d["stale_rows_dropped"],
            "discarded_tails": d["discarded_tail_rows"],
            "failed": d["failed_rows"],
            "quarantine_dropped": d["quarantine_dropped_rows"],
            "orphaned": (c.get("orphaned_completions", 0)
                         + self.mgr.orphaned_rows),
        }

    def adopt_checkpoint(self, path) -> None:
        """Restore manager state from a snapshot (either package's) into
        THIS (fresh) runtime: tasks come back at their committed versions
        with their adapters and optimizer state, put on the runtime's
        device, and re-issue the next round; surviving completed-episode
        queues rebind live env handles (envs don't serialize), and
        per-tenant datagens are rebuilt exactly as `submit_task` would
        (from the salted str hash, as the JAX runtime does: a caller that
        needs fixed prompt streams pins them again)."""
        load_checkpoint(path, self.mgr)
        for tid, st in self.mgr.task_items():
            st.adapters = lora_from_jax(st.adapters, self.device)
            st.opt_state = lora_from_jax(st.opt_state, self.device)
            self.envs[tid] = make_env(st.spec.env_name)
            self.datagens[tid] = random.Random(
                hash((self.rcfg.seed, tid)) % (2 ** 31))
        self.mgr.rebind_episode_envs(self.envs)

    def run_with_recovery(self, timeout_s: float = 600.0,
                          max_restarts: int = 2) -> "MARLaaSRuntime":
        """Run to completion, restarting from the newest valid checkpoint
        when a stage escalation (or injected crash) kills the run — the
        supervisor's last resort when restart-in-place can't help. Returns
        the runtime instance that finished (a fresh one after a restart:
        engine state is not trusted after a crash, only checkpoints are)."""
        rt = self
        for attempt in range(max_restarts + 1):
            try:
                rt.run(timeout_s)
                return rt
            except BaseException:
                if attempt >= max_restarts or not rt.rcfg.checkpoint_dir:
                    raise
                path = latest_checkpoint(rt.rcfg.checkpoint_dir)
                if path is None:
                    raise               # nothing to restart from
                fresh = MARLaaSRuntime(rt.cfg, rt.base_params, rt.rcfg,
                                       rt.acfg, rt._train_cfg_base,
                                       failure=None)
                fresh.adopt_checkpoint(path)
                fresh.rec.incr("checkpoint_restarts")
                rt = fresh
        return rt

    def _run_async(self, timeout_s):
        rt = threading.Thread(target=self._rollout_loop, daemon=True,
                              name="marlaas-rollout")
        tt = threading.Thread(target=self._train_loop, daemon=True,
                              name="marlaas-train")
        rt.start(); tt.start()
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if self.mgr.all_done() or self._stop.is_set():
                break
            # release finished / re-admit preempted / admit pending (with
            # priority preemption) as capacity moves
            self._admission_tick()
            time.sleep(0.01)
        # grace drain: bounded-staleness pipelining may leave rounds issued
        # before the final commit still decoding — let the rollout loop
        # retire them through the normal completion path (counted as
        # discarded tails) so the inflight-row counters return to zero,
        # instead of abandoning resident rows at the stop flag
        if self.mgr.all_done() and not self._stop.is_set():
            rt.join(timeout=min(30.0, max(1.0,
                                          deadline - time.monotonic())))
        self._stop.set()
        join_or_raise([rt, tt], timeout_s=10.0)

    def _run_sync(self, timeout_s):
        """Barrier rounds: fused rollout for all, then train all, repeat."""
        deadline = time.monotonic() + timeout_s
        while not self.mgr.all_done() and time.monotonic() < deadline:
            if not self._rollout_round():
                break
            while True:
                tb = self.mgr.pop_batch()
                if tb is None:
                    break
                self._train_one(tb)
        if self.error:
            raise self.error

    def _run_sequential(self, timeout_s):
        deadline = time.monotonic() + timeout_s
        for tid, st in self.mgr.task_items():
            while not st.done and time.monotonic() < deadline:
                np_ = self.mgr.next_policy(tid)
                if np_ is None:
                    break
                v, _ = np_
                order = {tid: 0}
                reqs = self._build_requests([tid], order)
                t0 = time.monotonic()
                results, _ = self.engine.generate(reqs, [st.adapters],
                                                  tool_executor=self._tool_pool)
                self.rec.record("rollout", "decode", tid, t0, time.monotonic(),
                                self.rcfg.rollout_pool_devices)
                tb = to_trajectory_batch(results, tid, v, st.spec.group_size,
                                         pad_to=self.rcfg.max_len)
                self.mgr.enqueue(tb)
                self._train_one(self.mgr.pop_batch())
        if self.error:
            raise self.error
