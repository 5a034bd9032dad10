"""KV-cache-aware admission control (paper §4.3).

A task is admitted while the estimated aggregate rollout-state footprint of
all admitted tasks stays below the rollout engine's memory budget. The
estimator generalizes the paper's KV formula to every assigned family
(DESIGN.md §5): attention archs pay per-token KV bytes, SSM archs pay a
fixed recurrent-state cost, hybrids pay both.

As in the paper, this is a soft constraint: `strict=False` lets one task
over-subscribe (it queues in the engine) — modelled in the simulator as a
throughput knee, matching the paper's observation that over-admission
raises per-step latency with marginal throughput gain.

A copy of ``repro.core.admission`` on the port's ``ModelConfig``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from repro_torch.configs import ModelConfig
from .manager import TaskSpec


@dataclass
class AdmissionConfig:
    memory_budget_bytes: float = 8e9     # rollout-pool HBM left for KV
    kv_dtype_bytes: int = 2
    strict: bool = True
    paged: bool = False                  # paged KV engine: charge
                                         # page-granular estimates instead of
                                         # worst-case max_len reservations
    page_size: int = 16                  # engine kv_page_size (paged only)
    prefix_shared: bool = False          # COW prefix cache: a GRPO
                                         # group's full prompt pages are
                                         # physically shared, so charge them
                                         # once per group, not once per row


def task_state_bytes(cfg: ModelConfig, spec: TaskSpec,
                     prompt_len: int = 64, dtype_bytes: int = 2) -> int:
    """Estimated rollout-state bytes for one task's in-flight batch:
    rows × (max_len × per-token KV + fixed SSM state)."""
    rows = spec.rows_per_batch
    max_len = prompt_len + spec.max_new_tokens
    per_tok = cfg.state_bytes_per_token(dtype_bytes)
    fixed = cfg.state_bytes_fixed(dtype_bytes)
    return rows * (max_len * per_tok + fixed)


def task_state_bytes_remaining(cfg: ModelConfig, spec: TaskSpec,
                               prompt_len: int = 64, dtype_bytes: int = 2,
                               sampled_mean: float = 0.0) -> int:
    """Remaining-budget-aware re-estimate for a PREEMPTED task: its
    rows carry `sampled_mean` already-generated tokens on
    average, so the modelled KV headroom charged at readmission shrinks by
    that share — readmission packs tighter than the original admission.

    Modelling note (soft, like the rest of the controller): a replayed
    row's prefix KV is re-materialized at replay, so the true peak matches
    the original estimate; but the prefix re-decode phase is brief and the
    controller's budget is a knee model, not an allocator — charging only
    the remaining growth is the paper's intent for re-admission packing."""
    rows = spec.rows_per_batch
    done = max(0.0, min(float(sampled_mean), float(spec.max_new_tokens)))
    rem_len = prompt_len + spec.max_new_tokens - done
    per_tok = cfg.state_bytes_per_token(dtype_bytes)
    fixed = cfg.state_bytes_fixed(dtype_bytes)
    return int(rows * (rem_len * per_tok + fixed))


def task_state_bytes_paged(cfg: ModelConfig, spec: TaskSpec,
                           prompt_len: int = 64, dtype_bytes: int = 2,
                           page_size: int = 16,
                           expected_new_tokens: Optional[float] = None
                           ) -> int:
    """Page-granular estimate for the PAGED KV engine: rows ×
    (pages(prompt + expected generation) × page tokens + fixed state).

    The dense estimator had no choice but to charge ``max_len`` per row —
    the engine physically reserved it. The page pool only ever holds
    ``ceil(len/page)`` pages per row, so the controller can charge what
    rows are EXPECTED to use: ``expected_new_tokens`` defaults to the full
    ``spec.max_new_tokens`` (cold tenant, pessimistic), and callers with a
    length predictor (the engine's per-tenant EMA) pass the expected
    completion length — mixed-length tenant sets then pack substantially
    more resident rows into the same HBM budget (the bench gate)."""
    rows = spec.rows_per_batch
    gen = (spec.max_new_tokens if expected_new_tokens is None
           else min(float(expected_new_tokens), float(spec.max_new_tokens)))
    total = int(prompt_len + gen + 0.999)
    pages = -(-total // page_size)
    per_tok = cfg.state_bytes_per_token(dtype_bytes)
    fixed = cfg.state_bytes_fixed(dtype_bytes)
    return int(rows * (pages * page_size * per_tok + fixed))


def task_state_bytes_shared(cfg: ModelConfig, spec: TaskSpec,
                            prompt_len: int = 64, dtype_bytes: int = 2,
                            page_size: int = 16,
                            expected_new_tokens: Optional[float] = None
                            ) -> int:
    """Group-shared estimate for the COW prefix cache: the
    ``group_size`` rows of a GRPO group run the SAME prompt, and the engine
    maps their block tables onto one retained page set — full prompt pages
    exist once per group physically, so the controller charges them once
    per group too. Each row then pays only its private growth: the shared
    partial tail page forks on first decode write (one COW page) plus the
    pages its generated suffix spills into, plus fixed recurrent state.

    This is what lets admission pack strictly more resident rows under the
    same HBM budget than the private-pages estimator — the bench gate's
    ≥1.3x admitted-rows ratio reads directly off this charge."""
    gen = (spec.max_new_tokens if expected_new_tokens is None
           else min(float(expected_new_tokens), float(spec.max_new_tokens)))
    gen = int(gen + 0.999)
    full_prompt_pages = prompt_len // page_size
    rem = prompt_len - full_prompt_pages * page_size
    # per-row private pages: the forked tail (holding `rem` prompt tokens)
    # grows with the generation; page-aligned prompts fork nothing and the
    # first decode write allocates a fresh page
    row_pages = -(-(rem + gen) // page_size) if (rem + gen) else 0
    per_tok = cfg.state_bytes_per_token(dtype_bytes)
    fixed = cfg.state_bytes_fixed(dtype_bytes)
    page_bytes = page_size * per_tok
    shared = spec.num_groups * full_prompt_pages * page_bytes
    private = spec.rows_per_batch * (row_pages * page_bytes + fixed)
    return int(shared + private)


class AdmissionController:
    """Byte-budget admission with preemption accounting.

    Lifecycle: try_admit → (preempt ↔ try_readmit)* → release. `preempt`
    releases a still-running task's bytes back to the budget while
    remembering the charge, so a higher-priority newcomer can admit;
    `try_readmit` re-charges the same estimate once budget frees. Without
    this, preempted tasks kept their reservation forever and preemption
    could never create capacity (the bug this accounting fixes — bytes
    were only released at task finish).

    Soft, like the rest of the controller (paper §4.3): a preempted
    task's evicted rows hold no state while queued, but they prefix-
    replay into decode slots as they free, so the modelled budget can be
    transiently exceeded while victim and newcomer rows coexist. The
    engine's actual KV pool is a fixed preallocation (max_slots ×
    max_len), so this over-subscription shows up as queueing, never as
    allocation beyond the pool."""

    def __init__(self, cfg: ModelConfig, acfg: AdmissionConfig):
        self.cfg = cfg
        self.acfg = acfg
        self._admitted: Dict[str, int] = {}
        self._preempted: Dict[str, int] = {}

    @property
    def used_bytes(self) -> int:
        return sum(self._admitted.values())

    def try_admit(self, spec: TaskSpec, prompt_len: int = 64,
                  expected_new_tokens: Optional[float] = None) -> bool:
        if self.acfg.paged and self.acfg.prefix_shared:
            # COW prefix cache: full prompt pages charged once per GRPO
            # group (physically shared), private growth per row
            need = task_state_bytes_shared(self.cfg, spec, prompt_len,
                                           self.acfg.kv_dtype_bytes,
                                           self.acfg.page_size,
                                           expected_new_tokens)
        elif self.acfg.paged:
            # page-granular charge (actual pool consumption), optionally
            # tightened by the caller's expected completion length
            need = task_state_bytes_paged(self.cfg, spec, prompt_len,
                                          self.acfg.kv_dtype_bytes,
                                          self.acfg.page_size,
                                          expected_new_tokens)
        else:
            need = task_state_bytes(self.cfg, spec, prompt_len,
                                    self.acfg.kv_dtype_bytes)
        return self.try_admit_bytes(spec.task_id, need)

    def try_admit_bytes(self, task_id: str, need: int) -> bool:
        """Admission on a precomputed estimate (the simulator derives it from
        the workload model rather than the TaskSpec defaults).

        An empty system always admits one task (the paper's constraint is
        soft — a lone over-budget task queues inside the engine rather than
        deadlocking the service)."""
        if not self._admitted:
            self._admitted[task_id] = need
            return True
        if (self.acfg.strict
                and self.used_bytes + need > self.acfg.memory_budget_bytes):
            return False
        self._admitted[task_id] = need
        return True

    def workload_bytes(self, rows: int, total_len: int,
                       dtype_bytes: int = None) -> int:
        db = dtype_bytes or self.acfg.kv_dtype_bytes
        return rows * (total_len * self.cfg.state_bytes_per_token(db)
                       + self.cfg.state_bytes_fixed(db))

    def preempt(self, task_id: str) -> int:
        """Release an admitted task's bytes while it is preempted; the
        charge is remembered for `try_readmit`. Returns the bytes freed."""
        need = self._admitted.pop(task_id, None)
        if need is None:
            return 0
        self._preempted[task_id] = need
        return need

    def reestimate_preempted(self, task_id: str, spec: TaskSpec,
                             sampled_mean: float,
                             prompt_len: int = 64) -> Optional[int]:
        """Tighten a preempted task's parked reservation to the
        remaining-budget-aware estimate (never raises it — the original
        charge is the ceiling). Returns the new estimate, or None if the
        task is not in the preempted set."""
        old = self._preempted.get(task_id)
        if old is None:
            return None
        new = task_state_bytes_remaining(self.cfg, spec, prompt_len,
                                         self.acfg.kv_dtype_bytes,
                                         sampled_mean)
        self._preempted[task_id] = min(old, new)
        return self._preempted[task_id]

    def reestimate_preempted_bytes(self, task_id: str,
                                   need: int) -> Optional[int]:
        """Tighten a preempted task's parked reservation to an ACTUAL byte
        count (paged engine: snapshot page counts + page-rounded replay
        prefixes reported by ``engine.queued_state_bytes``) instead of a
        model-derived estimate. Never raises the charge."""
        old = self._preempted.get(task_id)
        if old is None:
            return None
        self._preempted[task_id] = min(old, int(need))
        return self._preempted[task_id]

    def try_readmit(self, task_id: str) -> bool:
        """Re-charge a preempted task's remembered estimate if it fits (the
        empty-system soft rule of try_admit_bytes applies). The estimate
        may have been tightened by `reestimate_preempted` since preemption
        (rows already partially decoded need less KV headroom)."""
        need = self._preempted.get(task_id)
        if need is None:
            return False
        if self.try_admit_bytes(task_id, need):
            del self._preempted[task_id]
            return True
        return False

    # -- quarantine (per-tenant circuit breaker) -----------------
    def quarantine(self, task_id: str) -> int:
        """Pause a quarantined tenant's admission: its bytes free up for
        the healthy tenants (reusing the preemption accounting — the
        charge parks, it is not forgotten) until the half-open probe
        readmits it. Returns the bytes freed."""
        return self.preempt(task_id)

    def try_unquarantine(self, task_id: str) -> bool:
        """Re-charge a quarantined tenant's parked reservation for its
        half-open probe round. Soft like try_readmit: False means the
        budget is currently full — the caller retries next tick (the probe
        itself is not blocked; this is the accounting side)."""
        return self.try_readmit(task_id)

    def release(self, task_id: str):
        """Finished (or cancelled) task: drop its reservation wherever it
        is — admitted or parked in the preempted set."""
        self._admitted.pop(task_id, None)
        self._preempted.pop(task_id, None)

    def admitted(self) -> List[str]:
        return list(self._admitted)

    def admitted_bytes(self, task_id: str) -> int:
        """Current reservation charged to an admitted task (0 if absent)."""
        return self._admitted.get(task_id, 0)

    def preempted(self) -> List[str]:
        return list(self._preempted)
