"""Slot-scheduling policies for the continuous engine (paper §4.3/§4.5); a
copy of ``repro.rollout.scheduler``, with the same pop order.

``LengthPredictor`` — per-tenant EMA of *sampled* completion length, fed by
every evicted row. Until a tenant has history its prediction is its request
budget (``max_new_tokens``), so cold tenants are scheduled pessimistically
and converge as rows complete.

``SlotScheduler`` — the queue. Pop order under policy ``"srpt"``:

  1. starvation tier: any entry that has waited ``starvation_k`` refill
     events pops first, FIFO among the starved — every queued tenant is
     guaranteed progress within K refills;
  2. priority tier: higher ``RolloutRequest.priority`` first;
  3. resume tier: rows re-queued with a pre-loaded force-feed queue pop
     before fresh rows of the same priority;
  4. shortest-predicted-remaining-budget first (predicted length minus
     tokens already sampled — replayed rows get credit for their prefix);
  5. deterministic tie-break on ``submit_index`` (unique per row).

Policy ``"fifo"`` keeps arrival order. Token streams do not depend on pop
order: sampling is per-row (key, counter). The queue itself is not
thread-safe; the engine serializes access under its queue lock. The
predictor's lock is named ``_ema_lock`` (the JAX package's is ``_lock``):
the repo's lock-order analyzer names a lock by class and attribute, and two
classes ``LengthPredictor`` with the same lock attribute would shadow each
other there.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

POLICIES = ("fifo", "srpt")


class LengthPredictor:
    """EMA per-tenant predictor of sampled completion length.

    Thread contract: ``observe`` runs on the rollout thread (every evicted
    row) while the driver thread calls ``predict`` from the admission
    tick's expected-generation estimate — the EMA dict is the one piece of
    scheduler state crossing threads, hence its own lock."""

    def __init__(self, alpha: float = 0.25):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha {alpha} outside (0, 1]")
        self.alpha = alpha
        self._ema_lock = threading.Lock()   # guards: _ema
        self._ema: Dict[str, float] = {}

    def observe(self, tenant: str, sampled_tokens: int):
        """Feed one completed row's sampled-token count."""
        x = float(sampled_tokens)
        with self._ema_lock:
            prev = self._ema.get(tenant)
            self._ema[tenant] = x if prev is None else (
                self.alpha * x + (1.0 - self.alpha) * prev)

    def predict(self, tenant: str, budget: int) -> float:
        """Expected sampled length for a row of `tenant` with this budget.

        No history -> the full budget (pessimistic prior); with history the
        EMA, still capped by the budget (a row can never exceed it)."""
        with self._ema_lock:
            e = self._ema.get(tenant)
        return float(budget) if e is None else min(float(budget), e)

    def remaining(self, tenant: str, budget: int, sampled: int) -> float:
        """Predicted sampled tokens still to come for a (possibly replayed)
        row that has already sampled `sampled` of its `budget`."""
        return max(1.0, self.predict(tenant, budget) - float(sampled))


@dataclass
class _Entry:
    row: object          # duck-typed: .req.{task_id,priority,max_new_tokens},
                         # .sampled, .submit_index
    seq: int             # push order (FIFO key)
    enq_refill: int      # engine refill counter at push time (starvation age)


class SlotScheduler:
    """Ordered request queue for the continuous engine's free-slot refill."""

    def __init__(self, policy: str = "srpt",
                 predictor: Optional[LengthPredictor] = None,
                 starvation_k: int = 8):
        if policy not in POLICIES:
            raise ValueError(f"unknown scheduler policy {policy!r}; "
                             f"one of {POLICIES}")
        if starvation_k < 1:
            raise ValueError("starvation_k must be >= 1")
        self.policy = policy
        self.predictor = predictor or LengthPredictor()
        self.starvation_k = starvation_k
        self._entries: List[_Entry] = []
        self._seq = 0

    def __len__(self) -> int:
        return len(self._entries)

    def push(self, row, refill_count: int = 0):
        self._entries.append(_Entry(row, self._seq, refill_count))
        self._seq += 1

    def _key(self, e: _Entry, refill_count: int):
        if self.policy == "fifo":
            return (e.seq,)
        starved = (refill_count - e.enq_refill) >= self.starvation_k
        if starved:
            # starvation tier wins outright; FIFO among the starved
            return (0, e.seq, 0, 0, 0.0, 0)
        req = e.row.req
        rem = self.predictor.remaining(req.task_id, req.max_new_tokens,
                                       e.row.sampled)
        resume = 0 if getattr(e.row, "forced_q", None) else 1
        return (1, 0, -req.priority, resume, rem, e.row.submit_index)

    def pop(self, refill_count: int = 0, where=None):
        """Remove and return the highest-ranked row, or None if empty.

        `where` (optional row predicate) restricts the pop to matching
        rows — the paged engine uses it to keep snapshot-carrying rows out
        of the prefill/replay path (they restore on the decode thread) and
        vice versa; scheduling order among eligible rows is unchanged."""
        if not self._entries:
            return None
        idxs = (range(len(self._entries)) if where is None else
                [i for i in range(len(self._entries))
                 if where(self._entries[i].row)])
        if not idxs:
            return None
        best = min(idxs,
                   key=lambda i: self._key(self._entries[i], refill_count))
        return self._entries.pop(best).row

    def pop_if(self, refill_count: int = 0, pred=None):
        """Pop the highest-ranked row ONLY if it satisfies `pred`; returns
        None otherwise (queue untouched). Unlike ``pop(where=)`` this never
        jumps a matching row over better-ranked non-matching ones — the
        paged engine's restore path uses it so a snapshot-carrying row
        resumes when (and only when) it is genuinely next in line, never
        ahead of a higher-priority tenant's fresh rows."""
        if not self._entries:
            return None
        best = min(range(len(self._entries)),
                   key=lambda i: self._key(self._entries[i], refill_count))
        if pred is not None and not pred(self._entries[best].row):
            return None
        return self._entries.pop(best).row

    def pop_all(self) -> List:
        """Drain every queued row in current pop order (abort path)."""
        out = []
        while self._entries:
            out.append(self.pop())
        return out

    def tenants(self) -> frozenset:
        return frozenset(e.row.req.task_id for e in self._entries)

    def rows_for(self, task_id: str) -> List:
        """A tenant's queued rows (admission re-estimates read `.sampled`
        off preempted rows awaiting replay)."""
        return [e.row for e in self._entries if e.row.req.task_id == task_id]
