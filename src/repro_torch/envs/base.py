"""Verifiable-reward environments (paper §5 Datasets and Tasks).

Each env provides:
  sample_prompt(rng)          -> (prompt_token_ids, truth)  — data pipeline
  verify(truth, completion)   -> float reward in [0, 1]     — RLVR verifier
  tool_call(query_ids)        -> response_token_ids          — agentic only
  open_session(truth)         -> ToolSession                 — multi-turn
  latency profile             — env-interaction latency (real: sleep;
                                 sim: virtual seconds), the paper's external
                                 tool/judge latency source.

Multi-turn episode protocol: an agentic episode may emit ``tok.CALL`` up to
``max_turns`` times (0 = unlimited). Each episode owns ONE ``ToolSession``
— a stateful per-episode tool endpoint (REPL register, progressive-reveal
oracle, hop counter, ...) created lazily at the first call and carried with
the row across preemption/parking, so sessions survive slot eviction and
replay. Sessions must be deterministic functions of their call sequence:
replay never re-executes past calls (responses already live in the
generated prefix as force-fed tokens), so determinism is what keeps
preempt-at-any-turn replay token-for-token exact.

Rewards are *graded* (fraction-correct) rather than binary so GRPO groups
have variance from step one; exact-match is reported separately.

A copy of ``repro.envs.base``: the port keeps its own so that it imports nothing
of the JAX package.
"""
from __future__ import annotations

import abc
import inspect
import random
import threading
from typing import List, Optional, Sequence, Tuple

from repro_torch.data import tokenizer as tok


class ToolError(RuntimeError):
    """A tool/environment endpoint failure during a session call (ISSUE
    10). Unlike an arbitrary exception — which is a BUG in our stack and
    stays fatal — a ToolError is an expected operational outcome of
    talking to external tools, and the env stage handles it as one:
    ``TransientToolError`` is retried with exponential backoff + jitter
    (capped per call and per episode), ``PermanentToolError`` (or an
    exhausted retry budget) finishes the episode with
    ``finish_reason="tool_error"`` — counted, never trained, and feeding
    the per-tenant circuit breaker."""


class TransientToolError(ToolError):
    """Retryable: rate limit, timeout, flaky endpoint — try again."""


class PermanentToolError(ToolError):
    """Non-retryable: malformed query, dead endpoint — fail the episode."""


class CancelToken:
    """Cooperative cancellation for in-flight tool calls (ISSUE 5
    satellite, ROADMAP PR-4 follow-on).

    A timed-out/evicted call used to run to completion with its result
    discarded — the worker (EnvWorker or shared-pool thread) stayed busy
    for the full env latency. The engine now hands every dispatched call a
    token: cancelling it (a) interrupts the latency sleep immediately
    (``wait`` returns True) and (b) lets long-running sessions bail out
    mid-call by checking ``cancelled`` between steps. Thread-safe; cancel
    is idempotent."""

    def __init__(self):
        self._ev = threading.Event()

    def cancel(self):
        self._ev.set()

    @property
    def cancelled(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Interruptible sleep: returns True the moment the token is
        cancelled, False after the full timeout elapsed uncancelled."""
        return self._ev.wait(timeout)


def call_session(session: "ToolSession", query_ids: Sequence[int],
                 cancel: Optional[CancelToken] = None) -> List[int]:
    """Invoke a session's ``call``, forwarding the cancellation token when
    the session accepts one (user-defined sessions predating the token
    keep working unchanged)."""
    if cancel is not None:
        try:
            params = inspect.signature(session.call).parameters
        except (TypeError, ValueError):
            params = {}
        if "cancel" in params or any(p.kind == p.VAR_KEYWORD
                                     for p in params.values()):
            return session.call(query_ids, cancel=cancel)
    return session.call(query_ids)


class ToolSession:
    """One episode's stateful tool endpoint.

    The default session is a stateless adapter over ``env.tool_call`` —
    every call re-derives the response from the full query. Stateful envs
    subclass and keep per-episode state across ``call``s (`self.turns`
    counts completed calls). ``cancel`` (when provided) is a cooperative
    ``CancelToken``: long-running sessions should poll ``cancel.cancelled``
    between expensive steps and return early — the result of a cancelled
    call is discarded by the engine."""

    def __init__(self, env: "Env", truth):
        self.env = env
        self.truth = truth
        self.turns = 0

    def call(self, query_ids: Sequence[int],
             cancel: Optional[CancelToken] = None) -> List[int]:
        self.turns += 1
        if cancel is not None and cancel.cancelled:
            return []
        return self.env.tool_call(query_ids, self.truth)


class Env(abc.ABC):
    name: str = "env"
    is_agentic: bool = False
    max_new_tokens: int = 16
    max_turns: int = 0           # tool turns per episode (0 = unlimited)
    # latency model for environment interaction (seconds)
    env_latency_mean: float = 0.0
    env_latency_std: float = 0.0

    @abc.abstractmethod
    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], object]:
        ...

    @abc.abstractmethod
    def verify(self, truth, completion_ids: Sequence[int]) -> float:
        ...

    def tool_call(self, query_ids: Sequence[int], truth=None) -> List[int]:
        raise NotImplementedError

    def open_session(self, truth) -> ToolSession:
        """A fresh per-episode tool session (called once per episode, at
        the first tool call). Stateful envs return their own subclass."""
        return ToolSession(self, truth)

    def sample_env_latency(self, rng: random.Random) -> float:
        if self.env_latency_mean <= 0:
            return 0.0
        return max(0.0, rng.gauss(self.env_latency_mean, self.env_latency_std))


def _answer_after_tools(completion_ids: Sequence[int]) -> List[int]:
    """The episode's final answer: tokens after the LAST force-fed tool
    response (multi-turn episodes interleave several RESP…ENDRESP blocks;
    only what the policy says after the last one is graded)."""
    ids = [int(i) for i in completion_ids]
    while tok.ENDRESP in ids:
        ids = ids[ids.index(tok.ENDRESP) + 1:]
    return ids


def _answer_reward(expected: str, completion_ids: Sequence[int]) -> float:
    """Graded reward: per-char match fraction up to EOS; exact bonus."""
    ids = []
    for i in completion_ids:
        if int(i) == tok.EOS:
            break
        ids.append(int(i))
    got = tok.decode(ids)
    if not expected:
        return 0.0
    if got == expected:
        return 1.0
    hits = sum(1 for a, b in zip(got, expected) if a == b)
    frac = hits / max(len(expected), len(got) or 1)
    return 0.8 * frac
