"""Trajectory containers flowing through Q_buffer (paper §4.2/§4.4); a copy
of ``repro.rl.types`` (numpy only).

A ``TrajectoryBatch`` is one task's rollout batch: prompts + generated
completions, per-token logprobs sampled under policy version ``version``,
and verifiable rewards from the environment. GRPO groups are contiguous:
rows [g*G, (g+1)*G) share a prompt.

``RolloutCompletion`` is the unit the continuous-batching engine emits:
one finished request with its slot/timing metadata, streamed back to the
scheduler as soon as the row evicts (no round barrier). A task's round of
completions is packed into a ``TrajectoryBatch`` once all its rows arrive.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np


@dataclass
class RolloutCompletion:
    """One finished rollout request, as evicted from a decode slot."""
    task_id: str
    prompt_len: int
    tokens: List[int]                 # prompt + completion
    gen_logprobs: List[float]         # per generated token, under π_v
    gen_loss_mask: List[float]        # 0.0 on force-fed (tool-response) tokens
    truth: Any
    env: Any
    finish_reason: str = ""           # eos|budget|capacity|turn_limit|
                                      # tool_timeout|tool_error|straggler|
                                      # aborted
    slot: int = -1                    # decode slot the row occupied
    version: int = -1                 # adapter version that generated the
                                      # row (the behaviour version for the
                                      # trainer's staleness admission check)
    sampled_tokens: int = 0           # tokens charged to max_new_tokens
    forced_tokens: int = 0            # force-fed tokens (budget-exempt)
    submit_index: int = -1            # engine-global submission order
    submitted_at: float = 0.0
    started_at: float = 0.0           # prefill/splice time (slot acquired)
    finished_at: float = 0.0          # eviction time
    finished_step: int = 0            # engine decode-step counter at eviction
    meta: Dict[str, Any] = field(default_factory=dict)

    def to_result(self) -> Dict[str, Any]:
        """The per-request result dict `generate()` returns."""
        return {
            "task_id": self.task_id,
            "prompt_len": self.prompt_len,
            "tokens": list(self.tokens),
            "gen_logprobs": list(self.gen_logprobs),
            "gen_loss_mask": list(self.gen_loss_mask),
            "truth": self.truth,
            "env": self.env,
            "finish_reason": self.finish_reason,
        }


@dataclass
class TrajectoryBatch:
    task_id: str
    version: int                 # policy version v that generated these rows
    tokens: np.ndarray           # [R, S] int32 — prompt + completion, padded
    prompt_lens: np.ndarray      # [R] int32
    total_lens: np.ndarray       # [R] int32 (prompt + completion)
    rewards: np.ndarray          # [R] float32 (verifier output)
    group_size: int              # G — rows per GRPO group
    behavior_logprobs: Optional[np.ndarray] = None  # [R, S-1] under π_v
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def num_rows(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def num_groups(self) -> int:
        return self.num_rows // self.group_size

    def completion_mask(self) -> np.ndarray:
        """[R, S] 1.0 where position is a *generated* token (loss positions).

        Loss sits on positions predicting tokens [prompt_len, total_len):
        position j predicts token j+1, so mask[j] = prompt_len-1 <= j < total-1.
        """
        R, S = self.tokens.shape
        idx = np.arange(S)[None, :]
        lo = (self.prompt_lens - 1)[:, None]
        hi = (self.total_lens - 1)[:, None]
        return ((idx >= lo) & (idx < hi)).astype(np.float32)
