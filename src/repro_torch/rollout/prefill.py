"""The prefill stage's shape bucketing and per-row sampling rule (the part of
``repro.rollout.prefill`` that ``RolloutEngine.generate`` uses). The
disaggregated prefill workers are not ported yet."""
from __future__ import annotations

import torch

from . import prng


def _bucket_len(n: int) -> int:
    return int(max(8, -(-int(n) // 8) * 8))


def _sample_rows(logits, keys, counters, temps):
    """Per-row categorical: row i uses fold_in(keys[i], counters[i]).

    logits [B, V] float32; keys [B, 2] int64 (uint32 words); counters [B];
    temps [B] float32. The sample depends only on the row's own
    (key, count, logits) — not on batch width or slot position — and
    reproduces the JAX package's tokens (``rollout/prng.py``)."""
    scaled = logits / torch.clamp_min(temps[:, None], 1e-4)
    return prng.categorical(prng.fold_in(keys, counters.to(torch.int64)),
                            scaled)
