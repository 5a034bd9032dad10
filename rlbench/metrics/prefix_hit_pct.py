"""Prompt tokens served from the prefix cache over prompt tokens admitted in
the window (the engine's ``prefix_hit_tokens`` over those plus
``prefill_tokens``), in %."""
from rlbench.harness import measure as m


def read(st):
    hit = m.delta(st, "prefix_hit_tokens")
    new = m.delta(st, "prefill_tokens")
    return None if hit + new <= 0 else 100.0 * hit / (hit + new)
