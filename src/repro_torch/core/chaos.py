"""Deterministic chaos injection.

Generalizes the trainer-only ``FailureInjector`` (core/runtime.py) to a
fault model covering every threaded stage: prefill-worker kills,
env-worker kills, transient/permanent tool errors, snapshot drops under
(simulated) host-memory pressure, and torn checkpoints (published
snapshot, crash before the LATEST pointer moves). Each fault site draws
from its OWN seeded RNG stream keyed ``(seed, site)`` and decisions are
consumed in event order, so a given workload replays the same fault
script run-to-run as long as the per-site event order is deterministic.
Cross-site interleaving (which worker thread rolls first) does not
perturb any other site's stream — that isolation is the point of
per-site streams.

Tests drive the matrix with rates of 0.0 / 1.0 plus ``max_faults_per_site``
caps, which is exact regardless of thread scheduling ("kill the first
prefill job's worker, then never again"). Every hook site guards
``chaos is None`` (and ``fire()`` early-outs on rate 0.0), so with chaos
off the fault paths cost one attribute check and the token stream is
byte-identical to a build without this module.

A copy of ``repro.core.chaos`` (plain Python). The injector's lock is
named ``_chaos_lock`` (the JAX package's is ``_lock``): the repo's
lock-order analyzer names a lock by class and attribute, and two classes
``ChaosInjector`` with the same lock attribute would shadow each other
there.
"""
from __future__ import annotations

import random
import threading
import zlib
from dataclasses import dataclass
from typing import Dict


class ChaosError(RuntimeError):
    """An injected infrastructure fault (torn checkpoint, ...). Derives
    from RuntimeError so existing crash/restart paths treat it exactly
    like the real failure it simulates."""


@dataclass
class ChaosConfig:
    """Per-stage fault rates (probability per opportunity, in [0, 1]).

    A "kill" rate is rolled once per job pickup and simulates the worker
    thread dying abruptly — no cleanup, its in-flight work stranded until
    the ``StageSupervisor`` recovers it. Tool-error rates are rolled once
    per episode tool call; a transient hit fails the same call
    ``transient_fail_count`` times before letting it through (exercising
    retry-then-succeed), a permanent hit fails it forever (exercising the
    tool_error episode outcome + circuit breaker). ``snapshot_drop``
    simulates host snapshot-budget pressure on park/preempt (the row
    falls back to token replay — output is identical, only slower).
    ``torn_checkpoint`` raises after a snapshot directory is published
    but before LATEST is updated."""
    seed: int = 0
    prefill_worker_kill: float = 0.0
    env_worker_kill: float = 0.0
    tool_error_transient: float = 0.0
    tool_error_permanent: float = 0.0
    transient_fail_count: int = 2
    snapshot_drop: float = 0.0
    torn_checkpoint: float = 0.0
    max_faults_per_site: int = 0       # per-site injection cap (0 = none)

    @property
    def enabled(self) -> bool:
        return any(r > 0 for r in (
            self.prefill_worker_kill, self.env_worker_kill,
            self.tool_error_transient, self.tool_error_permanent,
            self.snapshot_drop, self.torn_checkpoint))


# the fault sites fire() accepts — each maps to its ChaosConfig rate field
SITES = ("prefill_worker_kill", "env_worker_kill", "tool_error_transient",
         "tool_error_permanent", "snapshot_drop", "torn_checkpoint")


class ChaosInjector:
    """Thread-safe fault dice shared by all stages of one runtime."""

    def __init__(self, cfg: ChaosConfig):
        self.cfg = cfg
        self._chaos_lock = threading.Lock()   # guards: _rngs/injected
        self._rngs: Dict[str, random.Random] = {}
        self.injected: Dict[str, int] = {}

    def fire(self, site: str) -> bool:
        """Roll `site`'s die: True -> inject the fault now. Counts every
        injection (``injected``) so tests and the chaos bench can assert
        faults actually happened."""
        if site not in SITES:
            raise ValueError(f"unknown chaos site {site!r}")
        rate = getattr(self.cfg, site)
        if rate <= 0:
            return False
        with self._chaos_lock:
            cap = self.cfg.max_faults_per_site
            if cap and self.injected.get(site, 0) >= cap:
                return False
            rng = self._rngs.get(site)
            if rng is None:
                # stable per-site stream: crc32, not hash() (salted per
                # process — it would de-determinize the script)
                rng = random.Random((self.cfg.seed << 32)
                                    ^ zlib.crc32(site.encode()))
                self._rngs[site] = rng
            hit = rng.random() < rate
            if hit:
                self.injected[site] = self.injected.get(site, 0) + 1
            return hit

    def counts(self) -> Dict[str, int]:
        with self._chaos_lock:
            return dict(self.injected)
