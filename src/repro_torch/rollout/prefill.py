"""The disaggregated prefill stage (paper §4.1, Fig. 5); port of
``repro.rollout.prefill``.

The continuous engine's fused refill prefills every incoming row on the
decode thread, so a long prompt stalls decode for every resident tenant: the
cross-task interference the disaggregated layout removes. This module is the
prefill side of the split:

``PrefillWorker`` — a daemon thread (the engine starts ``prefill_workers``
of them when ``disagg_prefill=True``). Each worker pops scheduler-ordered
rows from the engine's cross-task queue, prefills them on its OWN width-1
cache (never the decode pool) and emits a ``ReadyRow`` (the cache, the first
token and its logprob) into the engine's ready queue; the decode thread
installs ready rows with a copy-only splice (``engine._build_splice_fn``).

Streams: on the card each worker launches on a CUDA stream of its own, so the
decode thread never waits on the device for a prefill. A ``ReadyRow`` carries
an event recorded after its last kernel; the decode stream waits on it before
the splice and marks the worker's cache as used by the decode stream, so
its memory is not reused before the splice has read it. Prefill attention is
plain PyTorch: a worker never launches a decode-attention kernel (their
merge tickets are shared per card).

Chunked prefill: rows longer than ``prefill_chunk`` run in fixed-size chunks
through ``forward_prefill_chunk``, and each worker round-robins its
in-flight jobs chunk by chunk, so one huge prompt cannot monopolize the
stage. The chunk is rounded up to a multiple of 8 (``effective_chunk``).

Determinism: the first token is sampled from the final-position logits with
``fold_in(row key, init_counter)`` (0 for fresh rows, ``len(gen)`` for
replayed ones), the rule the fused refill applies, so the disaggregated
output is the fused path's (and one-shot ``generate()``'s) token for token.

Env-stage resume jobs (``rollout/env_stage.py``) take the same path with
one difference: their first token is FORCED (the ``RESP`` opener of the tool
response), its logprob read off the same logits. With the paged cache a
resume that runs as one whole-sequence call folds its entire forced
``RESP … ENDRESP`` block into the prefill (response-prefill fusion): the
logprob of each forced token comes off the hidden state at the position
that predicts it, and the first token is a true sample past the block.

Chaos (``prefill_worker_kill``): a killed worker returns at once and strands
its claimed rows, whose chunked jobs may still have kernels in flight on its
stream. It records an event on that stream as it dies; the supervisor's
recovery (``engine._recover_prefill_claims``) makes the decode thread's
stream wait on the event and only then drops the stranded caches and
requeues the rows, so the dead stream's writes are ordered before any
reuse. The rows prefill again from scratch on a live worker's stream.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.lora.adapters import batched_ctx
from repro_torch.models import (forward_prefill_chunk, forward_seq,
                                init_cache, lm_logits, tree_leaves)

from . import prng


def _bucket_len(n: int) -> int:
    return int(max(8, -(-int(n) // 8) * 8))


def _round_up(n: int, m: int) -> int:
    return -(-int(n) // m) * m


def _sample_rows(logits, keys, counters, temps):
    """Per-row categorical: row i uses fold_in(keys[i], counters[i]).

    logits [B, V] float32; keys [B, 2] int64 (uint32 words); counters [B];
    temps [B] float32. The sample depends only on the row's own
    (key, count, logits) — not on batch width or slot position — and
    reproduces the JAX package's tokens (``rollout/prng.py``)."""
    scaled = logits / torch.clamp_min(temps[:, None], 1e-4)
    return prng.categorical(prng.fold_in(keys, counters.to(torch.int64)),
                            scaled)


def _log_softmax_at(logits, idx):
    return torch.gather(torch.log_softmax(logits, dim=-1), 1,
                        idx[:, None].long())[:, 0]


def effective_chunk(cfg: ModelConfig, chunk: int) -> int:
    """Round a requested prefill chunk up so chunked == whole-prompt:
    a multiple of 8 (the prompt buckets) and, for recurrent families, of the
    SSD scan chunk (the port has none yet: ``cfg.ssm`` is None). 0 keeps
    chunking off (whole-prompt prefill calls)."""
    if chunk <= 0:
        return 0
    c = _bucket_len(chunk)
    if cfg.ssm is not None:
        s = cfg.ssm.chunk_size
        c = -(-c // s) * s
    return c


class PrefillKernels:
    """The prefill stage's step functions (shared by all workers), plain
    closures over the model as the engine's step functions are.

    ``whole``  — one-call prefill of a full (bucketed) sequence on a fresh
                 width-1 cache ``width`` entries wide; returns (first token,
                 logprob, fused-block logprobs or None, cache).
    ``chunk``  — one fixed-size chunk at offset `start` through
                 ``forward_prefill_chunk``; returns (hidden, cache).
    ``finish`` — final-position logits and the first-token pick off the
                 last chunk's hidden states.
    """

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg

        def pick(logits, keys, init_counters, temps, forced, forced_mask):
            sampled = _sample_rows(logits, keys, init_counters, temps)
            first = torch.where(forced_mask > 0, forced.long(),
                                sampled).to(torch.int32)
            return first, _log_softmax_at(logits, first)

        def whole(params, adapters, row_ids, tokens, seq_len: int, width: int,
                  init_counters, keys, temps, forced, forced_mask, fpos=None,
                  ftoks=None):
            pcache = init_cache(cfg, 1, width, device=tokens.device)
            lora = batched_ctx(adapters, row_ids, cfg)
            h, pcache, _ = forward_seq(params, tokens, cfg, lora, pcache)
            first, lp = pick(lm_logits(h[:, seq_len - 1], params, cfg), keys,
                             init_counters, temps, forced, forced_mask)
            flp = None
            if fpos is not None:
                # response-prefill fusion: each forced token's logprob off
                # the logits at the position that predicts it, the values
                # the step-wise force-feed would record
                flp = _log_softmax_at(lm_logits(h[0, fpos], params, cfg),
                                      ftoks)
            return first, lp, flp, pcache

        def chunk(start: int, params, adapters, row_ids, tokens, pcache):
            lora = batched_ctx(adapters, row_ids, cfg)
            return forward_prefill_chunk(params, tokens, cfg, lora, pcache,
                                         start=start)

        def finish(params, h, last_idx: int, keys, init_counters, temps,
                   forced, forced_mask):
            return pick(lm_logits(h[:, last_idx], params, cfg), keys,
                        init_counters, temps, forced, forced_mask)

        self.whole = whole
        self.chunk = chunk
        self.finish = finish

    def fresh_cache(self, width: int, device):
        return init_cache(self.cfg, 1, width, device=device)


@dataclass
class ReadyRow:
    """A prefilled row awaiting its splice into the pool."""
    row: object              # engine _Row (host-side state)
    seq_len: int             # prompt (+ replayed prefix) length == cache pos
    first: int               # first token (counter = init_counter)
    lp: float                # its logprob
    init_counter: int        # len(gen) at prefill time (0 for fresh rows)
    pcache: dict             # width-1 cache to splice
    ready_at: float          # queue timestamp: splice latency = now - this
    forced_first: bool = False   # env-stage resume: `first` is the forced
                                 # RESP opener (loss_mask 0), not a sample
    forced_lps: List[float] = field(default_factory=list)
                             # response-prefill fusion: logprobs of the
                             # whole forced RESP…ENDRESP block, prefilled
                             # in the same call (seq_len includes them and
                             # `first` samples AFTER the block)
    event: Optional[object] = None   # CUDA event after the row's last
                                     # kernel on the worker's stream (None
                                     # on the CPU)


class _Job:
    """One in-flight prefill: host progress of a chunked row."""
    __slots__ = ("row", "seq", "L", "pcache", "done", "chunks", "spent",
                 "fused", "h")

    def __init__(self, row, fused: int = 0):
        self.row = row
        self.seq = list(row.req.prompt) + row.gen
        self.fused = fused           # forced tokens folded into the prefill
        if fused:
            self.seq += row.forced_q[:fused]
        self.L = len(self.seq)
        self.pcache = None
        self.done = 0
        self.chunks = 0
        self.spent = 0.0
        self.h = None                # the last chunk's hidden states


class PrefillWorker(threading.Thread):
    """Prefill worker: pops scheduler-ordered rows from the engine's queue,
    runs (chunked) prefill on its own caches and stream, emits ReadyRows.

    Backpressure: workers pop only while ready + in-flight rows stay under
    ``max_slots + prefill_workers``, which bounds the extra device memory at
    O(max_slots) caches and the priority inversion at that lookahead.
    Workers round-robin their jobs one chunk at a time.
    """

    def __init__(self, engine, worker_id: int = 0):
        super().__init__(daemon=True, name=f"prefill-worker-{worker_id}")
        self.eng = engine
        self.worker_id = worker_id
        self.last_beat = time.monotonic()  # liveness heartbeat (supervisor)
        self.claimed: List = []  # rows popped but not yet emitted (mutated
                                 # under eng._queue_lock); requeued by the
                                 # supervisor if this worker dies
        self.chaos_killed = False
        self.death_event = None  # chaos kill: recorded on self.stream
        self.stranded: List[_Job] = []   # chaos kill: the jobs (and their
                                         # caches) left for the recovery
        dev = engine.device
        self.stream = (torch.cuda.Stream(device=dev) if dev.type == "cuda"
                       else None)

    # -- queue interaction (under the engine's queue lock) -----------------
    def _try_pop(self):
        eng = self.eng
        if eng._stacked is None:     # no adapter buffer yet: nothing to
            return None              # prefill against (rows keep queued)
        with eng._queue_lock:
            backlog = len(eng._ready) + len(eng._stage_inflight)
            if backlog >= eng.max_slots + eng.prefill_workers:
                return None
            if not eng._sched:
                return None
            # snapshot-carrying and device-parked rows never prefill: the
            # decode thread splices their saved state back. Radix candidates
            # and GRPO siblings of rows already in this stage also stay
            # queued: the decode thread installs them as shared-page suffix
            # prefills (a sibling popped here would pay a full private
            # prefill the index was about to save).
            where = None
            if eng.resume_restore or eng.prefix_cache:
                radix = eng._radix_on()
                seen = set()
                if radix:
                    seen = {eng._group_key(r) for r in eng._stage_inflight}
                    seen |= {eng._group_key(rr.row) for rr in eng._ready}

                def where(r):
                    if r.snap is not None or r.dev_pages is not None:
                        return False
                    if radix and eng._radix_candidate(r) is not None:
                        return False
                    if radix and len(r.req.prompt) >= eng.kv_page_size \
                            and eng._group_key(r) in seen:
                        return False
                    return True
            row = eng._sched.pop(eng.stats.refills, where=where)
            if row is not None:
                eng._stage_inflight.append(row)
                self.claimed.append(row)
        if row is not None and eng._tracer is not None:
            eng._tracer.mark(eng._trace_of(row), "prefill")
        return row

    def _emit(self, job: _Job, first: int, lp: float,
              forced_lps: Optional[List[float]] = None):
        eng = self.eng
        event = None
        if self.stream is not None:
            event = torch.cuda.Event()
            event.record(self.stream)
        ready = ReadyRow(row=job.row, seq_len=job.L, first=first, lp=lp,
                         init_counter=len(job.row.gen) + job.fused,
                         pcache=job.pcache, ready_at=time.monotonic(),
                         forced_first=bool(job.row.forced_q)
                         and not job.fused,
                         forced_lps=forced_lps or [], event=event)
        if eng._tracer is not None:
            eng._tracer.mark(eng._trace_of(job.row), "ready", ready.ready_at)
        with eng._queue_lock:
            if job.row in self.claimed:
                self.claimed.remove(job.row)
            if job.row not in eng._stage_inflight:
                return    # aborted by drain() while we were prefilling
            eng._stage_inflight.remove(job.row)
            eng._ready.append(ready)
            eng.stats.prefill_seconds += job.spent
            eng.stats.prefill_tokens += job.L
            eng.stats.prefill_chunks += job.chunks

    # -- device calls ------------------------------------------------------
    def _advance(self, job: _Job) -> bool:
        """Run ONE prefill call for `job` (whole sequence, or the next
        chunk); returns True when the job is complete."""
        eng = self.eng
        ker = eng._pkernels
        params = eng.base_params
        # the buffer of this moment: set_adapters replaces the reference
        # (copy on write) in disaggregated mode, so a call in flight keeps
        # the adapters it started with
        stacked = eng._stacked
        row = job.row
        t = eng._tensor
        row_id = t([row.req.adapter_index], torch.int32)
        key = t(row.key[None].astype(np.int64), torch.int64)
        temp = t([row.req.temperature], torch.float32)
        counter = t([len(row.gen) + job.fused], torch.int32)
        # env-stage resume: the first spliced token is the forced RESP
        # opener (the response follows by force-feed) unless the job fused
        # the whole forced block into its sequence: then `first` is a true
        # sample past the block
        forced_first = bool(row.forced_q) and not job.fused
        forced = t([row.forced_q[0] if forced_first else 0], torch.int32)
        fmask = t([1 if forced_first else 0], torch.int32)
        C = eng._prefill_chunk_eff
        page = eng.kv_page_size if eng.paged_kv else 1
        t0 = time.monotonic()

        def booked(done: bool) -> bool:
            if self.stream is not None:
                # the stacked buffer was made on the decode thread's stream:
                # its memory must not be reused before this stream is done
                for leaf in tree_leaves(stacked):
                    leaf.record_stream(self.stream)
            now = time.monotonic()
            job.spent += now - t0
            if eng.on_stage is not None:
                eng.on_stage("prefill", row.req.task_id, t0, now)
            if eng._tracer is not None:
                # one span per (chunk or whole-sequence) call, on this
                # worker's own track
                eng._tracer.span(
                    ("prefill", f"worker-{self.worker_id}"),
                    row.req.task_id, t0, now, trace=eng._trace_of(row))
            return done

        if C == 0 or job.L <= C:
            Lb = _bucket_len(job.L)
            toks = np.zeros((1, Lb), np.int32)
            toks[0, :job.L] = job.seq
            F = job.fused
            fpos = ftoks = None
            if F:
                L0 = job.L - F
                fpos = t(np.arange(L0 - 1, L0 - 1 + F), torch.int64)
                ftoks = t(job.seq[L0:], torch.int64)
            first, lp, flp, job.pcache = ker.whole(
                params, stacked, row_id, t(toks, torch.int32), job.L,
                _round_up(Lb, page), counter, key, temp, forced, fmask, fpos,
                ftoks)
            eng.forward_counts["prefill_whole"].add(1)
            job.chunks += 1
            first = int(first.cpu()[0])
            lp = float(lp.float().cpu()[0])
            flps = [float(x) for x in flp.float().cpu()] if F else None
            booked(True)
            self._emit(job, first, lp, flps)
            return True
        if job.pcache is None:
            job.pcache = ker.fresh_cache(
                _round_up(_round_up(job.L, C), page), eng.device)
        start = job.done
        end = min(start + C, job.L)
        toks = np.zeros((1, C), np.int32)
        toks[0, :end - start] = job.seq[start:end]
        job.h, job.pcache = ker.chunk(start, params, stacked, row_id,
                                      t(toks, torch.int32), job.pcache)
        eng.forward_counts["prefill_chunk"].add(1)
        job.done = end
        job.chunks += 1
        if end < job.L:
            return booked(False)
        first, lp = ker.finish(params, job.h, job.L - 1 - start, key, counter,
                               temp, forced, fmask)
        job.h = None
        first = int(first.cpu()[0])
        lp = float(lp.float().cpu()[0])
        booked(True)
        self._emit(job, first, lp)
        return True

    def _die(self, jobs: Deque[_Job]):
        """Simulated abrupt death (chaos): no requeue. The claimed rows
        stay stranded in ``_stage_inflight`` until the supervisor's
        recovery requeues them; the event on this stream lets the recovery
        order the stream's in-flight writes before the caches are freed."""
        self.chaos_killed = True
        self.stranded = list(jobs)
        if self.stream is not None:
            self.death_event = torch.cuda.Event()
            self.death_event.record(self.stream)

    # -- main loop ---------------------------------------------------------
    def run(self):
        eng = self.eng
        jobs: Deque[_Job] = deque()
        stream = (torch.cuda.stream(self.stream) if self.stream is not None
                  else contextlib.nullcontext())
        # grad modes are thread-local: this thread serves without autograd
        with torch.no_grad(), stream:
            try:
                while not eng._stage_stop.is_set():
                    self.last_beat = time.monotonic()
                    row = self._try_pop()
                    if row is not None and eng._chaos is not None \
                            and eng._chaos.fire("prefill_worker_kill"):
                        self._die(jobs)
                        return
                    if row is not None:
                        # response-prefill fusion: fold a resume's whole
                        # forced block into the prefill when the job runs as
                        # ONE whole-sequence call (chunked jobs keep the
                        # step-wise force-feed)
                        C = eng._prefill_chunk_eff
                        L_f = row.prompt_len + len(row.gen) + len(row.forced_q)
                        fuse = (eng.paged_kv and eng._fusable_forced(row)
                                and (C == 0 or L_f <= C))
                        jobs.append(_Job(row, fused=len(row.forced_q)
                                         if fuse else 0))
                    if not jobs:
                        time.sleep(0.0005)
                        continue
                    job = jobs.popleft()         # round-robin: one chunk each
                    try:
                        if not self._advance(job):
                            jobs.append(job)
                    except BaseException as e:   # surfaced on the engine thread
                        eng._stage_error = e
                        jobs.append(job)         # keep the row accounted for
                        break
            finally:
                # hand unfinished rows back so that abort/drain accounting
                # sees them (rows drain() already swept out of
                # _stage_inflight were aborted there: dropping them keeps
                # one completion each); a chaos-killed worker strands its
                # rows on purpose: the supervisor's recovery is under test
                if not self.chaos_killed:
                    with eng._queue_lock:
                        for job in jobs:
                            if job.row in eng._stage_inflight:
                                eng._stage_inflight.remove(job.row)
                                eng._sched.push(job.row, eng.stats.refills)
                            if job.row in self.claimed:
                                self.claimed.remove(job.row)
