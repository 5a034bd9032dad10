"""Multi-LoRA rollout engines (paper §4.1/§4.4/§4.5); port of
``repro.rollout.engine``.

Two engines share one decode-step body and one per-row sampling rule:

``RolloutEngine.generate()`` — the round-fused baseline. One fixed batch of
cross-task requests runs to completion: one batched prefill, then a loop of
decode steps; every row waits for the slowest.

``ContinuousRolloutEngine`` — the slot model. A persistent pool of
``max_slots`` decode slots holds rows from any tenant, each tagged with an
adapter id into a fixed-capacity stacked-LoRA buffer. Decode is one step
over the pool and never drains: a finished row (EOS / sampled budget /
cache capacity) is evicted, its ``RolloutCompletion`` streams back, and
freed slots are filled from a cross-task request queue, ordered by
``rollout/scheduler.py`` (SRPT with priority tiers and a starvation bound,
or FIFO). By default the fill is fused: the incoming rows prefill in one
batched call on the decode thread, and their cache state and first tokens
are written into the pool. With ``disagg_prefill=True`` the prefill runs on
``prefill_workers`` threads instead (``rollout/prefill.py``, each on a CUDA
stream of its own), and the decode thread only splices the finished rows in:
a copy, never a forward. Preemption (``preempt_tenant``/``preempt_slots``)
evicts resident rows mid-decode; a victim re-queues and later either replays
``prompt + gen`` through the prefill path with the counter it would have
used, or, with the paged cache and ``resume_restore``, has its live KV pages
kept (on the host or in the pool) and spliced back, with no replay. Either
way its tokens equal an uninterrupted run's.

Each row runs under its own tenant's LoRA adapter (the SGMV kernel on the
card) and samples from its own key (``fold_in(PRNGKey(seed), request.seed
or submission index)``, folded with the row's generated-token count), so a
row's tokens depend only on its own (key, counter, logits) and reproduce the
JAX engine's tokens from the same logits. Rows that emit ``tok.CALL`` are
frozen in their slot (advance 0) while their tool call runs on a thread
pool, then force-fed the response; forced tokens do not count against
``max_new_tokens``. With ``env_stage=True`` such a row is parked instead
(``rollout/env_stage.py``): its slot is vacated and refilled, its call runs
on ``env_workers`` threads, and the response re-queues the row as a resume
job that comes back through the restore or prefill path; with the paged
cache a resume that replays folds its whole forced block into its prefill
(response-prefill fusion). The tokens equal the frozen path's.

Paged KV cache (``paged_kv=True``): attention K/V live in a shared pool of
``kv_pool_pages`` pages of ``kv_page_size`` tokens (``rollout/kvcache.py``
owns the free list, ``models.init_paged_cache`` the device side); a slot
holds ``ceil(len/page)`` pages, growing one page at a time, and decode reads
them through per-slot block tables (the ``paged_gqa_decode`` kernel on the
card). A row the pool cannot serve finishes with ``capacity``.

Copy-on-write prefix cache (``prefix_cache=True``, the default with
``paged_kv``): rows share pool pages at three levels, with page refcounts
keeping ownership exact.
- GRPO groups: every installed prompt's pages (full pages and the partial
  tail) go into a per-adapter radix index (``PrefixIndex``); a sibling with
  the same prompt retains all of them, recomputes only the last chunk for
  its first-token logits and writes nothing. A row about to decode-write
  into a page with refcount > 1 first copies just that page to a fresh one
  (the COW fork), so earlier shared pages stay shared.
- Radix reuse: a row whose prompt shares page-aligned leading pages with an
  indexed one (a common system prompt) retains them and prefills only its
  suffix (``forward_prefill_chunk`` at the matched offset, over the matched
  pages gathered into a scratch cache).
- Device-resident parking: a preempted row keeps its pages in the pool;
  its resume re-attaches them to a slot and moves no K/V. Under pool
  pressure, allocation first drops the index's least recently used
  entries, then spills the oldest parked row to a host snapshot (or, past
  the snapshot budget, to token replay).
Either way a row's tokens equal those of the private-pages engine.

The step functions are plain Python closures over the model that write the
engine's cache and row-state tensors in place (the JAX engine's jitted calls
donate them instead); the engines keep them as attributes (``_step_fn``,
``_refill_fn``, ...) so that a test can wrap them, as the JAX engine's tests
do. Serving runs under ``torch.inference_mode()``. ``to_trajectory_batch``
packs one task's results for the trainer.

``abort_tenant`` ends every in-flight episode of one tenant (the runtime's
circuit breaker quarantines a tenant with it), ``queue_depths`` and
``env_depths`` read the stage queues, and ``supervisor`` is the engine's
``StageSupervisor``, which watches the prefill and env workers' liveness
from ``step``: the names the runtime reads.

Fault tolerance and tracing, as in the JAX engine: ``tracer`` (a
``repro_torch.obs.Tracer``) gets each episode's lifecycle marks and each
slot's, worker's and stage's spans, from timestamps the untraced code
already takes (a traced step launches and synchronises exactly what an
untraced one does); ``chaos`` (a ``ChaosInjector``) kills prefill and env
workers, fails tool calls and drops snapshots; ``supervise_wedge_s`` makes
the supervision tick poison an env worker that has run one job that long.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.core.supervisor import StageSupervisor
from repro_torch.data import tokenizer as tok
from repro_torch.envs.base import CancelToken, Env, ToolError, call_session
from repro_torch.kernels._build import LaunchCount
from repro_torch.lora.adapters import (batched_ctx, init_stacked_buffer,
                                       stack_adapters, write_adapter_slot)
from repro_torch.models import (decode_step, forward_prefill_chunk,
                                forward_seq, init_cache, init_paged_cache,
                                lm_logits, tree_map)
from repro_torch.models.common import resolve_device, synchronize
from repro_torch.models.model import n_attn_layers
from repro_torch.rl.types import RolloutCompletion, TrajectoryBatch
from repro_torch.rollout import prng
from repro_torch.rollout.kvcache import (KVSnapshot, PagePool, PrefixIndex,
                                         SnapshotStore, pages_for)
from repro_torch.rollout.env_stage import EnvStage
from repro_torch.rollout.prefill import (PrefillKernels, PrefillWorker,
                                         ReadyRow, _bucket_len,
                                         _log_softmax_at, _sample_rows,
                                         effective_chunk)
from repro_torch.rollout.scheduler import LengthPredictor, SlotScheduler


@dataclass
class RolloutRequest:
    task_id: str
    adapter_index: int            # row id into the stacked adapter tree
    prompt: List[int]
    truth: object
    env: Env
    max_new_tokens: int
    temperature: float = 1.0
    seed: Optional[int] = None    # per-row key = fold_in(master, seed)
                                  # (defaults to batch/submission index)
    priority: int = 0             # scheduler tier: higher pops first and is
                                  # never chosen as a preemption victim over
                                  # a lower tier
    max_turns: Optional[int] = None   # tool-turn budget for this episode
                                      # (None -> env.max_turns; 0 = unlimited)


@dataclass
class RolloutStats:
    """Engine counters, the JAX package's fields (so that both packages'
    stats compare field by field). ``generate`` fills the first group; the
    continuous engine fills the extras."""
    decode_steps: int = 0
    prefill_tokens: int = 0
    decode_seconds: float = 0.0     # decode-stage time only (host clock
                                    # from the decode stream drained to
                                    # the step's tokens on the host)
    prefill_seconds: float = 0.0    # prefill-stage time (fused refill OR
                                    # prefill-worker calls)
    env_wait_seconds: float = 0.0
    wall_seconds: float = 0.0
    # continuous-engine extras (zero for round-fused generate())
    prefills: int = 0
    refills: int = 0
    completions: int = 0
    tokens_generated: int = 0
    sampled_tokens: int = 0
    occupied_row_steps: int = 0    # sum over decode steps of advanced rows
    capacity_row_steps: int = 0    # decode_steps x max_slots
    preemptions: int = 0           # rows evicted mid-decode and re-queued
    replays: int = 0               # preempted rows re-prefilled into a slot
    replay_tokens: int = 0         # prompt+prefix tokens re-processed
    # disaggregated-prefill extras
    splices: int = 0               # ready rows copied into slots
    splice_seconds: float = 0.0    # decode-side install time (splices and
                                   # restores)
    splice_wait_seconds: float = 0.0    # sum of (install time - prefill
                                        # ready time): the hand-off latency
                                        # between the two stages
    prefill_chunks: int = 0        # prefill-worker calls (>= rows)
    decode_stall_seconds: float = 0.0   # prefill-stage work executed on the
                                        # decode thread (fused refill, radix
                                        # installs); 0 when disaggregated
    # env-stage extras
    parks: int = 0                 # rows vacated from their slot on CALL
    resumes: int = 0               # tool responses turned into resume jobs
    tool_errors: int = 0           # episodes finished by a permanent tool
                                   # failure or a spent retry budget
    # paged-KV / snapshot-restore extras (rollout/kvcache.py)
    restores: int = 0              # rows resumed by splicing saved KV pages
                                   # back (NO prefill replay ran)
    replay_tokens_saved: int = 0   # prompt+prefix tokens a replay would
                                   # have re-prefilled but restore skipped
    snapshots: int = 0             # preemption snapshots taken to host
    snapshot_drops: int = 0        # snapshots rejected under host memory
                                   # pressure (row fell back to replay)
    pool_exhausted: int = 0        # rows finished by cache-capacity
                                   # eviction when the page pool ran dry
    # prefix-cache extras
    prefix_hits: int = 0           # rows installed over indexed pages
    prefix_hit_tokens: int = 0     # prompt tokens those rows did not prefill
    cow_forks: int = 0             # shared pages copied before a write
    device_resident_resumes: int = 0   # restores from pages kept in-pool
    fused_forced_tokens: int = 0   # forced RESP…ENDRESP tokens folded into
                                   # a resume's prefill call instead of one
                                   # decode step each (response fusion)
    tool_wait_slot_steps: int = 0  # sum over decode steps of resident rows
                                   # frozen on a tool wait (0 with the env
                                   # stage)
    env_wait_by_task: Dict[str, float] = field(default_factory=dict)
                                   # per-tenant env-interaction wait seconds

    def add_env_wait(self, task_id: str, wait: float):
        """Book one resolved tool call's wait (global + per-tenant)."""
        self.env_wait_seconds += wait
        self.env_wait_by_task[task_id] = (
            self.env_wait_by_task.get(task_id, 0.0) + wait)

    def slot_utilization(self) -> float:
        if self.capacity_row_steps <= 0:
            return 0.0
        return self.occupied_row_steps / self.capacity_row_steps


def _sync_stream(device: torch.device):  # step: the step's wait
    """Wait for the calling thread's current stream only: the prefill
    workers' kernels run on streams of their own, and the decode thread
    neither waits for them nor books their time."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()  # noqa: RT202 (its job)


def _decode_sample_core(cfg, params, adapters, row_ids, cur_tokens, cache,
                        keys, counters, temps, forced, forced_mask, advance):
    # step: the decode step's body; tensors=params,adapters,row_ids,
    # cur_tokens,cache,keys,counters,temps,forced,forced_mask,advance
    """The one decode-step body: decode, sample, apply forced tokens."""
    lora = batched_ctx(adapters, row_ids, cfg)
    logits, cache = decode_step(params, cur_tokens, cache, cfg, lora,
                                advance=advance)
    sampled = _sample_rows(logits, keys, counters, temps)
    nxt = torch.where(forced_mask > 0, forced.long(), sampled).to(torch.int32)
    return nxt, _log_softmax_at(logits, nxt), cache


def _build_fns(cfg: ModelConfig):
    """The three step functions of the round-fused engine."""

    def prefill(params, adapters, row_ids, tokens, prompt_lens, cache):
        lora = batched_ctx(adapters, row_ids, cfg)
        h, cache, _ = forward_seq(params, tokens, cfg, lora, cache,
                                  seq_lens=prompt_lens)
        cache = dict(cache, pos=prompt_lens.to(torch.int32))
        rows = torch.arange(h.shape[0], device=h.device)
        last = h[rows, prompt_lens.long() - 1]
        return lm_logits(last, params, cfg), cache

    def first(logits, keys, counters, temps):
        sampled = _sample_rows(logits, keys, counters, temps)
        return sampled.to(torch.int32), _log_softmax_at(logits, sampled)

    def step(params, adapters, row_ids, cur_tokens, cache, keys, counters,
             temps, forced, forced_mask, advance):
        return _decode_sample_core(cfg, params, adapters, row_ids, cur_tokens,
                                   cache, keys, counters, temps, forced,
                                   forced_mask, advance)

    return prefill, first, step


def _build_cont_step_fn(cfg: ModelConfig):
    """Continuous-engine decode step with device-resident row state: the
    current tokens and per-row counters are carried through the call
    (frozen/empty lanes keep their previous token), so the host uploads
    nothing per step beyond the occasionally-changing advance/forced
    masks."""

    def step(params, adapters, row_ids, cur_tokens, cache, keys, counters,
             temps, forced, forced_mask, advance):
        # step: the continuous engine's step function; tensors=params,
        # adapters,row_ids,cur_tokens,cache,keys,counters,temps,forced,
        # forced_mask,advance
        nxt, lp, cache = _decode_sample_core(cfg, params, adapters, row_ids,
                                             cur_tokens, cache, keys,
                                             counters, temps, forced,
                                             forced_mask, advance)
        nxt = torch.where(advance > 0, nxt, cur_tokens)
        return nxt, lp, cache, counters + advance

    return step


def _prefill_first(cfg, params, adapters, tokens, prompt_lens, init_counters,
                   new_row_ids, new_keys, new_temps, forced, forced_mask,
                   pcache, fused=None):
    """Prefill a batch of incoming rows on a fresh scratch cache and pick
    each row's first token: sampled with its key at `init_counters` (0 for
    a fresh row, ``len(gen)`` for a replayed one), or forced. `fused`
    (response-prefill fusion): ``(rows, positions, tokens)`` of the forced
    tokens folded into the sequences, or None. Returns the first tokens
    [k], their logprobs [k] followed by the fused tokens' (off the logits at
    the positions that predict them, as a step-wise force-feed records
    them), and the cache."""
    lora = batched_ctx(adapters, new_row_ids, cfg)
    h, pcache, _ = forward_seq(params, tokens, cfg, lora, pcache,
                               seq_lens=prompt_lens)
    rows = torch.arange(h.shape[0], device=h.device)
    logits = lm_logits(h[rows, prompt_lens.long() - 1], params, cfg)
    sampled = _sample_rows(logits, new_keys, init_counters, new_temps)
    first = torch.where(forced_mask > 0, forced.long(),
                        sampled).to(torch.int32)
    lp = _log_softmax_at(logits, first)
    if fused is not None:
        f_rows, f_pos, f_toks = fused
        lp = torch.cat((lp, _log_softmax_at(
            lm_logits(h[f_rows, f_pos], params, cfg), f_toks)))
    return first, lp, pcache


def _cache_dtype(cache):
    """The model dtype a cache holds (K/V, or a recurrent family's conv)."""
    for name in ("kp", "k", "conv"):
        if name in cache:
            return cache[name].dtype
    raise KeyError("cache without K/V or conv state")


def refuse_encdec(cfg: ModelConfig):
    """Raise NotImplementedError for the encdec family: no engine of the
    JAX package serves it (they allocate its cross-attention cache but pass
    no ``enc_embeds``, and fail at the first prefill; ROADMAP §3). The family
    is served through ``launch.specs``'s prefill and decode step builders."""
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"{cfg.name}: the rollout engines do not serve the encdec family "
            f"(the JAX engines pass no enc_embeds to its encoder); serve it "
            f"through repro_torch.launch.specs.build_prefill_step and "
            f"build_decode_step (ROADMAP §3)")


def _layout(cfg: ModelConfig):
    """(kv, recurrent) of the family's cache: whether it holds attention
    K/V (``k``/``v``, or ``kp``/``vp`` + ``tbl`` when paged) and whether it
    holds per-row ``ssm``/``conv`` state. The one place that decides."""
    return n_attn_layers(cfg) > 0, cfg.ssm is not None


def _put_recurrent(cache, slots, ssm_rows, conv_rows):
    """Write recurrent rows (ssm [L, k, H, N, P], conv [L, k, ch, W-1], or
    one row without the k axis) into the pool at `slots`, in place."""
    cache["ssm"][:, slots] = ssm_rows.to(device=cache["ssm"].device,
                                         dtype=cache["ssm"].dtype)
    cache["conv"][:, slots] = conv_rows.to(device=cache["conv"].device,
                                           dtype=cache["conv"].dtype)


def _set_row_state(slots, first, counters_next, new_keys, new_temps,
                   new_row_ids, cur, counters, keys, temps, row_ids):
    """Write the incoming rows' device state at their slots, in place."""
    cur[slots] = first
    counters[slots] = counters_next
    keys[slots] = new_keys
    temps[slots] = new_temps
    row_ids[slots] = new_row_ids
    return cur, counters, keys, temps, row_ids


def _build_refill_fn(cfg: ModelConfig, max_len: int):
    """The fused refill on the dense cache: ONE call prefills the incoming
    rows on a width-k scratch cache, samples their first tokens, and writes
    every row's K/V into the pool at its slot (in place).

    The JAX engine pads the batch to a power-of-two width with ghost rows
    whose slot is out of bounds, so that XLA drops their scatters; the port
    runs eagerly and prefills only the real rows, so nothing is padded and
    every index is in bounds. The scratch cache holds the prompt bucket
    only: entries of a slot past the new row's length keep its previous
    occupant's values, which are masked (>= pos) and overwritten by decode
    before they are read."""
    kv, recurrent = _layout(cfg)

    def refill(params, adapters, tokens, prompt_lens, init_counters, slots,
               new_row_ids, new_keys, new_temps, forced, forced_mask, cache,
               cur, counters, keys, temps, row_ids):
        S = min(tokens.shape[1], max_len)
        pcache = init_cache(cfg, tokens.shape[0], tokens.shape[1],
                            dtype=_cache_dtype(cache), device=tokens.device)
        first, lp, pcache = _prefill_first(
            cfg, params, adapters, tokens, prompt_lens, init_counters,
            new_row_ids, new_keys, new_temps, forced, forced_mask, pcache)
        sl = slots.long()
        if kv:
            cache["k"][:, sl, :S] = pcache["k"][:, :, :S]
            cache["v"][:, sl, :S] = pcache["v"][:, :, :S]
        if recurrent:
            _put_recurrent(cache, sl, pcache["ssm"], pcache["conv"])
        cache["pos"][sl] = prompt_lens
        state = _set_row_state(sl, first, init_counters + 1, new_keys,
                               new_temps, new_row_ids, cur, counters, keys,
                               temps, row_ids)
        return first, lp, cache, state

    return refill


def _paged_scatter(cache, pcache_k, pcache_v, dest_pages, page: int):
    """Write a dense prefill scratch cache's K/V ([L, W, S, KVH, hd],
    S % page == 0) into the page pool, in place, at the physical pages named
    by ``dest_pages`` [W, S//page]. Sentinel entries all name the scratch
    page: several chunks may land there (harmless, it is never validly
    read), while a real page is named once."""
    L, W, S, KVH, hd = pcache_k.shape
    dest = dest_pages.reshape(W * (S // page)).long()
    cache["kp"][:, dest] = pcache_k.reshape(L, -1, page, KVH, hd).to(
        cache["kp"].dtype)
    cache["vp"][:, dest] = pcache_v.reshape(L, -1, page, KVH, hd).to(
        cache["vp"].dtype)


def _build_refill_fn_paged(cfg: ModelConfig, max_len: int, page: int):
    """Paged twin of ``_build_refill_fn``: the batched prefill still runs on
    a dense scratch cache (prefill is contiguous by nature; here the prompt
    bucket rounded up to whole pages), and each incoming row's K/V is
    written page by page into the physical pages the host allocator handed
    it (`dest_pages` [k, chunks], sentinel past the row's page count). Only
    ``ceil(seq_len/page)`` pages per row are consumed. Recurrent ssm/conv
    rows are per slot and dense, written as in the dense refill.

    Response-prefill fusion: an env-stage resume's forced RESP…ENDRESP
    block is part of ``tokens`` (the host appends it to prompt + prefix), so
    the whole response prefills in this call instead of one decode step a
    token; `fused` names the forced tokens (see ``_prefill_first``), and
    their logprobs follow the rows' in ``lp``."""
    kv, recurrent = _layout(cfg)

    def refill(params, adapters, tokens, prompt_lens, init_counters, slots,
               dest_pages, new_row_ids, new_keys, new_temps, forced,
               forced_mask, fused, cache, cur, counters, keys, temps,
               row_ids):
        pcache = init_cache(cfg, tokens.shape[0], dest_pages.shape[1] * page,
                            dtype=_cache_dtype(cache), device=tokens.device)
        first, lp, pcache = _prefill_first(
            cfg, params, adapters, tokens, prompt_lens, init_counters,
            new_row_ids, new_keys, new_temps, forced, forced_mask, pcache,
            fused)
        if kv:
            _paged_scatter(cache, pcache["k"], pcache["v"], dest_pages, page)
        sl = slots.long()
        if recurrent:
            _put_recurrent(cache, sl, pcache["ssm"], pcache["conv"])
        cache["pos"][sl] = prompt_lens
        state = _set_row_state(sl, first, init_counters + 1, new_keys,
                               new_temps, new_row_ids, cur, counters, keys,
                               temps, row_ids)
        return first, lp, cache, state

    return refill


def _build_splice_fn(cfg: ModelConfig, max_len: int):
    """Copy-only install of one worker-prefilled row into the dense pool
    (the decode half of the disaggregated split): the row's width-1 cache
    goes into the pool at `slot` (entries past the cache's width keep the
    previous occupant's values, masked and overwritten by decode, as in
    the fused refill), its recurrent ssm/conv rows replace the slot's, and
    the slot's device row state is written. No forward runs on the decode
    thread."""
    kv, recurrent = _layout(cfg)

    def splice(cache, pcache, slot: int, seq_len: int, first: int,
               init_counter: int, key, temp: float, row_id: int, cur,
               counters, keys, temps, row_ids):
        if kv:
            S = min(pcache["k"].shape[2], max_len)
            cache["k"][:, slot, :S] = pcache["k"][:, 0, :S]
            cache["v"][:, slot, :S] = pcache["v"][:, 0, :S]
        if recurrent:
            _put_recurrent(cache, slot, pcache["ssm"][:, 0],
                           pcache["conv"][:, 0])
        cache["pos"][slot] = seq_len
        state = _set_row_state(slot, first, init_counter + 1, key, temp,
                               row_id, cur, counters, keys, temps, row_ids)
        return cache, state

    return splice


def _build_splice_fn_paged(cfg: ModelConfig, page: int):
    """Paged twin of ``_build_splice_fn``: the row's width-1 worker cache
    is written page by page into the pool pages the allocator handed it
    (`dest_pages`, exactly ``ceil(seq_len/page)`` of them: none for ssm),
    and its recurrent rows into the slot. Still a copy, never a forward."""
    _, recurrent = _layout(cfg)

    def splice(cache, pcache, slot: int, dest_pages, seq_len: int,
               first: int, init_counter: int, key, temp: float, row_id: int,
               cur, counters, keys, temps, row_ids):
        n = dest_pages.shape[0]
        if n:
            L, _, _, KVH, hd = cache["kp"].shape
            dest = dest_pages.long()
            cache["kp"][:, dest] = pcache["k"][:, 0, :n * page].reshape(
                L, n, page, KVH, hd).to(cache["kp"].dtype)
            cache["vp"][:, dest] = pcache["v"][:, 0, :n * page].reshape(
                L, n, page, KVH, hd).to(cache["vp"].dtype)
        if recurrent:
            _put_recurrent(cache, slot, pcache["ssm"][:, 0],
                           pcache["conv"][:, 0])
        cache["pos"][slot] = seq_len
        state = _set_row_state(slot, first, init_counter + 1, key, temp,
                               row_id, cur, counters, keys, temps, row_ids)
        return cache, state

    return splice


def _build_snap_fn(cfg: ModelConfig):
    """Gather one resident row's cache state for a host snapshot: its live
    KV pages (none given: no K/V is copied) and, with ``slot``, its
    recurrent ssm/conv rows. Every array comes back as a CPU tensor in the
    cache's dtype: conv stays bf16 on a bf16 model (numpy has no bf16, and
    the restore copies it back bit for bit). The gather is a copy, taken
    before the pages and the slot are reused (the pool is written in place,
    so a view would be overwritten by the next owner)."""
    _, recurrent = _layout(cfg)

    def snap(cache, pages, slot=None):
        out = {}
        if pages is not None and pages.numel():
            idx = pages.long()
            out["kp"] = cache["kp"][:, idx].cpu()
            out["vp"] = cache["vp"][:, idx].cpu()
        if slot is not None and recurrent:
            # a copy also on the CPU, where .cpu() of a view is the view
            out["ssm"] = cache["ssm"][:, slot].to("cpu", copy=True)
            out["conv"] = cache["conv"][:, slot].to("cpu", copy=True)
        return out

    return snap


def _build_restore_fn(cfg: ModelConfig):
    """Splice a host snapshot back into the pool: its KV pages into the
    freshly allocated physical pages `dest_pages` (exactly ``n_pages`` of
    them), its recurrent ssm/conv rows into the slot, `pos` to the snapshot
    position, and the device row state to (pending token, counter); the
    next ordinary decode step then continues the row with the logits an
    uninterrupted run would produce. No prefill runs. A device-resident
    resume passes ``kpages=None``: its pages never left the pool, so only
    its recurrent rows (a hybrid's), `pos` and the row state move (the JAX
    engine writes a zero page stack into the scratch page instead)."""

    def restore(cache, kpages, vpages, dest_pages, slot, pos_val, ssm_row,
                conv_row, cur_tok, counter, key, temp, row_id, cur, counters,
                keys, temps, row_ids):
        if kpages is not None:
            dest = dest_pages.long()
            cache["kp"][:, dest] = kpages.to(device=cache["kp"].device,
                                             dtype=cache["kp"].dtype)
            cache["vp"][:, dest] = vpages.to(device=cache["vp"].device,
                                             dtype=cache["vp"].dtype)
        if ssm_row is not None:
            _put_recurrent(cache, slot, ssm_row, conv_row)
        cache["pos"][slot] = pos_val
        state = _set_row_state(slot, cur_tok, counter, key, temp, row_id,
                               cur, counters, keys, temps, row_ids)
        return cache, state

    return restore


def _build_cow_fn(cfg: ModelConfig):
    """Copy-on-write fork of ONE page: copy physical page `src` to the
    freshly allocated page `dst` in every layer, in place. It runs before
    the decode step that writes into the page, on the same stream, so the
    write lands on the copy."""

    def cow(cache, src: int, dst: int):
        cache["kp"][:, dst] = cache["kp"][:, src]
        cache["vp"][:, dst] = cache["vp"][:, src]
        return cache

    return cow


def _build_suffix_fn(cfg: ModelConfig, page: int):
    """Radix-hit install of one row: its longest indexed prefix (`start`
    tokens, the pool pages `prefix_pages`) is GATHERED into a width-1 dense
    scratch cache, only the suffix `tokens` [1, S_b] runs through
    ``forward_prefill_chunk`` at offset `start` (attending over the
    gathered prefix), and only the suffix's pages are written back, into
    `fresh_pages`, whose first one is the row's page `first_fresh`. The
    scratch is zeroed and a whole number of pages wide, so lanes past the
    suffix hold zeros, never stale values. The first token is sampled or
    forced as in the whole-prompt refill: the same final-position logits,
    the same fold_in(key, init_counter)."""

    def suffix(start: int, params, adapters, row_id, prefix_pages, tokens,
               seq_len: int, init_counter, key, temp, forced, forced_mask,
               cache, fresh_pages, first_fresh: int, slot: int, cur,
               counters, keys, temps, row_ids):
        L, _, _, KVH, hd = cache["kp"].shape
        width = -(-(start + tokens.shape[1]) // page) * page
        pcache = init_cache(cfg, 1, width, dtype=cache["kp"].dtype,
                            device=tokens.device)
        idx = prefix_pages.long()
        pcache["k"][:, 0, :start] = cache["kp"][:, idx].reshape(L, start,
                                                                KVH, hd)
        pcache["v"][:, 0, :start] = cache["vp"][:, idx].reshape(L, start,
                                                                KVH, hd)
        lora = batched_ctx(adapters, row_id, cfg)
        h, pcache = forward_prefill_chunk(params, tokens, cfg, lora, pcache,
                                          start=start)
        logits = lm_logits(h[:, seq_len - 1 - start], params, cfg)
        sampled = _sample_rows(logits, key, init_counter, temp)
        first = torch.where(forced_mask > 0, forced.long(),
                            sampled).to(torch.int32)
        n = fresh_pages.shape[0]
        if n:
            lo, dest = first_fresh * page, fresh_pages.long()
            cache["kp"][:, dest] = pcache["k"][:, 0, lo:lo + n * page].reshape(
                L, n, page, KVH, hd)
            cache["vp"][:, dest] = pcache["v"][:, 0, lo:lo + n * page].reshape(
                L, n, page, KVH, hd)
        cache["pos"][slot] = seq_len
        state = _set_row_state(slot, first[0], init_counter[0] + 1, key[0],
                               temp[0], row_id[0], cur, counters, keys, temps,
                               row_ids)
        return first, _log_softmax_at(logits, first), cache, state

    return suffix


class _Row:
    """Host-side per-episode state machine (one batch lane, or one slot of
    the continuous engine while resident)."""
    __slots__ = ("req", "prompt_len", "gen", "lps", "lmask", "sampled",
                 "forced", "status", "forced_q", "finish_reason", "key",
                 "submit_index", "meta", "submitted_at", "started_at",
                 "replays", "session", "turns", "snap", "dev_pages",
                 "dev_pos", "tool_retries")

    def __init__(self, req: RolloutRequest, key=None, submit_index: int = 0,
                 meta=None, submitted_at: float = 0.0):
        self.req = req
        self.prompt_len = len(req.prompt)
        self.gen: List[int] = []
        self.lps: List[float] = []
        self.lmask: List[float] = []
        self.sampled = 0
        self.forced = 0
        self.status = "active"            # active|calling|done
        self.forced_q: List[int] = []
        self.finish_reason = ""
        self.key = key                    # [2] uint32 base key
        self.submit_index = submit_index
        self.meta = meta or {}
        self.submitted_at = submitted_at
        self.started_at = 0.0
        self.replays = 0              # times preempted and re-queued
        self.tool_retries = 0         # transient tool-error retries spent
                                      # (per-episode retry cap accounting)
        self.session = None           # per-episode ToolSession (lazy; kept
                                      # across park, preemption and replay)
        self.turns = 0                # tool calls dispatched this episode
        self.snap = None              # host KVSnapshot while preempted
                                      # (paged engine, resume_restore);
                                      # None -> the row replays from tokens
        self.dev_pages = None         # KV pages kept IN-POOL while preempted
                                      # (prefix cache; the row owns one
                                      # refcount per page)
        self.dev_pos = 0              # cache entries those pages hold

    def turn_limit(self) -> int:
        """Effective tool-turn budget (0 = unlimited)."""
        if self.req.max_turns is not None:
            return self.req.max_turns
        return getattr(self.req.env, "max_turns", 0)

    def ensure_session(self):
        if self.session is None:
            self.session = self.req.env.open_session(self.req.truth)
        return self.session

    def accept(self, token: int, lp: float, mask: float, max_total: int) -> str:
        """Record one token; returns "continue" | "done" | "call".

        Only sampled tokens (mask==1) are charged to max_new_tokens; the
        length cap is the KV-cache capacity, not the sampling budget. A
        CALL sampled with the turn budget spent ends the episode instead
        of dispatching (finish_reason "turn_limit").
        """
        self.gen.append(token)
        self.lps.append(lp)
        self.lmask.append(mask)
        if mask == 1.0:
            self.sampled += 1
        else:
            self.forced += 1
        if token == tok.EOS:
            self.status, self.finish_reason = "done", "eos"
            return "done"
        if self.prompt_len + len(self.gen) >= max_total:
            self.status, self.finish_reason = "done", "capacity"
            return "done"
        if token == tok.CALL and self.req.env.is_agentic and mask == 1.0:
            limit = self.turn_limit()
            if limit and self.turns >= limit:
                self.status, self.finish_reason = "done", "turn_limit"
                return "done"
            self.turns += 1
            self.status = "calling"
            return "call"
        if self.sampled >= self.req.max_new_tokens and not self.forced_q:
            self.status, self.finish_reason = "done", "budget"
            return "done"
        return "continue"

    def result(self, prompt_tokens) -> Dict:
        return {
            "task_id": self.req.task_id,
            "prompt_len": self.prompt_len,
            "tokens": list(prompt_tokens) + self.gen,
            "gen_logprobs": self.lps,
            "gen_loss_mask": self.lmask,
            "truth": self.req.truth,
            "env": self.req.env,
            "finish_reason": self.finish_reason,
        }


class _RandomShim:
    """random.Random-compatible gauss() over a numpy RandomState."""
    def __init__(self, rs):
        self.rs = rs

    def gauss(self, mu, sigma):
        return float(self.rs.normal(mu, sigma))


def _submit_tool_call(row: _Row, prompt_tokens, pool, rng,
                      sim_latency: bool) -> Tuple[Future, CancelToken]:
    """Dispatch a row's agentic tool call on the shared pool: sample the
    env-interaction latency, then run the episode's stateful session call
    while the rest of the batch decodes. Cancelling the returned token
    interrupts the latency sleep and is passed into the session's call."""
    query = list(prompt_tokens) + row.gen
    latency = row.req.env.sample_env_latency(
        _RandomShim(rng)) if not sim_latency else 0.0
    session = row.ensure_session()
    token = CancelToken()

    def run_tool(q=query, sess=session, lat=latency):
        if lat > 0 and token.wait(lat):
            return []                    # cancelled during the latency sleep
        if token.cancelled:
            return []
        return call_session(sess, q, token)

    return pool.submit(run_tool), token


class RolloutEngine:
    """Round-fused baseline: one fixed batch, barrier until the last row.

    ``base_params`` live on ``device`` (default "cuda", which raises when no
    card is present); adapters passed to ``generate`` must live there too.
    encdec raises (``refuse_encdec``), as does the continuous engine.
    """

    def __init__(self, cfg: ModelConfig, base_params, *, max_len: int = 128,
                 seed: int = 0, device="cuda"):
        refuse_encdec(cfg)
        self.cfg = cfg
        self.base_params = base_params
        self.max_len = max_len
        self.device = resolve_device(device)
        self._master = prng.prng_key(seed)
        self._n_issued = 0        # cumulative rows served (key freshness
                                  # across rounds)
        self._step_fn = None
        self._first_fn = None
        self._prefill_fn = None

    # -- step functions ---------------------------------------------------
    def _build(self, num_adapters: int):
        """Make the step functions (`num_adapters` is unused; the signature
        is the JAX engine's, which tests call before wrapping the steps)."""
        self._prefill_fn, self._first_fn, self._step_fn = _build_fns(self.cfg)

    def _row_keys(self, requests: Sequence[RolloutRequest]) -> np.ndarray:
        """Per-row base keys: explicit request.seed, else the engine-global
        issue counter — consecutive generate() rounds get fresh keys."""
        keys = [prng.fold_in_host(
                    self._master,
                    r.seed if r.seed is not None else self._n_issued + i)
                for i, r in enumerate(requests)]
        self._n_issued += len(requests)
        return np.stack(keys)

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- main API ---------------------------------------------------------
    def generate(self, requests: Sequence[RolloutRequest], adapter_trees,
                 *, tool_executor: Optional[ThreadPoolExecutor] = None,
                 sim_latency: bool = False,
                 deadline_s: float = 120.0) -> Tuple[List[Dict], RolloutStats]:
        """Run a batch of cross-task requests to completion (one round).

        adapter_trees: list of per-task adapter trees; request.adapter_index
        selects. Returns per-request dicts (tokens/logprobs/loss_mask/...)
        and engine stats.
        """
        with torch.inference_mode():
            return self._generate(requests, adapter_trees, tool_executor,
                                  sim_latency, deadline_s)

    def _generate(self, requests, adapter_trees, tool_executor, sim_latency,
                  deadline_s):
        # step: the round-fused engine's prefill and decode loop
        t_start = time.monotonic()
        cfg = self.cfg
        dev = self.device
        B = len(requests)
        if self._step_fn is None:
            self._build(len(adapter_trees))
        stacked = stack_adapters(adapter_trees)
        row_ids = self._tensor([r.adapter_index for r in requests], torch.int32)
        temps = self._tensor([r.temperature for r in requests], torch.float32)
        keys_np = self._row_keys(requests)
        keys = self._tensor(keys_np.astype(np.int64), torch.int64)

        prompt_lens = np.array([len(r.prompt) for r in requests], np.int32)
        S_p = _bucket_len(prompt_lens.max())
        tokens = np.zeros((B, S_p), np.int32)
        for i, r in enumerate(requests):
            tokens[i, :len(r.prompt)] = r.prompt

        cache = init_cache(cfg, B, self.max_len, device=dev)
        stats = RolloutStats(prefill_tokens=int(prompt_lens.sum()),
                             prefills=B)
        synchronize(dev)
        t0 = time.monotonic()
        # the step functions run eagerly: no trace, so a batch-sized shape
        # recompiles nothing (the analyzer's jit rule does not apply)
        logits, cache = self._prefill_fn(  # noqa: RA204
            self.base_params, stacked, row_ids,
            self._tensor(tokens, torch.int32),
            self._tensor(prompt_lens, torch.int32), cache)
        synchronize(dev)
        stats.prefill_seconds += time.monotonic() - t0

        rows = [_Row(r) for r in requests]
        pending: Dict[int, Future] = {}
        pending_t0: Dict[int, float] = {}
        pending_tok: Dict[int, CancelToken] = {}
        own_pool = tool_executor is None
        pool = tool_executor or ThreadPoolExecutor(max_workers=4)
        rng = np.random.RandomState(
            (int(self._master[1]) + self._n_issued) % (2**31))

        # sample the first token from prefill logits (counter = 0 per row)
        counters = np.zeros((B,), np.int32)
        first, first_lp = self._first_fn(logits, keys,  # noqa: RA204
                                         self._tensor(counters, torch.int32),
                                         temps)
        first = first.cpu().numpy()
        first_lp = first_lp.float().cpu().numpy()
        cur = np.zeros((B,), np.int32)
        for i in range(B):
            action = rows[i].accept(int(first[i]), float(first_lp[i]), 1.0,
                                    self.max_len)
            stats.tokens_generated += 1
            stats.sampled_tokens += 1
            if action == "call":
                self._dispatch_tool(i, rows[i], tokens[i], pending,
                                    pending_t0, pending_tok, pool, rng,
                                    sim_latency)
            cur[i] = int(first[i])

        # forced feeds are budget-exempt, so the step bound must cover
        # budget + worst-case tool-response lengths (one response per tool
        # turn; an unlimited turn budget gets a 4-turn allowance — the wall
        # deadline is the actual straggler guard, and rows it cuts short
        # are tagged "straggler" below).
        worst_turns = max(
            (r.max_turns if r.max_turns is not None
             else getattr(r.env, "max_turns", 0)) or 4
            for r in requests)
        max_steps = (max(r.max_new_tokens for r in requests)
                     + 96 * max(1, worst_turns))
        steps_done = 0
        wall_deadline = time.monotonic() + deadline_s
        while steps_done < max_steps and time.monotonic() < wall_deadline:
            if all(r.status == "done" for r in rows):
                break
            # resolve finished tool calls
            for i in list(pending):
                if pending[i].done():
                    resp = pending[i].result()
                    stats.add_env_wait(rows[i].req.task_id,
                                       time.monotonic() - pending_t0[i])
                    rows[i].forced_q = [tok.RESP] + list(resp) + [tok.ENDRESP]
                    rows[i].status = "active"
                    del pending[i], pending_t0[i], pending_tok[i]
            advance = np.array([1 if rows[i].status == "active" else 0
                                for i in range(B)], np.int32)
            if advance.sum() == 0:
                # waiting only on external tools — does not consume the
                # decode-step budget (straggler guard is the wall deadline)
                time.sleep(0.001)
                continue
            steps_done += 1
            forced = np.zeros((B,), np.int32)
            fmask = np.zeros((B,), np.int32)
            for i in range(B):
                if rows[i].status == "active" and rows[i].forced_q:
                    forced[i] = rows[i].forced_q[0]
                    fmask[i] = 1
                counters[i] = len(rows[i].gen)
            synchronize(dev)
            t0 = time.monotonic()
            nxt, lp, cache = self._step_fn(  # noqa: RA204
                self.base_params, stacked, row_ids,
                self._tensor(cur, torch.int32), cache, keys,
                self._tensor(counters, torch.int32), temps,
                self._tensor(forced, torch.int32),
                self._tensor(fmask, torch.int32),
                self._tensor(advance, torch.int32))
            # the step's intended sync: the host reads the sampled tokens
            nxt = nxt.cpu().numpy()  # noqa: RT202
            lp = lp.float().cpu().numpy()
            synchronize(dev)
            stats.decode_seconds += time.monotonic() - t0
            stats.decode_steps += 1
            for i in range(B):
                if rows[i].status != "active" or advance[i] == 0:
                    continue
                was_forced = fmask[i] == 1
                if was_forced:
                    rows[i].forced_q.pop(0)
                action = rows[i].accept(int(nxt[i]), float(lp[i]),
                                        0.0 if was_forced else 1.0,
                                        self.max_len)
                if action == "call":
                    self._dispatch_tool(i, rows[i], tokens[i], pending,
                                        pending_t0, pending_tok, pool, rng,
                                        sim_latency)
                cur[i] = int(nxt[i])
                stats.tokens_generated += 1
                if not was_forced:
                    stats.sampled_tokens += 1

        # timed-out tool calls: cancel the Future (drops jobs still queued
        # on the shared pool) and the cooperative token (makes an
        # already-executing call return early)
        for i in pending:
            pending[i].cancel()
            pending_tok[i].cancel()
            rows[i].status = "done"
            rows[i].finish_reason = rows[i].finish_reason or "tool_timeout"
        for row in rows:
            # rows the step bound / wall deadline cut short return partial
            # (graded reward on what exists) with an explicit reason
            if row.status != "done":
                row.status = "done"
                row.finish_reason = row.finish_reason or "straggler"
        if own_pool:
            pool.shutdown(wait=False)

        results = [rows[i].result(tokens[i, :prompt_lens[i]])
                   for i in range(B)]
        stats.wall_seconds = time.monotonic() - t_start
        return results, stats

    # ------------------------------------------------------------------
    def _dispatch_tool(self, i, row: _Row, token_row, pending, pending_t0,
                       pending_tok, pool, rng, sim_latency):
        pending[i], pending_tok[i] = _submit_tool_call(
            row, token_row[:row.prompt_len], pool, rng, sim_latency)
        pending_t0[i] = time.monotonic()


class ContinuousRolloutEngine:
    """Persistent slot-pool engine: decode never drains between tenants.

    Usage: ``set_adapters(slot, tree)`` to (re)install a tenant's LoRA in
    the fixed-capacity stacked buffer, ``submit(request)`` any number of
    requests (request.adapter_index names the adapter slot), then call
    ``step()`` from the scheduler loop, or ``drain()`` to run to empty.
    Finished rows stream out of ``drain_completions()`` the moment they
    evict.

    The request queue pops in ``scheduler`` order ("srpt": priority tiers,
    then shortest predicted remaining budget via a per-tenant EMA length
    predictor, with a ``starvation_k``-refill progress bound; "fifo":
    arrival order). ``preempt_tenant``/``preempt_slots`` evict resident
    rows; they resume with the tokens an uninterrupted run gives (see the
    module docstring).

    ``disagg_prefill=True`` moves the prefill of incoming and replayed rows
    to ``prefill_workers`` threads (``prefill_chunk``-token chunks, 0 for
    whole sequences); ``env_stage=True`` parks tool-calling rows in an
    ``EnvStage`` of ``env_workers`` threads (``env_inflight_per_tenant``
    calls of one tenant at a time, ``tool_retry_*`` for transient tool
    errors). Both keep the token streams of the fused, freeze-in-slot
    engine.

    The signature is the JAX engine's, less ``use_kernel`` (the port has no
    switch: kernels run for tensors on the card) and plus ``device``
    (default "cuda", which raises when no card is present); ``base_params``
    and the adapters passed to ``set_adapters`` live on ``device``. The
    prefix cache is on by default with ``paged_kv``, as in the JAX engine;
    ``prefix_cache=False`` gives the private-pages engine. ``tracer``,
    ``chaos`` and ``supervise_wedge_s`` are the JAX engine's (see the module
    docstring).
    """

    def __init__(self, cfg: ModelConfig, base_params, *, max_slots: int = 8,
                 max_adapters: int = 8, max_len: int = 128, seed: int = 0,
                 tool_executor: Optional[ThreadPoolExecutor] = None,
                 sim_latency: bool = False, tool_timeout_s: float = 60.0,
                 scheduler: str = "srpt", starvation_k: int = 8,
                 predictor: Optional[LengthPredictor] = None,
                 disagg_prefill: bool = False, prefill_chunk: int = 0,
                 prefill_workers: int = 1, env_stage: bool = False,
                 env_workers: int = 2, env_inflight_per_tenant: int = 0,
                 paged_kv: bool = False, kv_page_size: int = 16,
                 kv_pool_pages: int = 0, resume_restore: bool = True,
                 snapshot_budget_bytes: int = 0, prefix_cache: bool = True,
                 on_stage=None, tracer=None, chaos=None,
                 tool_retry_max: int = 3, tool_retry_base_s: float = 0.05,
                 tool_retry_max_s: float = 2.0,
                 tool_retry_episode_cap: int = 0,
                 supervise_wedge_s: float = 0.0, device="cuda"):
        refuse_encdec(cfg)
        self.cfg = cfg
        self.base_params = base_params
        self.max_slots = max_slots
        self.max_adapters = max_adapters
        self.max_len = max_len
        self.device = resolve_device(device)
        self.tool_timeout_s = tool_timeout_s
        # -- paged KV-cache block pool ------------------------------------
        self.paged_kv = paged_kv
        self.kv_page_size = kv_page_size
        self._has_kv, self._recurrent = _layout(cfg)
        self.resume_restore = paged_kv and resume_restore
        if paged_kv:
            if max_len % kv_page_size != 0:
                raise ValueError(f"max_len {max_len} must be a multiple of "
                                 f"kv_page_size {kv_page_size}")
            self._max_pg = max_len // kv_page_size
            # default pool: dense-equivalent capacity (every slot could run
            # to max_len); size it down to save memory, at the cost of
            # cache-capacity evictions if every row runs long
            self.kv_pool_pages = kv_pool_pages or max_slots * self._max_pg
            self._pages = PagePool(self.kv_pool_pages, kv_page_size)
            self._slot_pages: List[List[int]] = [[] for _ in range(max_slots)]
            self._slot_pos = [0] * max_slots      # device cache["pos"] mirror
            self._tbl_host = np.full((max_slots, self._max_pg),
                                     self._pages.sentinel, np.int32)
            self._tbl_dirty = False
            self._snap_store = SnapshotStore(snapshot_budget_bytes)
        else:
            self.kv_pool_pages = 0
            self._pages = None
            self._snap_store = None
        # -- copy-on-write prefix cache -------------------------------------
        # three sharing levels over the page pool: GRPO-group prompt pages,
        # cross-request radix reuse of common prefixes, and device-resident
        # preemption (pages stay in the pool; the host snapshot becomes a
        # spill tier). prefix_cache=False gives the private-pages engine.
        self.prefix_cache = bool(paged_kv and prefix_cache)
        self._prefix_idx = (PrefixIndex(kv_page_size)
                            if self.prefix_cache else None)
        self._dev_parked: List[_Row] = []   # rows whose dev_pages are live
                                            # (engine thread only: spill
                                            # victims and invariants)
        self._cow_fn = None
        self._suffix_fn = None
        self._snap_fn = None
        self._restore_fn = None
        self.sim_latency = sim_latency
        self.disagg_prefill = disagg_prefill
        self.prefill_workers = max(1, prefill_workers)
        self._chaos = chaos          # ChaosInjector or None (fault drills)
        self._env: Optional[EnvStage] = EnvStage(
            max(1, env_workers),
            max_inflight_per_tenant=env_inflight_per_tenant,
            sim_latency=sim_latency, retry_max=tool_retry_max,
            retry_episode_cap=tool_retry_episode_cap,
            retry_base_s=tool_retry_base_s, retry_max_s=tool_retry_max_s,
            seed=seed, chaos=chaos) if env_stage else None
        self._prefill_chunk_eff = effective_chunk(cfg, prefill_chunk)
        self.on_stage = on_stage    # optional (phase, task_id, t0, t1) hook
                                    # (called from worker threads too)
        # episode tracer (repro_torch.obs): None by default — every hook
        # site below guards on it, so an untraced run pays one pointer
        # compare per episode event (install/park/evict), never per token
        self._tracer = tracer
        self._slot_tr_t0 = [0.0] * max_slots    # residency span starts
        self._slot_tr_flow = [0] * max_slots    # incoming hand-off arrows
        self._master = prng.prng_key(seed)
        self._rng = np.random.RandomState(seed + 7919)
        self._own_pool = tool_executor is None
        self._pool = tool_executor or ThreadPoolExecutor(max_workers=4)

        self._step_fn = None
        self._refill_fn = None
        self._stacked = None                     # [L, T, ...] LoRA buffer
        self._cache = None                       # batch = max_slots
        # forwards run by each step function (the decode thread's and the
        # prefill workers'): every forward launches 6 sgmv a layer on the
        # card. LaunchCount, since the workers add to theirs from their
        # own threads.
        self.forward_counts = {k: LaunchCount() for k in (
            "decode", "refill", "suffix", "prefill_whole", "prefill_chunk")}

        N = max_slots
        self._rows: List[Optional[_Row]] = [None] * N
        self._prompts: List[Optional[List[int]]] = [None] * N
        # device-resident row state (written in place by the step, refill
        # and restore calls; the host uploads only the advance/forced masks,
        # and only when they change — see step())
        self._d_cur = None          # [N] int32   current token per lane
        self._d_counters = None     # [N] int32   == len(gen) per lane
        self._d_keys = None         # [N,2] int64 per-row base key words
        self._d_temps = None        # [N] float32
        self._d_row_ids = None      # [N] int32   adapter slot per lane
        self._mask_sig = None       # last uploaded (advance,forced,fmask)
        self._d_masks = None
        self._pending: Dict[int, Future] = {}
        self._pending_t0: Dict[int, float] = {}
        self._pending_tok: Dict[int, CancelToken] = {}
        self.predictor = predictor or LengthPredictor()
        self._sched = SlotScheduler(policy=scheduler,
                                    predictor=self.predictor,
                                    starvation_k=starvation_k)
        self._completed: Deque[RolloutCompletion] = deque()
        self._n_submitted = 0
        self.stats = RolloutStats()
        # -- disaggregated prefill stage (workers <-> decode thread) -------
        # submit(), the workers and the introspection methods run on other
        # threads than step(). (Named apart from the JAX engine's
        # _stage_lock: the repo's lock analyzer names locks by class and
        # attribute.)
        self._queue_lock = threading.Lock()   # guards: _sched/_ready/
                                              # _stage_inflight
        self._ready: Deque[ReadyRow] = deque()
        self._stage_inflight: List[_Row] = []  # popped by a worker, not yet
                                               # ready (host refs only)
        self._stage_stop = threading.Event()
        self._stage_error: Optional[BaseException] = None
        self._workers: List[PrefillWorker] = []
        self._next_pwid = 0     # unique prefill-worker ids across respawns
        self._pkernels: Optional[PrefillKernels] = None
        self._splice_fn = None
        # -- stage supervision: dead or wedged workers are found on the
        # step() tick, their stranded work recovered, and the pool
        # restarted to complement under bounded backoff; past the restart
        # budget the supervisor raises on the engine thread
        self.supervise_wedge_s = supervise_wedge_s   # 0 = liveness only
        self.supervisor = StageSupervisor(tracer=tracer)
        if env_stage:
            self.supervisor.register(
                "env_worker", healthy=self._env_stage_healthy,
                recover=self._env.recover_dead,
                restart=self._env._ensure_workers)
        if disagg_prefill:
            self.supervisor.register(
                "prefill_worker", healthy=self._prefill_stage_healthy,
                recover=self._recover_prefill_claims,
                restart=self._ensure_stage)

    # -- build ----------------------------------------------------------
    def _ensure_built(self):
        if self._step_fn is None:
            self._step_fn = _build_cont_step_fn(self.cfg)
            if self.paged_kv:
                self._refill_fn = _build_refill_fn_paged(
                    self.cfg, self.max_len, self.kv_page_size)
                self._snap_fn = _build_snap_fn(self.cfg)
                self._restore_fn = _build_restore_fn(self.cfg)
                if self.prefix_cache:
                    self._cow_fn = _build_cow_fn(self.cfg)
                    self._suffix_fn = _build_suffix_fn(self.cfg,
                                                       self.kv_page_size)
            else:
                self._refill_fn = _build_refill_fn(self.cfg, self.max_len)
            if self.disagg_prefill:
                self._splice_fn = (_build_splice_fn_paged(self.cfg,
                                                          self.kv_page_size)
                                   if self.paged_kv else
                                   _build_splice_fn(self.cfg, self.max_len))
                self._pkernels = PrefillKernels(self.cfg)
        if self._cache is None:
            N, dev = self.max_slots, self.device
            if self.paged_kv:
                self._cache = init_paged_cache(
                    self.cfg, N, pool_pages=self.kv_pool_pages,
                    page_size=self.kv_page_size,
                    max_pages_per_row=self._max_pg, device=dev)
            else:
                self._cache = init_cache(self.cfg, N, self.max_len,
                                         device=dev)
            self._d_cur = torch.zeros((N,), dtype=torch.int32, device=dev)
            self._d_counters = torch.zeros((N,), dtype=torch.int32,
                                           device=dev)
            self._d_keys = torch.zeros((N, 2), dtype=torch.int64, device=dev)
            self._d_temps = torch.ones((N,), dtype=torch.float32, device=dev)
            self._d_row_ids = torch.zeros((N,), dtype=torch.int32,
                                          device=dev)

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # -- adapters --------------------------------------------------------
    @torch.no_grad()
    def set_adapters(self, index: int, tree):  # step: writes what the
        # step reads, between steps; tensors=tree,_stacked
        """Install/replace the LoRA tree at adapter slot `index` of the
        fixed-capacity stacked buffer, in place. The prefix index drops the
        slot's entries: their K/V was computed under the old weights.

        With ``disagg_prefill`` the write is copy-on-write instead: a
        prefill worker's call may be reading the buffer, so a new buffer is
        written and, once the calling thread's stream has finished it,
        swapped in; a call in flight keeps the old one (its worker marks it
        as used by its stream), as the JAX engine's writes that donate
        nothing do."""
        if not 0 <= index < self.max_adapters:
            raise ValueError(f"adapter slot {index} out of range "
                             f"[0, {self.max_adapters})")
        self._ensure_built()
        if self._stacked is None:
            buf = init_stacked_buffer(tree, self.max_adapters, self.device)
        elif self.disagg_prefill:
            buf = tree_map(torch.clone, self._stacked)
        else:
            buf = self._stacked
        write_adapter_slot(buf, tree, index)
        if self.disagg_prefill:
            # the workers' streams read it next
            _sync_stream(self.device)  # noqa: RT202
        self._stacked = buf
        if self._prefix_idx is not None:
            stale = self._prefix_idx.invalidate(index)
            if stale:
                self._pages.release(stale)

    # -- submission ------------------------------------------------------
    def submit(self, req: RolloutRequest, meta=None):
        if len(req.prompt) + 1 >= self.max_len:
            raise ValueError("prompt does not fit decode cache")
        key = prng.fold_in_host(
            self._master,
            req.seed if req.seed is not None else self._n_submitted)
        row = _Row(req, key, self._n_submitted, meta=meta,
                   submitted_at=time.monotonic())
        self._n_submitted += 1
        if self._tracer is not None:
            # the episode's trace id rides row.meta, the one piece of host
            # state that survives park, preemption and snapshot or replay
            # resume (it carries the behaviour version for the same reason)
            if not isinstance(row.meta, dict):
                row.meta = {}           # engine-direct callers pass no meta
            trace = row.meta.get("trace_id")
            if trace is None:
                trace = self._tracer.new_trace(req.task_id)
                row.meta["trace_id"] = trace
            self._tracer.mark(trace, "queued", row.submitted_at)
        with self._queue_lock:
            self._sched.push(row, self.stats.refills)
        return row.submit_index

    # -- episode tracing helpers (all no-ops when tracer is None) ---------
    def _trace_of(self, row: _Row):
        m = row.meta
        return m.get("trace_id") if isinstance(m, dict) else None

    def _tr_install(self, slot: int, row: _Row, t_now: float,
                    t_pre: float = None, pre_state: str = None):
        """Row entered a decode slot: open its residency span, consume any
        pending hand-off arrow (env resume / preempt reinstall), and mark
        the lifecycle transition(s)."""
        tr = self._tracer
        if tr is None:
            return
        trace = self._trace_of(row)
        if t_pre is not None and pre_state is not None:
            tr.mark(trace, pre_state, t_pre)
        tr.mark(trace, "decode", t_now)
        self._slot_tr_t0[slot] = t_now
        m = row.meta
        self._slot_tr_flow[slot] = (m.pop("_flow_in", 0)
                                    if isinstance(m, dict) else 0)

    def _tr_vacate(self, slot: int, row: _Row, t_now: float,
                   flow_out: int = 0):
        """Row left its slot (evict/park/preempt): emit the residency span
        on the slot's track, with flow arrows binding it to the hand-off
        source/destination across threads."""
        tr = self._tracer
        if tr is None:
            return
        tr.span(("rollout", f"slot-{slot}"), row.req.task_id,
                self._slot_tr_t0[slot], t_now, trace=self._trace_of(row),
                flow_in=self._slot_tr_flow[slot], flow_out=flow_out)
        self._slot_tr_flow[slot] = 0

    # -- prefill stage lifecycle ------------------------------------------
    def _ensure_stage(self):
        """Start the prefill workers: the full complement after a halt, or
        replacements for workers that died (survivors keep running). A
        no-op until the first adapter install: workers have nothing to
        prefill against before then (queued rows wait)."""
        if not self.disagg_prefill or self._stacked is None:
            return
        self._ensure_built()
        alive = [w for w in self._workers if w.is_alive()]
        if len(alive) >= self.prefill_workers:
            return
        if not alive:
            # the workers' streams must see what the calling thread's
            # stream wrote before them (weights, adapters)
            synchronize(self.device)
        self._stage_stop.clear()
        fresh = []
        for _ in range(self.prefill_workers - len(alive)):
            # unique ids across respawns: a replacement must not shadow a
            # dead worker's claimed-row ownership
            fresh.append(PrefillWorker(self, self._next_pwid))
            self._next_pwid += 1
        self._workers = alive + fresh
        for w in fresh:
            w.start()

    def _halt_stage(self):
        """Stop the prefill workers; their unfinished rows return to the
        queue (worker teardown pushes them back under the queue lock)."""
        self._stage_stop.set()
        for w in self._workers:
            w.join(timeout=30)
        self._recover_prefill_claims()
        self._workers = []

    # -- stage supervision callables (engine thread only) -----------------
    def _env_stage_healthy(self) -> bool:
        if self.supervise_wedge_s > 0:
            self._env.mark_wedged(self.supervise_wedge_s)
        return self._env.healthy()

    def _prefill_stage_healthy(self) -> bool:
        """Supervisor liveness: a full complement of live workers (a stage
        not started or halted has nothing to supervise, and a worker error
        is about to raise on the engine thread: restarting first would mask
        its cause)."""
        if self._stacked is None or not self._workers:
            return True
        if self._stage_error is not None:
            return True
        alive = [w for w in self._workers if w.is_alive()]
        return len(alive) >= self.prefill_workers

    def _recover_prefill_claims(self) -> int:
        """Requeue the rows a dead prefill worker stranded mid-prefill:
        still in ``_stage_inflight`` (so not aborted) but never emitted and
        with no live owner. They prefill again from scratch (prefill is
        deterministic, so the re-run gives the same tokens). A chaos-killed
        worker's stream may still be writing its stranded caches: this
        thread's stream waits on the event it recorded as it died before
        the caches are dropped."""
        n = 0
        with self._queue_lock:
            for w in self._workers:
                if w.is_alive():
                    continue
                if w.death_event is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        w.death_event)
                    w.death_event = None
                w.stranded = []
                for row in list(w.claimed):
                    w.claimed.remove(row)
                    if row in self._stage_inflight:
                        self._stage_inflight.remove(row)
                        self._sched.push(row, self.stats.refills)
                        n += 1
        return n

    def _raise_stage_error(self):
        if self._stage_error is not None:
            err, self._stage_error = self._stage_error, None
            raise err

    # -- introspection ---------------------------------------------------
    def occupancy(self) -> Tuple[int, int]:
        return sum(r is not None for r in self._rows), self.max_slots

    def occupant_tasks(self) -> frozenset:
        return frozenset(r.req.task_id for r in self._rows if r is not None)

    def queued(self) -> int:
        """Rows in flight outside the slots: queued, in a prefill worker,
        ready to splice, or parked in the env stage."""
        with self._queue_lock:
            n = (len(self._sched) + len(self._stage_inflight)
                 + len(self._ready))
        if self._env is not None:
            n += self._env.count()
        return n

    def queue_depths(self) -> Tuple[int, int]:
        """(prefill queue + in-prefill, ready-to-splice) — the two stage
        queues of the disaggregated layout (Fig. 5)."""
        with self._queue_lock:
            return (len(self._sched) + len(self._stage_inflight),
                    len(self._ready))

    def env_depths(self) -> Tuple[int, int]:
        """(queued, executing) depths of the env-interaction stage."""
        return self._env.depths() if self._env is not None else (0, 0)

    def idle(self) -> bool:
        return self.queued() == 0 and all(r is None for r in self._rows)

    def active_tenants(self) -> frozenset:
        """Tenants with rows resident in slots or anywhere in the pipeline
        (queued, in prefill, ready to splice, parked in the env stage,
        preempted rows awaiting resume included): those whose adapter slot
        must stay resident."""
        with self._queue_lock:
            stage = (frozenset(r.req.task_id for r in self._stage_inflight)
                     | frozenset(rr.row.req.task_id for rr in self._ready)
                     | self._sched.tenants())
        if self._env is not None:
            stage = stage | self._env.tenants()
        return self.occupant_tasks() | stage

    def queued_progress(self, task_id: str) -> Tuple[int, float]:
        """(row count, mean sampled tokens) over a tenant's rows outside the
        slots (queued, in prefill, ready, parked). Preempted rows carry
        their generated prefix, so this feeds an admission controller's
        remaining-budget re-estimate."""
        with self._queue_lock:
            rows = self._sched.rows_for(task_id)
            rows += [r for r in self._stage_inflight
                     if r.req.task_id == task_id]
            rows += [rr.row for rr in self._ready
                     if rr.row.req.task_id == task_id]
        if self._env is not None:
            rows += self._env.rows_for(task_id)
        if not rows:
            return 0, 0.0
        return len(rows), float(sum(r.sampled for r in rows)) / len(rows)

    def drain_completions(self) -> List[RolloutCompletion]:
        out = []
        while self._completed:
            out.append(self._completed.popleft())
        return out

    # -- slot lifecycle --------------------------------------------------
    def _completion(self, row: _Row, prompt, slot: int) -> RolloutCompletion:
        """One finished episode -> completion record. The behaviour version
        is stamped per row from the submit meta, which lives on the row and
        so survives preemption."""
        meta = row.meta if isinstance(row.meta, dict) else {}
        finished_at = time.monotonic()
        if self._tracer is not None:
            self._tracer.mark(self._trace_of(row), "completed", finished_at)
        return RolloutCompletion(
            task_id=row.req.task_id, prompt_len=row.prompt_len,
            tokens=list(prompt) + row.gen, gen_logprobs=row.lps,
            gen_loss_mask=row.lmask, truth=row.req.truth, env=row.req.env,
            finish_reason=row.finish_reason, slot=slot,
            version=int(meta.get("version", -1)),
            sampled_tokens=row.sampled, forced_tokens=row.forced,
            submit_index=row.submit_index, submitted_at=row.submitted_at,
            started_at=row.started_at, finished_at=finished_at,
            finished_step=self.stats.decode_steps, meta=row.meta)

    def _evict(self, slot: int):
        row = self._rows[slot]
        if self._tracer is not None:
            self._tr_vacate(slot, row, time.monotonic())
        self._completed.append(self._completion(row, self._prompts[slot],
                                                slot))
        self.stats.completions += 1
        if row.finish_reason in ("eos", "budget", "capacity", "turn_limit"):
            # natural finishes only: a tool_timeout/aborted row's partial
            # sampled count would bias the tenant's length EMA low
            self.predictor.observe(row.req.task_id, row.sampled)
        self._rows[slot] = None
        self._prompts[slot] = None
        if self.paged_kv:
            self._free_slot_pages(slot)
        # cancel, don't just drop, a pending tool call: a late response must
        # never reach the slot's next occupant, and the token makes an
        # already-running call return early, freeing its pool thread
        fut = self._pending.pop(slot, None)
        if fut is not None:
            fut.cancel()
        tok_ = self._pending_tok.pop(slot, None)
        if tok_ is not None:
            tok_.cancel()
        self._pending_t0.pop(slot, None)

    def _complete_parked(self, row: _Row):
        """Finish an episode that holds no slot (queued or parked in the env
        stage: capacity, tool timeout or abort)."""
        self._drop_snap(row)          # a dead row's snapshot frees its arena
        self._release_dev(row)        # ... and its in-pool parked pages
        self._completed.append(self._completion(row, row.req.prompt, -1))
        self.stats.completions += 1

    # -- paged KV page + snapshot lifecycle (rollout/kvcache.py) ----------
    def _row_pages_needed(self, tokens: int) -> int:
        """Pool pages holding `tokens` cache entries for one row (0 for a
        pure-SSM model: recurrent state is fixed-size and never paged)."""
        if not self._has_kv:
            return 0
        return pages_for(tokens, self.kv_page_size)

    def _assign_slot_pages(self, slot: int, pages: List[int], pos: int):
        """Install a slot's host-side page list + block-table mirror."""
        self._slot_pages[slot] = list(pages)
        self._slot_pos[slot] = pos
        self._tbl_host[slot, :] = self._pages.sentinel
        self._tbl_host[slot, :len(pages)] = pages
        self._tbl_dirty = True

    def _free_slot_pages(self, slot: int):
        """Vacating a slot returns its pages to the pool and neutralizes its
        block-table row: stale entries would let the empty lane's (garbage)
        decode writes corrupt pages re-allocated to other rows."""
        if self._slot_pages[slot]:
            self._pages.release(self._slot_pages[slot])
        self._slot_pages[slot] = []
        self._tbl_host[slot, :] = self._pages.sentinel
        self._tbl_dirty = True

    def _snapshot_row(self, slot: int, row: _Row):
        """Copy a row's cache state to HOST before vacating its slot: only
        the ``ceil(pos/page)`` pages holding entries, never the max_len
        worst case, plus the fixed ssm/conv rows of a recurrent family
        (``_build_snap_fn``: CPU tensors, counted against the store's
        budget). Under host memory pressure the snapshot is dropped and the
        row replays from tokens instead (same output, recomputed)."""
        if not self.resume_restore:
            return
        if self._chaos is not None and self._chaos.fire("snapshot_drop"):
            # simulated host-memory pressure: the row falls back to token
            # replay (same output, recomputed prefix)
            row.snap = None
            self.stats.snapshot_drops += 1
            return
        pos = self._slot_pos[slot]
        n_pg = self._row_pages_needed(pos)
        # the slot may hold one extra page allocated for the pending write
        # (pos % page == 0); it holds no valid entries, so it is skipped
        outs = self._snap_fn(self._cache, self._tensor(
            self._slot_pages[slot][:n_pg], torch.int64), slot)
        snap = KVSnapshot(pos=pos, cur=row.gen[-1], kpages=outs.get("kp"),
                          vpages=outs.get("vp"), ssm=outs.get("ssm"),
                          conv=outs.get("conv"))
        if self._snap_store.try_add(snap):
            row.snap = snap
            self.stats.snapshots += 1
        else:
            row.snap = None
            self.stats.snapshot_drops += 1

    def _drop_snap(self, row: _Row):
        if row.snap is not None:
            self._snap_store.remove(row.snap)
            row.snap = None

    def _release_dev(self, row: _Row):
        """Drop a row's device-resident parked pages (abort, capacity
        finish, drain): the in-pool counterpart of ``_drop_snap``."""
        if row.dev_pages is not None:
            self._pages.release(row.dev_pages)
            row.dev_pages, row.dev_pos = None, 0
            if row in self._dev_parked:
                self._dev_parked.remove(row)

    # -- prefix cache: allocation relief + device-resident parking ---------
    def _alloc_pages(self, n: int, *, spill: bool = True
                     ) -> Optional[List[int]]:
        """Pool allocation (all-or-nothing; None when the pool is short),
        with the prefix cache's relief: on failure, evict cold index entries
        (LRU leaves), then spill the oldest device-parked row to the host
        tier, then retry. ``spill=False`` keeps the call host-only (no
        device gather); use it under ``_queue_lock``."""
        if n == 0:
            return []
        pages = self._pages.alloc(n)
        while pages is None:
            if self._prefix_idx is not None:
                dropped = self._prefix_idx.pop_lru(
                    max(1, n - self._pages.free_pages))
                if dropped:
                    self._pages.release(dropped)
                    pages = self._pages.alloc(n)
                    continue
            if not (spill and self._spill_dev_parked()):
                return None
            pages = self._pages.alloc(n)
        return pages

    def _spill_dev_parked(self) -> bool:
        """Spill tier: demote the oldest device-parked row to a host
        snapshot (its pages copied off the card, merged with a hybrid's
        recurrent-only snapshot) so that its pool pages free up. If the
        snapshot store rejects the bytes, the row falls back to token
        replay; either way its pages return to the pool. Returns True if a
        row was spilled."""
        if not self._dev_parked:
            return False
        row = self._dev_parked.pop(0)
        outs = self._snap_fn(self._cache,
                             self._tensor(row.dev_pages, torch.int64))
        old = row.snap            # hybrid park: recurrent-only snapshot
        snap = KVSnapshot(pos=row.dev_pos, cur=row.gen[-1], kpages=outs["kp"],
                          vpages=outs["vp"],
                          ssm=old.ssm if old is not None else None,
                          conv=old.conv if old is not None else None)
        self._drop_snap(row)
        self._pages.release(row.dev_pages)
        row.dev_pages, row.dev_pos = None, 0
        if self._snap_store.try_add(snap):
            row.snap = snap
            self.stats.snapshots += 1
        else:
            self.stats.snapshot_drops += 1   # token-replay fallback
        return True

    def _dev_park_row(self, slot: int, row: _Row) -> bool:
        """Device-resident preemption (prefix cache): the row KEEPS its pool
        pages (ownership moves from the slot to the row), its resume is a
        block-table splice, and no K/V byte leaves the card. A hybrid's
        recurrent state has no paged form and still snapshots to host; if
        the store rejects it, the row falls back to token replay (its pages
        released). Returns True when the slot was vacated (device-resident,
        or for replay)."""
        if not (self.prefix_cache and self.resume_restore):
            return False
        if not self._has_kv or not self._slot_pages[slot]:
            return False                 # no attention pages to keep
        pos = self._slot_pos[slot]
        n_pg = self._row_pages_needed(pos)
        pages = self._slot_pages[slot]
        if self._recurrent:              # hybrid: recurrent part to host
            outs = self._snap_fn(self._cache, None, slot)
            snap = KVSnapshot(pos=pos, cur=row.gen[-1], ssm=outs["ssm"],
                              conv=outs["conv"])
            if not self._snap_store.try_add(snap):
                self.stats.snapshot_drops += 1
                self._free_slot_pages(slot)      # replay fallback
                return True
            row.snap = snap
            self.stats.snapshots += 1
        # the slot may hold one slack page allocated for the pending write
        # (pos % page == 0): it has no valid entries, so it is dropped
        if n_pg < len(pages):
            self._pages.release(pages[n_pg:])
        row.dev_pages = pages[:n_pg]
        row.dev_pos = pos
        self._dev_parked.append(row)
        # hand-off WITHOUT release: the row now owns the refcounts
        self._slot_pages[slot] = []
        self._tbl_host[slot, :] = self._pages.sentinel
        self._tbl_dirty = True
        return True

    def _park_or_snap(self, slot: int, row: _Row):
        """Vacate a slot keeping the row's resume state: in the pool when
        the prefix cache is on, as a host snapshot otherwise (which falls
        back to token replay under memory pressure)."""
        if self._dev_park_row(slot, row):
            return
        self._snapshot_row(slot, row)
        self._free_slot_pages(slot)

    def _finish_capacity(self, row: _Row):
        """Cache-capacity eviction: the page pool cannot serve this row even
        when otherwise idle, so the episode finishes with what it has
        instead of deadlocking the queue."""
        self._drop_snap(row)
        row.status, row.finish_reason = "done", "capacity"
        self.stats.pool_exhausted += 1
        self._complete_parked(row)

    def _restore_rows(self) -> bool:
        """Install queued rows that carry a host snapshot: splice the saved
        KV pages into freshly allocated pool pages and resume with the
        pending token; the next decode step produces the logits an
        uninterrupted run would have. No token is accepted at install (the
        pending one was accepted before the preemption), so only the device
        state moves. A device-resident row (prefix cache) re-attaches the
        pages it kept in the pool: no K/V moves at all."""
        if not self.resume_restore or self._cache is None:
            return False
        free = [s for s in range(self.max_slots) if self._rows[s] is None]
        did = False
        while free:
            with self._queue_lock:
                # pop_if, not pop(where=): a snapshot row restores only
                # when it is genuinely next in scheduler order
                row = self._sched.pop_if(
                    self.stats.refills,
                    lambda r: r.snap is not None or r.dev_pages is not None)
            if row is None:
                break
            if row.dev_pages is not None:
                # device-resident resume: reattach the pages to the slot's
                # block table, bring a hybrid's recurrent rows back up, and
                # reset the device row state
                slot = free.pop(0)
                t0 = time.monotonic()
                rec = row.snap
                self._cache, state = self._restore_fn(  # noqa: RA204
                    self._cache, None, None, None, slot, row.dev_pos,
                    rec.ssm if rec is not None else None,
                    rec.conv if rec is not None else None,
                    row.gen[-1], len(row.gen),
                    self._tensor(row.key.astype(np.int64), torch.int64),
                    row.req.temperature, row.req.adapter_index, self._d_cur,
                    self._d_counters, self._d_keys, self._d_temps,
                    self._d_row_ids)
                (self._d_cur, self._d_counters, self._d_keys, self._d_temps,
                 self._d_row_ids) = state
                self._mask_sig = None
                now = time.monotonic()
                self._rows[slot] = row
                self._prompts[slot] = list(row.req.prompt)
                self._tr_install(slot, row, now, t0, "restore")
                # ownership transfer back: the slot adopts the refcounts
                self._assign_slot_pages(slot, row.dev_pages, row.dev_pos)
                self._dev_parked.remove(row)
                row.dev_pages, row.dev_pos = None, 0
                self._drop_snap(row)
                self.stats.restores += 1
                self.stats.device_resident_resumes += 1
                self.stats.replay_tokens_saved += (row.prompt_len
                                                   + len(row.gen))
                self.stats.splice_seconds += now - t0
                if self.on_stage is not None:
                    self.on_stage("splice", row.req.task_id, t0, now)
                did = True
                continue
            snap = row.snap
            pages = self._alloc_pages(snap.n_pages)
            if pages is None:
                if (self._pages.used_pages == 0
                        and snap.n_pages > self._pages.n_pages):
                    self._finish_capacity(row)      # can never fit
                    continue
                with self._queue_lock:              # pool pressure: retry
                    self._sched.push(row, self.stats.refills)
                break
            slot = free.pop(0)
            t0 = time.monotonic()
            # eager, as the step functions are: a row-sized argument
            # recompiles nothing (the analyzer's jit rule does not apply)
            self._cache, state = self._restore_fn(  # noqa: RA204
                self._cache, snap.kpages, snap.vpages,
                self._tensor(pages, torch.int64), slot, snap.pos, snap.ssm,
                snap.conv, snap.cur, len(row.gen),
                self._tensor(row.key.astype(np.int64), torch.int64),
                row.req.temperature, row.req.adapter_index, self._d_cur,
                self._d_counters, self._d_keys, self._d_temps,
                self._d_row_ids)
            (self._d_cur, self._d_counters, self._d_keys, self._d_temps,
             self._d_row_ids) = state
            self._mask_sig = None
            now = time.monotonic()
            self._rows[slot] = row
            self._prompts[slot] = list(row.req.prompt)
            self._tr_install(slot, row, now, t0, "restore")
            self._assign_slot_pages(slot, pages, snap.pos)
            self._drop_snap(row)
            self.stats.restores += 1
            self.stats.replay_tokens_saved += row.prompt_len + len(row.gen)
            self.stats.splice_seconds += now - t0
            if self.on_stage is not None:
                self.on_stage("splice", row.req.task_id, t0, now)
            did = True
        if did:
            self.stats.refills += 1     # one refill event (starvation aging)
        return did

    def _ensure_decode_pages(self):
        """Pre-step growth: every resident ACTIVE row is about to write its
        K/V at cache position ``_slot_pos``; allocate the covering page when
        the row crosses a page boundary. A row the pool cannot serve
        finishes via cache-capacity eviction (pool exhaustion is a
        scheduling condition, not a crash)."""
        if not self._has_kv:
            return                  # nothing of a pure-SSM row is paged
        for slot, r in enumerate(self._rows):
            if r is None or r.status != "active":
                continue
            need_idx = self._slot_pos[slot] // self.kv_page_size
            if need_idx >= self._max_pg:
                continue            # accept() finishes the row at max_len
            if need_idx < len(self._slot_pages[slot]):
                page = self._slot_pages[slot][need_idx]
                if self.prefix_cache and self._pages.refcount(page) > 1:
                    # copy-on-write fork: the row is about to write into a
                    # SHARED page; privatize just this page. The last owner
                    # standing sees rc == 1 and writes in place.
                    pg = self._alloc_pages(1)
                    if pg is None:
                        r.status, r.finish_reason = "done", "capacity"
                        self.stats.pool_exhausted += 1
                        self._evict(slot)
                        continue
                    self._cache = self._cow_fn(self._cache, page, pg[0])
                    self._pages.release([page])
                    self._slot_pages[slot][need_idx] = pg[0]
                    self._tbl_host[slot, need_idx] = pg[0]
                    self._tbl_dirty = True
                    self.stats.cow_forks += 1
                continue
            pg = (self._alloc_pages(1) if self.prefix_cache
                  else self._pages.alloc(1))
            if pg is None:
                r.status, r.finish_reason = "done", "capacity"
                self.stats.pool_exhausted += 1
                self._evict(slot)
                continue
            self._slot_pages[slot].extend(pg)
            self._tbl_host[slot, need_idx] = pg[0]
            self._tbl_dirty = True

    def page_stats(self) -> Dict[str, float]:
        """Pool occupancy/fragmentation gauges: used/total pages, the
        high-water mark, internal fragmentation (allocated page slack beyond
        the live cache entries), the prefix cache's sharing gauges (pages
        with more than one owner, pages the index holds, device bytes per
        row in a slot or parked in the pool) and the host snapshot arena's
        bytes."""
        if self._pages is None:
            return {}
        used = self._pages.used_pages
        cap_tokens = used * self.kv_page_size
        live = sum(min(self._slot_pos[s],
                       len(self._slot_pages[s]) * self.kv_page_size)
                   for s in range(self.max_slots)
                   if self._rows[s] is not None)
        frag = 1.0 - live / cap_tokens if cap_tokens else 0.0
        resident = sum(1 for r in self._rows if r is not None)
        resident += len(self._dev_parked)      # their pages are HBM too
        dtype_bytes = (_cache_dtype(self._cache).itemsize
                       if self._cache is not None else 2)
        hbm = cap_tokens * self.cfg.state_bytes_per_token(dtype_bytes)
        return {"kv_pages_used": float(used),
                "kv_pages_total": float(self._pages.n_pages),
                "kv_pages_peak": float(self._pages.peak_used),
                "kv_page_frag": float(frag),
                "kv_shared_pages": float(self._pages.shared_pages),
                "kv_prefix_pages": float(
                    self._prefix_idx.held_pages
                    if self._prefix_idx is not None else 0),
                "kv_hbm_bytes_per_row": float(hbm / max(1, resident)),
                "snapshot_bytes": float(self._snap_store.bytes_used)}

    def check_page_invariants(self):
        """Debug assertion the tests run after every step: allocator-level
        conservation (``PagePool.check_invariants``) plus exact refcount
        accounting (every page's rc equals its owners: the slots that hold
        it, the device-parked rows and the prefix index's nodes), the host
        block-table mirror naming exactly the slots' pages, and, once the
        cache exists, the device ``pos`` of every resident row equal to its
        host mirror ``_slot_pos``. A COW leak or double free fails at the
        step it happens."""
        if self._pages is None:
            return
        self._pages.check_invariants()
        owners = np.zeros((self._pages.n_pages,), np.int64)
        for s in range(self.max_slots):
            for p in self._slot_pages[s]:
                owners[p] += 1
            want = np.full((self._max_pg,), self._pages.sentinel, np.int32)
            want[:len(self._slot_pages[s])] = self._slot_pages[s]
            assert (self._tbl_host[s] == want).all(), \
                f"slot {s}: block-table mirror out of sync"
        for row in self._dev_parked:
            assert row.dev_pages is not None
            for p in row.dev_pages:
                owners[p] += 1
        if self._prefix_idx is not None:
            for p, n in self._prefix_idx.refcounts().items():
                owners[p] += n
        for p in range(self._pages.n_pages):
            assert self._pages.refcount(p) == owners[p], (
                f"page {p}: rc={self._pages.refcount(p)} but "
                f"{owners[p]} owners (slots+parked+index)")
        if self._cache is not None:
            pos = self._cache["pos"].cpu().numpy()
            for s, r in enumerate(self._rows):
                if r is not None:
                    assert pos[s] == self._slot_pos[s], (
                        f"slot {s}: device pos {pos[s]} != host mirror "
                        f"{self._slot_pos[s]}")

    def queued_state_bytes(self, task_id: str,
                           dtype_bytes: int = 2) -> Optional[int]:
        """Actual byte need of a tenant's queued rows (paged mode): snapshot
        page counts for restore rows (exact — what restore will allocate),
        page-rounded prompt+prefix for replay rows, only the fixed state for
        device-parked rows (their pages are already in the pool). None in
        dense mode."""
        if not self.paged_kv:
            return None
        with self._queue_lock:
            rows = self._sched.rows_for(task_id)
        per_tok = self.cfg.state_bytes_per_token(dtype_bytes)
        fixed = self.cfg.state_bytes_fixed(dtype_bytes)
        total = 0
        for r in rows:
            if r.dev_pages is not None:
                total += fixed
                continue
            n_pg = (r.snap.n_pages if r.snap is not None
                    else self._row_pages_needed(r.prompt_len + len(r.gen)))
            total += n_pg * self.kv_page_size * per_tok + fixed
        return int(total)

    # -- preemption -------------------------------------------------------
    def _preemptible(self, slot: int, protect=()) -> bool:
        r = self._rows[slot]
        return (r is not None and r.status == "active" and not r.forced_q
                and slot not in self._pending
                and r.req.task_id not in protect)

    def _preempt_slot(self, slot: int):
        """Free one slot: the generated prefix already lives host-side in
        the _Row, so vacate and re-queue. With the paged cache and
        ``resume_restore`` the row's live KV pages are kept: in the pool with
        the prefix cache, else copied to host; the later resume splices them
        back instead of re-prefilling (unless the snapshot was dropped under
        memory pressure: then the row replays, with the same output)."""
        row = self._rows[slot]
        row.replays += 1
        if self.paged_kv:
            self._park_or_snap(slot, row)
        if self._tracer is not None:
            fid = self._tracer.next_flow("preempt")
            now = time.monotonic()
            self._tr_vacate(slot, row, now, flow_out=fid)
            self._tracer.mark(self._trace_of(row), "preempted", now)
            if isinstance(row.meta, dict):
                row.meta["_flow_in"] = fid    # consumed at reinstall
        self._rows[slot] = None
        self._prompts[slot] = None
        self.stats.preemptions += 1
        with self._queue_lock:
            self._sched.push(row, self.stats.refills)

    def preempt_tenant(self, task_id: str, max_rows: Optional[int] = None
                       ) -> int:
        """Preempt up to `max_rows` (default: all) of a tenant's resident
        rows; returns the number preempted. Rows mid tool-call or mid
        force-feed keep their slots (a replay always samples its first
        token)."""
        n = 0
        for slot in range(self.max_slots):
            if max_rows is not None and n >= max_rows:
                break
            r = self._rows[slot]
            if (r is not None and r.req.task_id == task_id
                    and self._preemptible(slot)):
                self._preempt_slot(slot)
                n += 1
        return n

    def preempt_slots(self, n: int, protect=()) -> int:
        """Free up to `n` slots for an incoming tenant by preempting the
        lowest-priority / longest-remaining-budget resident rows (tenants in
        `protect` are never victims). Returns the number actually freed."""
        victims = [s for s in range(self.max_slots)
                   if self._preemptible(s, protect)]
        victims.sort(key=lambda s: (self._rows[s].req.priority,
                                    -(self._rows[s].req.max_new_tokens
                                      - self._rows[s].sampled),
                                    -self._rows[s].submit_index))
        freed = 0
        for slot in victims[:n]:
            self._preempt_slot(slot)
            freed += 1
        return freed

    def abort_tenant(self, task_id: str, reason: str = "quarantined") -> int:
        """Abort EVERY in-flight episode of one tenant — env-parked jobs,
        resident rows, and queued, in-prefill and ready-to-splice rows
        (preempted rows awaiting resume included; a device-parked row's
        pages return to the pool) — each yielding exactly one completion
        with ``reason`` as its finish_reason (the runtime counts them as
        quarantine drops). Other tenants' rows and scheduling order are
        untouched."""
        n = 0
        if self._env is not None:
            for job in self._env.cancel_tenant(task_id):
                row = job.row
                if row.status == "done":
                    continue     # expired earlier; already completed
                row.status, row.finish_reason = "done", reason
                self._complete_parked(row)
                n += 1
        for slot, r in enumerate(self._rows):
            if r is not None and r.req.task_id == task_id:
                r.status, r.finish_reason = "done", reason
                self._evict(slot)    # cancels a pending tool future too
                n += 1
        with self._queue_lock:
            drained: List[_Row] = []
            while True:
                row = self._sched.pop(
                    self.stats.refills,
                    where=lambda r: r.req.task_id == task_id)
                if row is None:
                    break
                drained.append(row)
            # mid-prefill rows: removing them from _stage_inflight makes the
            # owning worker's eventual _emit a no-op
            for row in list(self._stage_inflight):
                if row.req.task_id == task_id:
                    self._stage_inflight.remove(row)
                    drained.append(row)
            keep: Deque[ReadyRow] = deque()
            for rr in self._ready:
                if rr.row.req.task_id == task_id:
                    drained.append(rr.row)
                else:
                    keep.append(rr)
            self._ready = keep
        for row in drained:
            row.status, row.finish_reason = "done", reason
            self._complete_parked(row)
            n += 1
        return n

    # -- radix prefix reuse + GRPO-group sharing ---------------------------
    def _radix_on(self) -> bool:
        """Radix/group page sharing is on once the paged cache exists, for
        pure attention caches only: a suffix prefill at a page offset is
        exact for attention, while recurrent (ssm/hybrid) state has no
        shareable paged form, so there the prefix cache is a no-op."""
        return (self._prefix_idx is not None and self._cache is not None
                and self._has_kv and not self._recurrent)

    def _group_key(self, r: _Row):
        return (r.req.adapter_index, tuple(r.req.prompt))

    def _radix_candidate(self, r: _Row):
        """Shared-install plan for a queued row whose prefix is in the pool:
        ``(shared_pages, start, L)`` or None. ``shared_pages`` are the pool
        pages the row will reference (NOT yet retained) and ``start`` the
        page-aligned offset its suffix prefill resumes from. An exact
        whole-sequence hit (a GRPO sibling, or an unchanged re-submit)
        shares EVERY page including the partial tail: nothing is written at
        install (the final chunk is recomputed only for the first-token
        logits), and the first decode write forks the tail page."""
        if r.snap is not None or r.dev_pages is not None:
            return None
        seq = list(r.req.prompt) + r.gen
        L = len(seq)
        adapter = r.req.adapter_index
        hit = self._prefix_idx.match_full(adapter, seq)
        if hit is not None:
            pages, tail = hit
            shared = pages + ([tail] if tail is not None else [])
            start = (len(pages) - (1 if tail is None else 0)) \
                * self.kv_page_size
            if start + _bucket_len(L - start) <= self.max_len:
                return (shared, start, L)
        pages = self._prefix_idx.match(adapter, seq, max_tokens=L - 1)
        if not pages:
            return None
        start = len(pages) * self.kv_page_size
        if start + _bucket_len(L - start) > self.max_len:
            return None                  # suffix bucket would overflow
        return (pages, start, L)

    def _index_prompt(self, row: _Row, row_pages: List[int]):
        """Publish an installed row's prompt pages (full pages + partial
        tail) to the per-adapter radix index so that later same-prefix rows
        share them. The index holds its own refcount per page (retained
        here); entries outlive the row and go by LRU eviction under pool
        pressure or by invalidation when the adapter slot is rewritten.
        Valid on every install path: prompt-position K/V depends only on
        the prompt's tokens."""
        if not self._radix_on():
            return
        n_full = row.prompt_len // self.kv_page_size
        if n_full < 1:
            return
        rem = row.prompt_len % self.kv_page_size
        tail = (int(row_pages[n_full])
                if rem and len(row_pages) > n_full else None)
        newly = self._prefix_idx.insert(
            row.req.adapter_index, row.req.prompt,
            [int(p) for p in row_pages[:n_full]], tail_page=tail)
        if newly:
            self._pages.retain(newly)

    def _radix_fill_rows(self) -> bool:
        """Install queued rows whose prefix is already in the pool (radix
        hit / GRPO sibling): retain the shared pages, prefill ONLY the
        suffix (``_suffix_fn``, one width-1 call a row) and book only the
        suffix as prefill work. Runs before the fused refill each step, and
        pops with ``pop_if`` so that a sharable row never jumps a
        higher-priority tenant."""
        if not self._radix_on():
            return False
        free = [s for s in range(self.max_slots) if self._rows[s] is None]
        if not free:
            return False
        installed = 0
        while free:
            with self._queue_lock:
                row = self._sched.pop_if(
                    self.stats.refills,
                    lambda r: self._radix_candidate(r) is not None)
            if row is None:
                break
            plan = self._radix_candidate(row)
            if plan is None:      # the index changed between pop and here
                with self._queue_lock:
                    self._sched.push(row, self.stats.refills)
                break
            shared, start, L = plan
            self._pages.retain(shared)
            fresh = self._alloc_pages(self._row_pages_needed(L)
                                      - len(shared))
            if fresh is None:     # pool pressure: retry next step
                self._pages.release(shared)
                with self._queue_lock:
                    self._sched.push(row, self.stats.refills)
                break
            slot = free.pop(0)
            t0 = time.monotonic()
            seq = list(row.req.prompt) + row.gen
            toks = np.zeros((1, _bucket_len(L - start)), np.int32)
            toks[0, :L - start] = seq[start:]
            was_forced = bool(row.forced_q)
            # eager, as the step functions are: a per-row shape recompiles
            # nothing (the analyzer's jit rule does not apply)
            first, lp, self._cache, state = self._suffix_fn(  # noqa: RA204
                start, self.base_params, self._stacked,
                self._tensor([row.req.adapter_index], torch.int32),
                self._tensor(shared[:start // self.kv_page_size],
                             torch.int64),
                self._tensor(toks, torch.int32), L,
                self._tensor([len(row.gen)], torch.int32),
                self._tensor(row.key[None].astype(np.int64), torch.int64),
                self._tensor([row.req.temperature], torch.float32),
                self._tensor([row.forced_q[0] if was_forced else 0],
                             torch.int32),
                self._tensor([1 if was_forced else 0], torch.int32),
                self._cache, self._tensor(fresh, torch.int64), len(shared),
                slot, self._d_cur, self._d_counters, self._d_keys,
                self._d_temps, self._d_row_ids)
            self.forward_counts["suffix"].add(1)
            (self._d_cur, self._d_counters, self._d_keys, self._d_temps,
             self._d_row_ids) = state
            first = int(first.cpu()[0])
            lp = float(lp.float().cpu()[0])
            self._mask_sig = None
            now = time.monotonic()
            installed += 1
            self._rows[slot] = row
            self._prompts[slot] = list(row.req.prompt)
            self._tr_install(slot, row, now, t0, "prefill")
            self._assign_slot_pages(slot, shared + fresh, L)
            self._index_prompt(row, shared + fresh)
            self.stats.prefix_hits += 1
            self.stats.prefix_hit_tokens += start
            self.stats.prefill_tokens += L - start      # suffix only
            self.stats.prefill_seconds += now - t0
            self.stats.decode_stall_seconds += now - t0
            if row.gen:                       # preemption replay
                self.stats.replays += 1
                self.stats.replay_tokens += L - start
            else:                             # fresh row (GRPO sibling)
                self.stats.prefills += 1
                row.started_at = now
            if was_forced:
                row.forced_q.pop(0)
            self.stats.tokens_generated += 1
            if not was_forced:
                self.stats.sampled_tokens += 1
            if self.on_stage is not None:
                self.on_stage("prefill", row.req.task_id, t0, now)
            action = row.accept(first, lp, 0.0 if was_forced else 1.0,
                                self.max_len)
            if action == "call":
                self._on_call(slot)
            elif action == "done":
                self._evict(slot)
        if installed:
            self.stats.refills += 1    # one refill event (starvation aging)
        return installed > 0

    # -- fused refill ------------------------------------------------------
    def _fusable_forced(self, row: _Row) -> bool:
        """Response-prefill fusion guard: a forced RESP…ENDRESP block can
        fold into the row's (re)prefill call only when feeding it step-wise
        could not end or branch mid-block. Forced tokens never dispatch a
        CALL (mask 0), so the only early exits are a forced EOS, the
        max_len capacity trip, and the sampling budget firing at the
        block's last token."""
        q = row.forced_q
        if len(q) <= 1:
            return False            # a single opener: already one call
        if tok.EOS in q:
            return False
        if row.prompt_len + len(row.gen) + len(q) >= self.max_len:
            return False
        if row.sampled >= row.req.max_new_tokens:
            return False
        return True

    def _refill_free_slots(self) -> bool:
        """Fill every freed slot from the queue with ONE fused call:
        batch-prefill the incoming rows, write their cache state into the
        pool, and sample their first tokens.

        The queue pops in scheduler order. A preemption-replayed row
        prefills its prompt + generated prefix in one sequence and samples
        token `len(gen)` with counter `len(gen)`: the same continuation.
        Snapshot-carrying and device-parked rows restore in
        ``_restore_rows`` and radix-sharable rows install in
        ``_radix_fill_rows``; neither pops here. A GRPO sibling of a row
        popped THIS round waits one step (``seen_keys``), so that the
        leader's pages reach the index first and the sibling shares them
        instead of prefilling its own."""
        free = [s for s in range(self.max_slots) if self._rows[s] is None]
        with self._queue_lock:
            has_queued = bool(self._sched)
        if not free or not has_queued:
            return False
        self._ensure_built()
        if self._stacked is None:
            raise RuntimeError("no adapters installed — call set_adapters()")
        t0 = time.monotonic()
        incoming: List[Tuple[int, _Row]] = []
        pages_of: List[List[int]] = []
        # response-prefill fusion (paged path): a resume's whole forced
        # RESP…ENDRESP block joins the prefilled sequence (its tokens are
        # known) instead of force-feeding one decode step each
        fused: List[bool] = []
        seen_keys = set()
        radix = self._radix_on()
        where = None
        if self.resume_restore or radix:
            def where(r):
                if r.snap is not None or r.dev_pages is not None:
                    return False        # restores in _restore_rows
                if radix and self._radix_candidate(r) is not None:
                    return False        # installs in _radix_fill_rows
                if radix and len(r.req.prompt) >= self.kv_page_size \
                        and self._group_key(r) in seen_keys:
                    return False        # sibling: wait for the leader
                return True
        pressure = False
        with self._queue_lock:
            while free and self._sched:
                row = self._sched.pop(self.stats.refills, where=where)
                if row is None:
                    break
                fuse = self.paged_kv and self._fusable_forced(row)
                if self.paged_kv:
                    # spill=False: spilling a parked row copies device state
                    # to host, never under the lock; cold index entries
                    # still evict (host bookkeeping). A fused resume's
                    # forced block is part of its prefill: its pages too
                    # (the JAX engine allocates the unfused length, ROADMAP
                    # §3)
                    n = len(row.req.prompt) + len(row.gen)
                    pages = self._alloc_pages(self._row_pages_needed(
                        n + (len(row.forced_q) if fuse else 0)), spill=False)
                    if pages is None:
                        if self._pages.used_pages == 0:
                            self._finish_capacity(row)   # can never fit
                            continue
                        # pool pressure: resident rows will free pages
                        self._sched.push(row, self.stats.refills)
                        pressure = True
                        break
                    pages_of.append(pages)
                incoming.append((free.pop(0), row))
                fused.append(fuse)
                if radix:
                    seen_keys.add(self._group_key(row))
        if not incoming:
            if pressure and self._dev_parked:
                # nothing installable and nothing resident to free pages:
                # demote the oldest parked row to the host tier (outside the
                # lock) so that the next step's allocation succeeds
                self._spill_dev_parked()
            return False
        k = len(incoming)
        seqs = [list(row.req.prompt) + row.gen
                + (row.forced_q if fused[j] else [])
                for j, (_, row) in enumerate(incoming)]
        S_p = _bucket_len(max(len(s) for s in seqs))
        tokens = np.zeros((k, S_p), np.int32)
        prompt_lens = np.array([len(s) for s in seqs], np.int32)
        init_counters = np.array([len(r.gen) for _, r in incoming], np.int32)
        forced = np.zeros((k,), np.int32)        # env-stage resumes install
        fmask = np.zeros((k,), np.int32)         # a forced RESP opener
        f_rows, f_pos, f_toks = [], [], []       # fusion: the positions
        f_start = {}                             # whose logits predict each
                                                 # forced token
        for j, (slot, row) in enumerate(incoming):
            tokens[j, :len(seqs[j])] = seqs[j]
            if fused[j]:
                L0 = len(row.req.prompt) + len(row.gen)
                Fj = len(row.forced_q)
                init_counters[j] = len(row.gen) + Fj
                f_start[j] = len(f_rows)
                f_rows += [j] * Fj
                f_pos += list(range(L0 - 1, L0 - 1 + Fj))
                f_toks += row.forced_q
            elif row.forced_q:
                forced[j] = row.forced_q[0]
                fmask[j] = 1
        args = [self.base_params, self._stacked,
                self._tensor(tokens, torch.int32),
                self._tensor(prompt_lens, torch.int32),
                self._tensor(init_counters, torch.int32),
                self._tensor([s for s, _ in incoming], torch.int64)]
        if self.paged_kv:
            # physical destination pages per (row, chunk); chunks past a
            # row's page count name the scratch page
            dest = np.full((k, -(-S_p // self.kv_page_size)),
                           self._pages.sentinel, np.int32)
            for j, pages in enumerate(pages_of):
                dest[j, :len(pages)] = pages
            args.append(self._tensor(dest, torch.int64))
        keys = np.stack([r.key for _, r in incoming]).astype(np.int64)
        args += [self._tensor([r.req.adapter_index for _, r in incoming],
                              torch.int32),
                 self._tensor(keys, torch.int64),
                 self._tensor([r.req.temperature for _, r in incoming],
                              torch.float32),
                 self._tensor(forced, torch.int32),
                 self._tensor(fmask, torch.int32)]
        if self.paged_kv:
            args.append((self._tensor(f_rows, torch.int64),
                         self._tensor(f_pos, torch.int64),
                         self._tensor(f_toks, torch.int64))
                        if f_rows else None)
        # the step functions run eagerly: no trace, so a batch-sized shape
        # recompiles nothing (the analyzer's jit rule does not apply)
        first, lp, self._cache, state = self._refill_fn(  # noqa: RA204
            *args, self._cache, self._d_cur, self._d_counters, self._d_keys,
            self._d_temps, self._d_row_ids)
        self.forward_counts["refill"].add(1)
        (self._d_cur, self._d_counters, self._d_keys, self._d_temps,
         self._d_row_ids) = state
        first = first.cpu().numpy()
        lp = lp.float().cpu().numpy()
        flp = lp[k:]                 # the fused forced tokens' logprobs
        now = time.monotonic()
        self.stats.refills += 1
        # the fused refill is prefill-stage work, and because it runs on the
        # decode stream it is also decode-stall time
        self.stats.prefill_seconds += now - t0
        self.stats.decode_stall_seconds += now - t0
        if self.on_stage is not None:
            self.on_stage("prefill",
                          "+".join(sorted({r.req.task_id
                                           for _, r in incoming})), t0, now)
        if self._tracer is not None:
            self._tracer.span(("prefill", "fused"),
                              "+".join(sorted({r.req.task_id
                                               for _, r in incoming})),
                              t0, now)
        for j, (slot, row) in enumerate(incoming):
            self._rows[slot] = row
            self._prompts[slot] = list(row.req.prompt)
            self._tr_install(slot, row, now, t0, "prefill")
            if self.paged_kv:
                self._assign_slot_pages(slot, pages_of[j], len(seqs[j]))
                self._index_prompt(row, pages_of[j])
            was_forced = fmask[j] == 1
            L_replay = len(row.req.prompt) + len(row.gen)
            if row.gen:             # preemption replay or env-stage resume
                self.stats.replays += 1
                self.stats.replay_tokens += L_replay
            else:                                 # fresh row
                self.stats.prefills += 1
                row.started_at = now
            self.stats.prefill_tokens += len(seqs[j])
            if fused[j]:
                Fj = len(row.forced_q)
                self.stats.fused_forced_tokens += Fj
                self.stats.tokens_generated += Fj
                for t in range(Fj):
                    # pop BEFORE accept, as the step-wise path does:
                    # accept's budget check reads forced_q
                    tk = row.forced_q.pop(0)
                    if row.accept(tk, float(flp[f_start[j] + t]), 0.0,
                                  self.max_len) != "continue":
                        raise AssertionError(
                            "fusion guard admitted a terminating block")
            elif was_forced:
                row.forced_q.pop(0)
            self.stats.tokens_generated += 1
            if not was_forced:
                self.stats.sampled_tokens += 1
            action = row.accept(int(first[j]), float(lp[j]),
                                0.0 if was_forced else 1.0, self.max_len)
            if action == "call":
                self._on_call(slot)
            elif action == "done":
                self._evict(slot)
        return True

    # -- disaggregated prefill: the decode-side splice --------------------
    def _splice_ready_rows(self) -> bool:
        """Decode-side half of the disaggregated split: install rows the
        prefill workers finished into freed slots, one copy-only call each
        (``_splice_fn``). No forward runs on the decode thread. On the card
        the decode stream first waits on the row's event (its prefill is
        done on the worker's stream), and the worker's cache is marked as
        used by the decode stream so that its memory outlives the copy."""
        free = [s for s in range(self.max_slots) if self._rows[s] is None]
        if not free:
            return False
        ready: List[ReadyRow] = []
        with self._queue_lock:
            while free and self._ready:
                ready.append(self._ready.popleft())
                free.pop(0)
        if not ready:
            return False
        free = [s for s in range(self.max_slots) if self._rows[s] is None]
        t0 = time.monotonic()
        stream = (torch.cuda.current_stream(self.device)
                  if self.device.type == "cuda" else None)
        installed = 0
        for i_rr, rr in enumerate(ready):
            row = rr.row
            pages: List[int] = []
            if self.paged_kv:
                alloc = self._alloc_pages(self._row_pages_needed(rr.seq_len))
                if alloc is None:
                    if self._pages.used_pages == 0:
                        self._finish_capacity(row)      # can never fit
                        continue
                    with self._queue_lock:    # pool pressure: retry later
                        for back in reversed(ready[i_rr:]):
                            self._ready.appendleft(back)
                    break
                pages = alloc
            slot = free.pop(0)
            if stream is not None:
                stream.wait_event(rr.event)
            key = self._tensor(row.key.astype(np.int64), torch.int64)
            if self.paged_kv:
                self._cache, state = self._splice_fn(  # noqa: RA204
                    self._cache, rr.pcache, slot,
                    self._tensor(pages, torch.int64), rr.seq_len, rr.first,
                    rr.init_counter, key, row.req.temperature,
                    row.req.adapter_index, self._d_cur, self._d_counters,
                    self._d_keys, self._d_temps, self._d_row_ids)
            else:
                self._cache, state = self._splice_fn(  # noqa: RA204
                    self._cache, rr.pcache, slot, rr.seq_len, rr.first,
                    rr.init_counter, key, row.req.temperature,
                    row.req.adapter_index, self._d_cur, self._d_counters,
                    self._d_keys, self._d_temps, self._d_row_ids)
            if stream is not None:
                for t in rr.pcache.values():
                    t.record_stream(stream)
            (self._d_cur, self._d_counters, self._d_keys, self._d_temps,
             self._d_row_ids) = state
            self._mask_sig = None      # slot contents changed
            now = time.monotonic()
            installed += 1
            self._rows[slot] = row
            self._prompts[slot] = list(row.req.prompt)
            self._tr_install(slot, row, now)
            if self.paged_kv:
                self._assign_slot_pages(slot, pages, rr.seq_len)
                self._index_prompt(row, pages)
            n_fused = len(rr.forced_lps)
            if rr.forced_first or n_fused:        # env-stage resume splice
                if rr.forced_first:
                    row.forced_q.pop(0)
                if row.gen:                       # the resume re-prefilled
                    self.stats.replays += 1       # the whole prefix
                    self.stats.replay_tokens += rr.seq_len - n_fused
            elif row.gen:                         # preemption replay
                self.stats.replays += 1
                self.stats.replay_tokens += rr.seq_len
            else:                                 # fresh row
                self.stats.prefills += 1
                row.started_at = now
            self.stats.splices += 1
            self.stats.splice_wait_seconds += max(0.0, now - rr.ready_at)
            if n_fused:
                # response-prefill fusion: the worker prefilled the whole
                # forced block; its tokens are booked here with the
                # prefill logprobs
                self.stats.fused_forced_tokens += n_fused
                self.stats.tokens_generated += n_fused
                for t in range(n_fused):
                    tk = row.forced_q.pop(0)
                    if row.accept(tk, rr.forced_lps[t], 0.0,
                                  self.max_len) != "continue":
                        raise AssertionError(
                            "fusion guard admitted a terminating block")
            self.stats.tokens_generated += 1
            if not rr.forced_first:
                self.stats.sampled_tokens += 1
            action = row.accept(rr.first, rr.lp,
                                0.0 if rr.forced_first else 1.0,
                                self.max_len)
            if action == "call":
                self._on_call(slot)
            elif action == "done":
                self._evict(slot)
        if installed == 0:
            return False
        now = time.monotonic()
        self.stats.refills += 1        # one refill event (starvation aging)
        self.stats.splice_seconds += now - t0
        if self.on_stage is not None:
            self.on_stage("splice",
                          "+".join(sorted({rr.row.req.task_id
                                           for rr in ready})), t0, now)
        if self._tracer is not None:
            self._tracer.span(("rollout", "splice"),
                              "+".join(sorted({rr.row.req.task_id
                                               for rr in ready})), t0, now)
        return True

    # -- tool calls: freeze in the slot, or park in the env stage ---------
    def _on_call(self, slot: int):
        """Route a freshly sampled CALL: park the row in the env stage
        (``env_stage``) or freeze it in its slot."""
        if self._env is not None:
            self._park(slot)
        else:
            self._dispatch_tool(slot)

    def _dispatch_tool(self, slot: int):
        """Freeze-in-slot: the row stays resident (advance 0) while the call
        runs on the pool."""
        self._pending[slot], self._pending_tok[slot] = _submit_tool_call(
            self._rows[slot], self._prompts[slot], self._pool, self._rng,
            self.sim_latency)
        self._pending_t0[slot] = time.monotonic()
        if self._tracer is not None:
            # freeze-in-slot: the row stays resident, so the env window is
            # a lifecycle state only (no park hand-off)
            self._tracer.mark(self._trace_of(self._rows[slot]), "env",
                              self._pending_t0[slot])

    def _park(self, slot: int):
        """Env-stage path: vacate the slot the moment the row samples CALL.
        The generated prefix lives host-side, so the slot is refillable at
        once while an env worker runs the call. With the paged cache the
        row's resume state is kept: its pages stay in the pool under the
        prefix cache, else they go to a host snapshot (``resume_restore``),
        and the resume splices them back instead of replaying."""
        row = self._rows[slot]
        row.ensure_session()
        query = list(self._prompts[slot]) + row.gen
        latency = row.req.env.sample_env_latency(
            _RandomShim(self._rng)) if not self.sim_latency else 0.0
        if self.paged_kv:
            self._park_or_snap(slot, row)
        fid = 0
        if self._tracer is not None:
            fid = self._tracer.next_flow("park")
            now = time.monotonic()
            self._tr_vacate(slot, row, now, flow_out=fid)
            self._tracer.mark(self._trace_of(row), "parked", now)
        self._rows[slot] = None
        self._prompts[slot] = None
        self.stats.parks += 1
        job = self._env.submit(row, query, row.req.task_id, latency)
        job.flow = fid

    def _pump_env_stage(self):
        """Resolve the env stage's response queue: expire timed-out jobs
        (their rows finish with tool_timeout; they hold no slot), and turn
        each response into a resume job: the row re-enters the scheduler
        queue with its force-feed queue pre-loaded, and the restore or
        prefill path brings it back with the forced RESP opener."""
        now = time.monotonic()
        for job in self._env.expire(now, self.tool_timeout_s):
            row = job.row
            row.status, row.finish_reason = "done", "tool_timeout"
            self._complete_parked(row)
        # drain_resolved() pops the whole resolved batch: process every job
        # before raising an error, else the siblings' rows would vanish
        # from all accounting (no slot, no queue, no completion)
        first_error: Optional[BaseException] = None
        for job in self._env.drain_resolved():
            row = job.row
            if job.error is not None:
                # a ToolError (permanent, or retries spent) is an expected
                # episode outcome: the row finishes with tool_error. Any
                # other error is a fault of the stack and stays fatal.
                row.status, row.finish_reason = "done", "tool_error"
                self.stats.tool_errors += 1
                if self._tracer is not None:
                    self._tracer.mark(self._trace_of(row), "tool_error")
                self._complete_parked(row)
                if not isinstance(job.error, ToolError):
                    first_error = first_error or job.error
                continue
            tid = row.req.task_id
            self.stats.add_env_wait(tid, job.resolved_at - job.submitted_at)
            if self.on_stage is not None:
                self.on_stage("env", tid, job.submitted_at, job.resolved_at)
            if self._tracer is not None:
                # env worker span + the two hand-off arrows: park→env
                # (job.flow, opened at _park) and env→resume (opened
                # here, consumed when the row reinstalls into a slot)
                trace = self._trace_of(row)
                fid = self._tracer.next_flow("resume")
                self._tracer.span(("env", f"worker-{job.worker}"), tid,
                                  job.started_at, job.resolved_at,
                                  trace=trace, flow_in=job.flow,
                                  flow_out=fid)
                self._tracer.mark(trace, "env", job.started_at)
                self._tracer.mark(trace, "resume_queued", job.resolved_at)
                if isinstance(row.meta, dict):
                    row.meta["_flow_in"] = fid
            row.forced_q = [tok.RESP] + list(job.response) + [tok.ENDRESP]
            row.status = "active"
            self.stats.resumes += 1
            with self._queue_lock:
                self._sched.push(row, self.stats.refills)
        if first_error is not None:      # raised as fut.result() would
            raise first_error

    # -- scheduler interface ---------------------------------------------
    @torch.no_grad()
    def step(self) -> bool:  # step: one decode step; tensors=_cache,_stacked
        """One engine iteration: supervise the stages' workers, resolve the
        env stage's responses and the frozen tool calls, restore preempted
        or parked rows, install radix-sharable rows, fill the other freed
        slots (the splice of worker-prefilled rows with ``disagg_prefill``,
        else the fused refill), one decode step over the pool, evict
        finished rows. Returns True if any device work happened."""
        now = time.monotonic()
        progressed = False
        # stage supervision: find dead workers, recover their stranded
        # work, restart to complement (a no-op with no stage registered)
        self.supervisor.tick(now)
        # env stage: expire and resume parked rows
        if self._env is not None:
            self._pump_env_stage()
        # resolve / time out pending tool calls (freeze-in-slot)
        for slot in list(self._pending):
            fut = self._pending[slot]
            row = self._rows[slot]
            if fut.done():
                resp = fut.result()
                t0w = self._pending_t0[slot]
                tid = row.req.task_id
                self.stats.add_env_wait(tid, now - t0w)
                if self.on_stage is not None:
                    self.on_stage("env", tid, t0w, now)
                if self._tracer is not None:
                    trace = self._trace_of(row)
                    self._tracer.span(("env", "pool"), tid, t0w, now,
                                      trace=trace)
                    self._tracer.mark(trace, "decode", now)
                row.forced_q = [tok.RESP] + list(resp) + [tok.ENDRESP]
                row.status = "active"
                del self._pending[slot], self._pending_t0[slot]
                self._pending_tok.pop(slot, None)
            elif now - self._pending_t0[slot] > self.tool_timeout_s:
                row.status, row.finish_reason = "done", "tool_timeout"
                self._evict(slot)
        # snapshot-restore resume (paged engine): queued rows carrying a host
        # snapshot splice their saved pages back, before the fill path runs
        if self.resume_restore and self._restore_rows():
            progressed = True
        # radix/GRPO shared installs (prefix cache): rows whose prefix is
        # already in the pool retain it and prefill only their suffix,
        # before the fused refill
        if self.paged_kv and self._stacked is not None \
                and self._radix_fill_rows():
            progressed = True
        # fill freed slots from the queue: the splice of worker-prefilled
        # rows (decode never runs a prefill forward) or the fused refill
        if self.disagg_prefill:
            self._raise_stage_error()
            if self._stacked is None:
                with self._queue_lock:
                    has_queued = len(self._sched) > 0
                if has_queued:      # the fused refill's fail-fast
                    raise RuntimeError(
                        "no adapters installed — call set_adapters()")
            else:
                if not self._workers:
                    self._ensure_stage()  # first start or after a halt;
                                          # replacements are the
                                          # supervisor's
                if self._splice_ready_rows():
                    progressed = True
        elif self._refill_free_slots():
            progressed = True
        if self._env is not None and any(
                r is not None and r.status == "calling" for r in self._rows):
            raise AssertionError("env-stage invariant violated: a "
                                 "tool-waiting row holds a decode slot")
        if self.paged_kv:
            # pre-step growth: allocate the page each active row's next K/V
            # write lands in, or fork it if it is shared (cache-capacity
            # eviction on exhaustion); then upload the block table if the
            # topology changed, AFTER the forks: one host-to-device copy of
            # [max_slots, max_pages] int32
            self._ensure_decode_pages()
            if self._tbl_dirty and self._cache is not None \
                    and self._has_kv:
                self._cache["tbl"].copy_(torch.from_numpy(self._tbl_host))
                self._tbl_dirty = False
        advance = np.array(
            [1 if (r is not None and r.status == "active") else 0
             for r in self._rows], np.int32)
        if advance.sum() == 0:
            return progressed
        forced = np.zeros((self.max_slots,), np.int32)
        fmask = np.zeros((self.max_slots,), np.int32)
        for i, r in enumerate(self._rows):
            if r is not None and r.status == "active" and r.forced_q:
                forced[i] = r.forced_q[0]
                fmask[i] = 1
        # upload the masks only when they changed (steady decode between
        # evictions re-uses the device copies — zero uploads per step)
        sig = advance.tobytes() + forced.tobytes() + fmask.tobytes()
        if sig != self._mask_sig:
            self._d_masks = (self._tensor(forced, torch.int32),
                             self._tensor(fmask, torch.int32),
                             self._tensor(advance, torch.int32))
            self._mask_sig = sig
        d_forced, d_fmask, d_advance = self._d_masks
        # the step's clock starts on an idle stream
        _sync_stream(self.device)  # noqa: RT202
        t0 = time.monotonic()
        nxt, lp, self._cache, self._d_counters = self._step_fn(  # noqa: RA204
            self.base_params, self._stacked, self._d_row_ids, self._d_cur,
            self._cache, self._d_keys, self._d_counters, self._d_temps,
            d_forced, d_fmask, d_advance)
        self.forward_counts["decode"].add(1)
        self._d_cur = nxt
        # the step's intended sync: the host reads the sampled tokens
        nxt = nxt.cpu().numpy()  # noqa: RT202
        lp = lp.float().cpu().numpy()
        self.stats.decode_seconds += time.monotonic() - t0
        self.stats.decode_steps += 1
        self.stats.occupied_row_steps += int(advance.sum())
        self.stats.capacity_row_steps += self.max_slots
        # slot dead weight of freeze-in-slot: resident rows that spent this
        # decode step waiting on a tool
        self.stats.tool_wait_slot_steps += sum(
            1 for r in self._rows if r is not None and r.status == "calling")
        for slot, r in enumerate(self._rows):
            if r is None or r.status != "active" or advance[slot] == 0:
                continue
            if self.paged_kv:
                self._slot_pos[slot] += 1     # device cache["pos"] mirror
            was_forced = fmask[slot] == 1
            if was_forced:
                r.forced_q.pop(0)
            action = r.accept(int(nxt[slot]), float(lp[slot]),
                              0.0 if was_forced else 1.0, self.max_len)
            self.stats.tokens_generated += 1
            if not was_forced:
                self.stats.sampled_tokens += 1
            if action == "call":
                self._on_call(slot)
            elif action == "done":
                self._evict(slot)
        return True

    def drain(self, deadline_s: float = 300.0,
              stop: Optional[Callable[[], bool]] = None
              ) -> List[RolloutCompletion]:
        """Run until queue and pool are empty (or deadline); returns all
        completions produced during the drain. At the deadline, rows still
        resident, queued, in the prefill stage or parked in the env stage
        finish with "aborted", so every submitted request yields exactly one
        completion."""
        out: List[RolloutCompletion] = []
        deadline = time.monotonic() + deadline_s
        while not self.idle() and time.monotonic() < deadline:
            if stop is not None and stop():
                break
            progressed = self.step()
            out.extend(self.drain_completions())
            if not progressed:
                time.sleep(0.001)     # waiting on tools or prefill workers
        # the workers halt first: their unfinished rows return to the
        # queue, and ready-but-unspliced rows abort like queued ones. A
        # worker stuck past the join timeout cannot lose rows either: its
        # rows are swept into the queue here, and its late emit or teardown
        # drops rows it no longer owns.
        if self.queued() > 0 and self.disagg_prefill:
            self._halt_stage()
            with self._queue_lock:
                for rr in self._ready:
                    self._sched.push(rr.row, self.stats.refills)
                self._ready.clear()
                for row in self._stage_inflight:
                    self._sched.push(row, self.stats.refills)
                self._stage_inflight.clear()
        if self._env is not None and self._env.count() > 0:
            # parked episodes abort like queued ones; late worker results
            # drop on the cancelled flag. cancel_all also returns cancelled
            # executing jobs whose rows expire() finished earlier: those
            # must not complete twice.
            for job in self._env.cancel_all():
                row = job.row
                if row.status == "done":
                    continue
                row.status = "done"
                row.finish_reason = row.finish_reason or "aborted"
                self._complete_parked(row)
        for slot, r in enumerate(self._rows):
            if r is not None:
                r.status = "done"
                r.finish_reason = r.finish_reason or "aborted"
                self._evict(slot)
        with self._queue_lock:
            leftovers = self._sched.pop_all()
        for row in leftovers:
            # a preempted-then-aborted row keeps its generated prefix
            row.status, row.finish_reason = "done", "aborted"
            self._complete_parked(row)
        out.extend(self.drain_completions())
        return out

    def run_requests(self, requests: Sequence[RolloutRequest], adapter_trees,
                     deadline_s: float = 300.0
                     ) -> Tuple[List[Dict], RolloutStats]:
        """Convenience: submit a request list, drain, return results in
        submission order — drop-in comparable with `generate()`."""
        t0 = time.monotonic()
        for i, tree in enumerate(adapter_trees):
            self.set_adapters(i, tree)
        idx = {}
        for i, r in enumerate(requests):
            # unseeded requests default to the advancing submission counter
            idx[self.submit(r)] = i
        comps = self.drain(deadline_s)
        results: List[Optional[Dict]] = [None] * len(requests)
        for c in comps:
            if c.submit_index in idx:     # skip strays from an earlier call
                results[idx[c.submit_index]] = c.to_result()
        self.stats.wall_seconds += time.monotonic() - t0
        return results, self.stats

    def shutdown(self):
        if self._workers:
            self._halt_stage()
        if self._env is not None:
            self._env.halt()
        if self._own_pool:
            self._pool.shutdown(wait=False)


def to_trajectory_batch(results: List, task_id: str, version: int,
                        group_size: int, pad_to: int = None) -> TrajectoryBatch:
    """Pack engine results for ONE task into a padded TrajectoryBatch and
    verify rewards. Accepts `generate()` result dicts or
    `RolloutCompletion`s (continuous engine)."""
    results = [r.to_result() if isinstance(r, RolloutCompletion) else r
               for r in results]
    rows = [r for r in results if r["task_id"] == task_id]
    S = max(len(r["tokens"]) for r in rows)
    if pad_to:
        S = max(S, pad_to)
    S = -(-S // 8) * 8
    R = len(rows)
    tokens = np.zeros((R, S), np.int32)
    loss_mask = np.ones((R, S), np.float32)
    behavior = np.zeros((R, S), np.float32)
    p_lens = np.zeros((R,), np.int32)
    t_lens = np.zeros((R,), np.int32)
    rewards = np.zeros((R,), np.float32)
    for j, r in enumerate(rows):
        n = len(r["tokens"])
        tokens[j, :n] = r["tokens"]
        p_lens[j] = r["prompt_len"]
        t_lens[j] = n
        gen_len = n - r["prompt_len"]
        # behavior logprobs/losses sit at positions predicting each gen token
        pos = r["prompt_len"] - 1 + np.arange(gen_len)
        behavior[j, pos] = r["gen_logprobs"][:gen_len]
        loss_mask[j, pos] = r["gen_loss_mask"][:gen_len]
        comp = r["tokens"][r["prompt_len"]:]
        rewards[j] = r["env"].verify(r["truth"], comp)
    meta = {"loss_mask": loss_mask}
    if any("finish_reason" in r for r in rows):
        meta["finish_reasons"] = [r.get("finish_reason", "") for r in rows]
    return TrajectoryBatch(task_id=task_id, version=version, tokens=tokens,
                           prompt_lens=p_lens, total_lens=t_lens,
                           rewards=rewards, group_size=group_size,
                           behavior_logprobs=behavior[:, :S - 1],
                           meta=meta)
