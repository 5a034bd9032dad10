"""Round-fused multi-LoRA rollout engine (paper §4.1/§4.5): the part of
``repro.rollout.engine`` behind ``RolloutEngine.generate``.

One fixed batch of cross-task requests runs to completion: one batched
prefill, then a loop of decode steps. Each row runs under its own tenant's
LoRA adapter (the SGMV kernel on the card) and samples from its own key, so a
row's tokens depend only on its own (key, counter, logits) and reproduce the
JAX engine's tokens from the same logits. Agentic rows that emit
``tok.CALL`` are frozen (advance 0) while their tool call runs on a thread
pool, then force-fed the response; forced tokens do not count against
``max_new_tokens``.

The step functions are plain Python closures over the model; the engine
keeps them as ``_prefill_fn``, ``_first_fn`` and ``_step_fn`` so that a test
can wrap them, as the JAX engine's tests do. Serving runs under
``torch.inference_mode()``. ``to_trajectory_batch`` packs one task's
results for the trainer. The continuous slot engine, the paged cache, the
disaggregated prefill workers and the env stage are not ported yet.
"""
from __future__ import annotations

import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.data import tokenizer as tok
from repro_torch.envs.base import CancelToken, Env, call_session
from repro_torch.lora.adapters import batched_ctx, stack_adapters
from repro_torch.models import decode_step, forward_seq, init_cache, lm_logits
from repro_torch.models.common import resolve_device, synchronize
from repro_torch.rl.types import RolloutCompletion, TrajectoryBatch
from repro_torch.rollout import prng
from repro_torch.rollout.prefill import _bucket_len, _sample_rows


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
    max_turns: Optional[int] = None   # tool-turn budget for this episode
                                      # (None -> env.max_turns; 0 = unlimited)


@dataclass
class RolloutStats:
    """The counters ``generate`` fills (the continuous engine's extras of the
    JAX package are not ported yet)."""
    decode_steps: int = 0
    prefill_tokens: int = 0
    decode_seconds: float = 0.0     # decode-stage device time only
    prefill_seconds: float = 0.0    # prefill-stage device time
    env_wait_seconds: float = 0.0
    wall_seconds: float = 0.0
    prefills: int = 0
    tokens_generated: int = 0
    sampled_tokens: int = 0
    env_wait_by_task: Dict[str, float] = field(default_factory=dict)
                                   # per-tenant env-interaction wait seconds

    def add_env_wait(self, task_id: str, wait: float):
        """Book one resolved tool call's wait (global + per-tenant)."""
        self.env_wait_seconds += wait
        self.env_wait_by_task[task_id] = (
            self.env_wait_by_task.get(task_id, 0.0) + wait)


def _log_softmax_at(logits, idx):
    return torch.gather(torch.log_softmax(logits, dim=-1), 1,
                        idx[:, None].long())[:, 0]


def _decode_sample_core(cfg, params, adapters, row_ids, cur_tokens, cache,
                        keys, counters, temps, forced, forced_mask, advance):
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
        h, cache, _ = forward_seq(params, tokens, cfg, lora, cache)
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


class _Row:
    """Host-side per-episode state machine (one batch lane)."""
    __slots__ = ("req", "prompt_len", "gen", "lps", "lmask", "sampled",
                 "forced", "status", "forced_q", "finish_reason", "session",
                 "turns")

    def __init__(self, req: RolloutRequest):
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
        self.session = None           # per-episode ToolSession (lazy)
        self.turns = 0                # tool calls dispatched this episode

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
    """

    def __init__(self, cfg: ModelConfig, base_params, *, max_len: int = 128,
                 seed: int = 0, device="cuda"):
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
            nxt = nxt.cpu().numpy()
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
