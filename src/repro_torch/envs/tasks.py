"""The paper's workload archetypes, self-contained and synthetic:

  ArithmeticEnv ("gsm8k")     — short math, no tools, short rollouts
  LongMathEnv   ("amc12")     — longer chains, higher rollout latency
  SearchEnv     ("search")    — agentic: CALL → synthetic-KB lookup with
                                external latency → force-fed RESP tokens
  MultiHopSearchEnv ("hopsearch") — multi-turn agentic: the answer sits
                                `hops` KB links away; the session tracks
                                hop progress (link hops, then a value read)
  CalculatorEnv ("calcrepl")  — multi-turn agentic: a stateful accumulator
                                REPL; each call folds the next operand into
                                the session register and echoes it
  GuessRefineEnv ("guess")    — multi-turn agentic: a guess-and-refine
                                oracle that reveals one more digit of the
                                hidden answer per call
These are deliberately heterogeneous in rollout length, env latency, AND
tool-turn structure — the scenario diversity the env-interaction stage
(rollout/env_stage.py) is benchmarked against.

A copy of ``repro.envs.tasks``: the port keeps its own so that it imports nothing
of the JAX package.
"""
from __future__ import annotations

import random
from typing import List, Sequence, Tuple

from repro_torch.data import tokenizer as tok
from .base import Env, ToolSession, _answer_after_tools, _answer_reward


class ArithmeticEnv(Env):
    name = "gsm8k"
    is_agentic = False
    max_new_tokens = 8

    def __init__(self, max_operand: int = 20):
        self.max_operand = max_operand

    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], str]:
        a = rng.randint(0, self.max_operand)
        b = rng.randint(0, self.max_operand)
        prompt = f"{a}+{b}="
        answer = str(a + b)
        return [tok.BOS] + tok.encode(prompt), answer

    def verify(self, truth: str, completion_ids: Sequence[int]) -> float:
        return _answer_reward(truth, completion_ids)


class LongMathEnv(Env):
    name = "amc12"
    is_agentic = False
    max_new_tokens = 24

    def __init__(self, n_terms: int = 4, max_operand: int = 12):
        self.n_terms = n_terms
        self.max_operand = max_operand

    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], str]:
        terms = [rng.randint(1, self.max_operand) for _ in range(self.n_terms)]
        ops = [rng.choice("+-") for _ in range(self.n_terms - 1)]
        expr = str(terms[0])
        val = terms[0]
        for op, t in zip(ops, terms[1:]):
            expr += op + str(t)
            val = val + t if op == "+" else val - t
        return [tok.BOS] + tok.encode(expr + "="), str(val)

    def verify(self, truth: str, completion_ids: Sequence[int]) -> float:
        return _answer_reward(truth, completion_ids)


class SearchEnv(Env):
    """Agentic lookup against a synthetic KB (HotpotQA/wiki-search analogue).

    Prompt: "<entity>?" — the correct move is to emit <call> (the query is
    implicit: the engine passes the prompt row to tool_call), receive the
    force-fed "<resp>fact<endresp>" tokens, then answer with the fact.
    Rewards: graded match on the final answer.
    """
    name = "search"
    is_agentic = True
    max_new_tokens = 24
    env_latency_mean = 0.15      # external API latency (paper: wiki + judge)
    env_latency_std = 0.05

    def __init__(self, kb_size: int = 64, seed: int = 0):
        rng = random.Random(seed)
        entities = []
        while len(entities) < kb_size:
            e = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(3))
            if e not in entities:
                entities.append(e)
        self.kb = {e: str(rng.randint(10, 99)) for e in entities}
        self.entities = entities

    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], str]:
        e = rng.choice(self.entities)
        return [tok.BOS] + tok.encode(e + "?"), (e, self.kb[e])

    def tool_call(self, query_ids: Sequence[int], truth=None) -> List[int]:
        text = tok.decode(query_ids)
        for e in self.entities:
            if e in text:
                return tok.encode(self.kb[e])
        return tok.encode("00")

    def verify(self, truth, completion_ids: Sequence[int]) -> float:
        _, fact = truth
        # strip force-fed tool responses; grade only the final answer
        return _answer_reward(fact, _answer_after_tools(completion_ids))


def _gen_entities(rng: random.Random, n: int) -> List[str]:
    entities: List[str] = []
    while len(entities) < n:
        e = "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(3))
        if e not in entities:
            entities.append(e)
    return entities


def _rightmost_entity(text: str, entities) -> str:
    best, pos = None, -1
    for e in entities:
        p = text.rfind(e)
        if p > pos:
            best, pos = e, p
    return best


class _HopSession(ToolSession):
    """Stateful hop tracker: the first `hops-1` calls follow KB links
    (entity → next entity), the final call reads the value at the terminal
    entity. Which lookup happens depends on per-episode state (the hop
    counter), not on the query alone."""

    def call(self, query_ids: Sequence[int],
             cancel=None) -> List[int]:
        self.turns += 1
        env: "MultiHopSearchEnv" = self.env
        e = _rightmost_entity(tok.decode(query_ids), env.entities)
        if e is None:
            e = self.truth[0]
        if self.turns < env.hops:
            return tok.encode(env.next_of[e])
        return tok.encode(env.value_of[e])


class MultiHopSearchEnv(Env):
    """Multi-hop agentic lookup (HotpotQA-style): the prompt names a start
    entity; the answer is `hops` KB reads away. Each hop is one CALL turn —
    the session force-feeds the next entity (or, on the last hop, the
    value), so one episode interleaves several RESP…ENDRESP blocks."""
    name = "hopsearch"
    is_agentic = True
    max_new_tokens = 24
    max_turns = 2                 # == hops (set in __init__)
    env_latency_mean = 0.08       # per-hop external API latency
    env_latency_std = 0.02

    def __init__(self, kb_size: int = 32, hops: int = 2, seed: int = 0):
        if hops < 1:
            raise ValueError("hops must be >= 1")
        rng = random.Random(seed)
        self.entities = _gen_entities(rng, kb_size)
        # a single cyclic chain: every start entity has a well-defined
        # `hops`-step walk ending in a value read
        self.next_of = {e: self.entities[(i + 1) % kb_size]
                        for i, e in enumerate(self.entities)}
        self.value_of = {e: str(rng.randint(10, 99)) for e in self.entities}
        self.hops = hops
        self.max_turns = hops

    def _terminal(self, start: str) -> str:
        e = start
        for _ in range(self.hops - 1):
            e = self.next_of[e]
        return e

    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], tuple]:
        s = rng.choice(self.entities)
        answer = self.value_of[self._terminal(s)]
        return [tok.BOS] + tok.encode(s + "?"), (s, answer)

    def open_session(self, truth) -> ToolSession:
        return _HopSession(self, truth)

    def tool_call(self, query_ids: Sequence[int], truth=None) -> List[int]:
        # stateless fallback (single-turn callers): value at the last entity
        e = _rightmost_entity(tok.decode(query_ids), self.entities)
        return tok.encode(self.value_of[e] if e else "00")

    def verify(self, truth, completion_ids: Sequence[int]) -> float:
        _, answer = truth
        return _answer_reward(answer, _answer_after_tools(completion_ids))


class _ReplSession(ToolSession):
    """Stateful accumulator REPL: call k folds operand k into the register
    and echoes the running total. The same query issued twice returns
    DIFFERENT responses — the canonical stateful-session behaviour."""

    def __init__(self, env, truth):
        super().__init__(env, truth)
        self.register = 0
        self.idx = 0

    def call(self, query_ids: Sequence[int],
             cancel=None) -> List[int]:
        self.turns += 1
        nums = self.truth[0]
        if self.idx < len(nums):
            self.register += nums[self.idx]
            self.idx += 1
        return tok.encode(str(self.register))


class CalculatorEnv(Env):
    """Stateful calculator REPL: the prompt lists operands ("sum 3 7 2=");
    each CALL turn adds the next operand to the session register and
    force-feeds the running total; the episode answers with the final sum."""
    name = "calcrepl"
    is_agentic = True
    max_new_tokens = 16
    max_turns = 3                 # == n_terms (set in __init__)
    env_latency_mean = 0.05
    env_latency_std = 0.01

    def __init__(self, n_terms: int = 3, max_operand: int = 9):
        self.n_terms = n_terms
        self.max_operand = max_operand
        self.max_turns = n_terms

    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], tuple]:
        nums = tuple(rng.randint(1, self.max_operand)
                     for _ in range(self.n_terms))
        prompt = "sum " + " ".join(str(n) for n in nums) + "="
        return [tok.BOS] + tok.encode(prompt), (nums, str(sum(nums)))

    def open_session(self, truth) -> ToolSession:
        return _ReplSession(self, truth)

    def tool_call(self, query_ids: Sequence[int], truth=None) -> List[int]:
        # stateless fallback: the full sum in one shot
        return tok.encode(truth[1] if truth else "0")

    def verify(self, truth, completion_ids: Sequence[int]) -> float:
        _, total = truth
        return _answer_reward(total, _answer_after_tools(completion_ids))


class _RevealSession(ToolSession):
    """Guess-and-refine oracle: call k reveals the first k digits of the
    hidden answer (monotone refinement, stateful reveal counter)."""

    def call(self, query_ids: Sequence[int],
             cancel=None) -> List[int]:
        self.turns += 1
        secret = self.truth
        return tok.encode(secret[:min(self.turns, len(secret))])


class GuessRefineEnv(Env):
    """Guess-and-refine game: the answer is hidden; every CALL turn the
    oracle reveals one more digit. More turns → better information → better
    final answer (the reward gradient the turn budget trades against)."""
    name = "guess"
    is_agentic = True
    max_new_tokens = 12
    max_turns = 3                 # == digits (set in __init__)
    env_latency_mean = 0.05
    env_latency_std = 0.01

    def __init__(self, digits: int = 3):
        if digits < 1:
            raise ValueError("digits must be >= 1")
        self.digits = digits
        self.max_turns = digits

    def sample_prompt(self, rng: random.Random) -> Tuple[List[int], str]:
        secret = "".join(rng.choice("0123456789") for _ in range(self.digits))
        return [tok.BOS] + tok.encode("guess?"), secret

    def open_session(self, truth) -> ToolSession:
        return _RevealSession(self, truth)

    def tool_call(self, query_ids: Sequence[int], truth=None) -> List[int]:
        # stateless fallback: first digit only
        return tok.encode(truth[:1] if truth else "0")

    def verify(self, truth, completion_ids: Sequence[int]) -> float:
        return _answer_reward(truth, _answer_after_tools(completion_ids))


class CopyEnv(Env):
    """Echo task with dense per-char reward — the fastest-learning RLVR
    sanity signal (used by the learning demo / Fig-1-shape test: reward must
    visibly improve under GRPO within tens of versions at toy scale)."""
    name = "copy"
    is_agentic = False
    max_new_tokens = 6

    def __init__(self, length: int = 3, alphabet: str = "012"):
        self.length = length
        self.alphabet = alphabet

    def sample_prompt(self, rng: random.Random):
        s = "".join(rng.choice(self.alphabet) for _ in range(self.length))
        return [tok.BOS] + tok.encode(s + "="), s

    def verify(self, truth: str, completion_ids) -> float:
        ids = []
        for i in completion_ids:
            if int(i) == tok.EOS:
                break
            ids.append(int(i))
        got = tok.decode(ids)
        hits = sum(1 for a, b in zip(got, truth) if a == b)
        exact = 0.2 if got == truth else 0.0
        return 0.8 * hits / len(truth) + exact


REGISTRY = {
    "gsm8k": ArithmeticEnv,
    "amc12": LongMathEnv,
    "search": SearchEnv,
    "hopsearch": MultiHopSearchEnv,
    "calcrepl": CalculatorEnv,
    "guess": GuessRefineEnv,
    "copy": CopyEnv,
}


def make_env(name: str, **kw) -> Env:
    return REGISTRY[name](**kw)
