"""The one traffic generator: a traffic file's parameters and the seed give
every tenant's prompt stream, output budget and reward.

Every seed gets the same sizes in another order: tenant i's budget is
``output_budgets[i mod len]`` whatever the seed (which tenant gets which
budget changes how the closed loop settles, and so the work), and each
tenant's problem lengths cycle through a seed-drawn order of
``problem_tokens``. The seed also draws the token ids:
each tenant's ``system_prompt_tokens``-long system prompt (shared by all
its prompts) and each problem's ids, from [8, V) (0..7 are the special
tokens). A group's rows share its prompt.

The reward of a completion is the share of its tokens whose id falls in the
prompt's class (id mod ``reward_classes``): random weights give every row a
different share, so a group's advantages are not all zero. The first row
of every ``greedy_every``-th group of a tenant (group index ≡ -1 mod
greedy_every) decodes greedily, the group's other rows sample: the greedy
rows carry the served-token logit check (``correct.py``), and the group
still trains on advantages that differ.
"""
from __future__ import annotations

import random
from typing import Dict, List, Sequence

import numpy as np

from repro_torch.envs.base import Env

FIRST_ID = 8


def _rng(seed: int, *salt: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (2 ** 63)] + list(salt))


class PromptEnv(Env):
    """A tenant's prompt source and verifier (the runtime's env interface)."""
    is_agentic = False

    def __init__(self, name: str, system: List[int], lengths: Sequence[int],
                 vocab: int, classes: int):
        self.name = name
        self.system = list(system)
        self.lengths = list(lengths)
        self.vocab = vocab
        self.classes = classes
        self.calls = 0          # prompts drawn (the rollout thread only)

    def sample_prompt(self, rng: random.Random):
        n = self.lengths[self.calls % len(self.lengths)]
        self.calls += 1
        ids = [rng.randrange(FIRST_ID, self.vocab) for _ in range(n)]
        return self.system + ids, rng.randrange(self.classes)

    def verify(self, truth, completion_ids) -> float:
        return reward(truth, completion_ids, self.classes)


def reward(truth: int, completion_ids: Sequence[int], classes: int) -> float:
    if not len(completion_ids):
        return 0.0
    ids = np.asarray(completion_ids, np.int64)
    return float(np.mean(ids % classes == truth))


class Traffic:
    """One mix under one seed."""

    def __init__(self, mix: Dict, seed: int, vocab: int):
        self.mix = mix
        self.seed = int(seed)
        self.vocab = vocab
        n = mix["tenants"]
        budgets = mix["output_budgets"]
        self.budget = [budgets[i % len(budgets)] for i in range(n)]
        self.lengths = [list(_rng(seed, 1, i).permutation(mix["problem_tokens"]))
                        for i in range(n)]
        sp = mix["system_prompt_tokens"]
        self.system = [_rng(seed, 2, i).integers(FIRST_ID, vocab, sp).tolist()
                       for i in range(n)]

    @property
    def tenants(self) -> int:
        return self.mix["tenants"]

    def tid(self, i: int) -> str:
        return f"t{i:02d}"

    def env(self, i: int) -> PromptEnv:
        return PromptEnv(self.tid(i), self.system[i], self.lengths[i],
                         self.vocab, self.mix["reward_classes"])

    def datagen(self, i: int) -> random.Random:
        """The tenant's pinned prompt stream (the runtime would seed it from
        the salted ``hash()``)."""
        return random.Random(self.seed * 4099 + i)

    def is_greedy(self, group_index: int) -> bool:
        """Whether the group's first row decodes greedily."""
        k = self.mix["greedy_every"]
        return bool(k) and group_index % k == k - 1

    def pool_pages(self, page: int, slots: int) -> int:
        """Pages at the cell's peak demand: every tenant's system prompt in
        the index, the problems of every group in flight (each tenant
        ``max_staleness + 1`` batches), and every slot's own pages for its
        longest completion, each rounded up to whole pages, plus one page a
        slot for a forked partial page."""
        m = self.mix
        pg = -(-m["system_prompt_tokens"] // page) if m["system_prompt_tokens"] else 0
        groups = m["tenants"] * (m["max_staleness"] + 1) * m["groups_per_batch"]
        prob = -(-max(m["problem_tokens"]) // page)
        own = -(-max(m["output_budgets"]) // page) + 1
        return m["tenants"] * pg + groups * prob + slots * own
