"""The traffic is a function of its file and the seed."""
import random

import pytest

from rlbench.harness.traffic import Traffic, reward

MIX = {"tenants": 8, "system_prompt_tokens": 256, "problem_tokens": [64, 96, 128],
       "output_budgets": [32, 64, 96, 128], "group_size": 8,
       "groups_per_batch": 2, "min_train_rows": 8, "max_staleness": 1,
       "greedy_every": 4, "reward_classes": 8, "max_len": 512}
SEEDS = [0, 7, 2 ** 31 + 11, 2 ** 40 + 3]


def _stream(t, i, n=6):
    env, rng = t.env(i), t.datagen(i)
    return [env.sample_prompt(rng) for _ in range(n)]


@pytest.mark.parametrize("seed", SEEDS)
def test_same_seed_same_traffic(seed):
    a, b = Traffic(MIX, seed, 1000), Traffic(MIX, seed, 1000)
    assert a.budget == b.budget and a.lengths == b.lengths
    assert a.system == b.system
    for i in range(MIX["tenants"]):
        assert _stream(a, i) == _stream(b, i)


@pytest.mark.parametrize("seed", SEEDS[1:])
def test_every_seed_the_same_sizes_in_another_order(seed):
    a, b = Traffic(MIX, 0, 1000), Traffic(MIX, seed, 1000)
    assert sorted(a.budget) == sorted(b.budget)
    for i in range(MIX["tenants"]):
        assert sorted(a.lengths[i]) == sorted(b.lengths[i])
        assert len(a.system[i]) == len(b.system[i]) == 256
    assert a.system != b.system


def test_prompts_share_the_tenants_system_prompt_and_avoid_specials():
    t = Traffic(MIX, 5, 1000)
    for i in range(MIX["tenants"]):
        for prompt, truth in _stream(t, i):
            assert prompt[:256] == t.system[i]
            assert min(prompt) >= 8 and max(prompt) < 1000
            assert 0 <= truth < 8
            assert len(prompt) - 256 in MIX["problem_tokens"]


def test_greedy_groups_and_reward():
    t = Traffic(MIX, 1, 1000)
    assert [g for g in range(12) if t.is_greedy(g)] == [3, 7, 11]
    assert reward(3, [3, 11, 4, 19], 8) == 0.75
    assert reward(0, [], 8) == 0.0
    rng = random.Random(0)
    draws = {reward(2, [rng.randrange(8, 1000) for _ in range(64)], 8)
             for _ in range(8)}
    assert len(draws) > 1          # a group's rows get different rewards


def test_pool_pages_by_hand():
    t = Traffic(MIX, 1, 1000)
    # 8 system prompts of 16 pages, 8 x 2 x 2 groups of 8 problem pages,
    # 128 slots of 8 + 1 pages
    assert t.pool_pages(16, 128) == 8 * 16 + 32 * 8 + 128 * 9
