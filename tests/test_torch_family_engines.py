"""The port's engines on the ssm (mamba2), hybrid (zamba2) and moe
(deepseek-moe) families against the JAX package's, on the CPU.

``tiny_lm()`` configs of the three families (the reference scenarios'
models: 2 layers, d=64, the rollout tokenizer's vocabulary; MoE at
capacity_factor 8, so that no token is dropped and continuous output equals
one-shot output), weights carried over with ``repro_torch.bridge``, adapters
with b ~ N(0, 0.3^2) in both subtrees. Both packages' engines get the same
requests, seeds and external drive. Token streams, loss masks and finish
reasons must be equal, logprobs within 1e-5 (the reference tests'
tolerance), and the ``RolloutStats`` counters that do not depend on thread
timing equal. Each paged engine's ``check_page_invariants()`` runs after
every step.

Scenarios, from the JAX package's tests (each parametrised over attention,
ssm and hybrid there; the attention case is replayed in
``test_torch_continuous.py``, ``test_torch_disagg.py`` and
``test_torch_prefix.py``): restore/resume parity under preemption at
several steps over the paged pool (``test_paged_kv.py:173``), preemption
replay on the dense cache (``test_preemption_property.py:82``), the
disaggregated prefill token for token and chunked (``test_prefill_disagg.py
:88,105``), and the prefix cache degrading to a no-op where the cache holds
recurrent state (``test_prefix_cache.py:376``); then MoE through the
round-fused and the continuous engine."""
import dataclasses
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny_lm
from repro.data import tokenizer as tok
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout.engine import (ContinuousRolloutEngine, RolloutEngine,
                                  RolloutRequest)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.rollout.engine import (
    ContinuousRolloutEngine as PtContinuous, RolloutEngine as PtEngine,
    RolloutRequest as PtRequest)
from repro_torch.rollout.prefill import effective_chunk

FAMS = {"ssm": "mamba2-780m", "hybrid": "zamba2-1.2b",
        "moe": "deepseek-moe-16b"}
RECURRENT = ["ssm", "hybrid"]
LP_TOL = 1e-5
_TIMINGS = {"decode_seconds", "prefill_seconds", "env_wait_seconds",
            "wall_seconds", "splice_seconds", "splice_wait_seconds",
            "decode_stall_seconds", "env_wait_by_task"}
_WEIGHTS = {}


def _weights(fam):
    """(JAX cfg, port cfg, JAX params, JAX trees, port params, port trees)."""
    if fam not in _WEIGHTS:
        name = FAMS[fam]
        jcfg = tiny_lm(name)
        pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[name],
                                              dtype="float32"),
                                   vocab_size=tok.VOCAB_SIZE)
        if pcfg.moe is not None:
            pcfg = dataclasses.replace(pcfg, moe=dataclasses.replace(
                pcfg.moe, capacity_factor=8.0))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
        params = jax.tree.map(np.asarray,
                              init_params(jax.random.PRNGKey(0), jcfg))
        rs = np.random.RandomState(7)
        trees = []
        for t in range(2):
            tree = jax.tree.map(np.asarray,
                                init_lora(jax.random.PRNGKey(1 + t), jcfg))
            for sub in tree.values():
                for leaf in sub.values():
                    leaf["b"] = (rs.randn(*leaf["b"].shape)
                                 * 0.3).astype(np.float32)
            trees.append(tree)
        _WEIGHTS[fam] = (jcfg, pcfg, jax.tree.map(jnp.asarray, params),
                         [jax.tree.map(jnp.asarray, t) for t in trees],
                         bridge.params_from_jax(params, pcfg, "cpu"),
                         [bridge.lora_from_jax(t, "cpu") for t in trees])
    return _WEIGHTS[fam]


def _requests(n=3, seed=7, long_prompts=False, n_tenants=2):
    """The same gsm8k requests for both packages (budgets 5 + 2i, explicit
    seeds; `long_prompts`: the chunked-prefill scenario's 40 + 7i
    tokens)."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    rj, rp = random.Random(seed), random.Random(seed)
    jreqs, preqs = [], []
    for i in range(n):
        pj, tj = jenv.sample_prompt(rj)
        pp, tp = penv.sample_prompt(rp)
        assert (pj, tj) == (pp, tp)
        budget = 5 + 2 * i
        if long_prompts:
            pj = (pj * 10)[:40 + 7 * i]
            budget = 5
        args = (f"t{i % n_tenants}", i % n_tenants, list(pj), tj)
        jreqs.append(RolloutRequest(*args, jenv, max_new_tokens=budget,
                                    seed=i))
        preqs.append(PtRequest(*args[:3], tp, penv, max_new_tokens=budget,
                               seed=i))
    return jreqs, preqs


def _engines(fam, **kw):
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = _weights(fam)
    je = ContinuousRolloutEngine(jcfg, jparams, max_slots=2, max_adapters=2,
                                 seed=0, **kw)
    pe = PtContinuous(pcfg, pparams, max_slots=2, max_adapters=2, seed=0,
                      device="cpu", **kw)
    for i in range(2):
        je.set_adapters(i, jtrees[i])
        pe.set_adapters(i, ptrees[i])
    return je, pe


def _one_shot(fam, preqs, max_len):
    """The port's uninterrupted one-shot ``generate`` (the reference
    scenarios' oracle)."""
    _, pcfg, _, _, pparams, ptrees = _weights(fam)
    out, _ = PtEngine(pcfg, pparams, max_len=max_len, seed=0,
                      device="cpu").generate(preqs, ptrees)
    return out


def _drive(eng, reqs, preempt_at=0, victims=(), max_iters=3000):
    """Submit, step to idle (preempting `victims` after productive step
    `preempt_at`); completions by request index and rows preempted; page
    invariants after every step of a paged engine."""
    pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, preempted, it = {}, 0, 0
    deadline = time.monotonic() + 120
    while not eng.idle() and it < max_iters and time.monotonic() < deadline:
        progressed = eng.step()
        if progressed:
            it += 1
            if it == preempt_at:
                for v in victims:
                    preempted += eng.preempt_tenant(v)
        if eng.paged_kv:
            eng.check_page_invariants()
        for c in eng.drain_completions():
            comps[pos_of[c.submit_index]] = c
        if not progressed:
            time.sleep(0.0005)
    assert len(comps) == len(reqs), "engine failed to drain"
    return comps, preempted


def _counters(stats, keys=None):
    out = {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
           if f.name not in _TIMINGS}
    return out if keys is None else {k: out[k] for k in keys}


def _same(cp, cj, n):
    for i in range(n):
        a, b = cj[i], cp[i]
        assert list(a.tokens) == list(b.tokens), i
        assert list(a.gen_loss_mask) == list(b.gen_loss_mask), i
        assert a.finish_reason == b.finish_reason, i
        np.testing.assert_allclose(b.gen_logprobs, a.gen_logprobs,
                                   rtol=LP_TOL, atol=LP_TOL)


def _matches_one_shot(comps, ref):
    for i, r in enumerate(ref):
        c = comps[i]
        assert list(c.tokens) == r["tokens"], i
        assert list(c.gen_loss_mask) == r["gen_loss_mask"], i
        np.testing.assert_allclose(c.gen_logprobs, r["gen_logprobs"],
                                   atol=LP_TOL)


@pytest.mark.parametrize("fam", RECURRENT)
def test_restore_resume_parity_over_the_paged_pool(fam):
    """test_paged_kv.py::test_restore_resume_parity_property on both
    packages (prefix cache on, as there): preempting at several steps
    restores the rows' saved state (a pure-SSM row's ssm/conv rows from a
    host snapshot; a hybrid row's pages kept in the pool and its recurrent
    rows from a host snapshot) with no replay, and every drive equals the
    one-shot output; the port's streams and counters are the JAX
    engine's."""
    jreqs, preqs = _requests()
    ref = _one_shot(fam, preqs, 64)
    je, pe = _engines(fam, max_len=64, paged_kv=True, kv_page_size=16)
    preempted = 0
    for step, victims in ((2, ("t0",)), (5, ("t1",)), (3, ("t0", "t1")),
                          (9, ("t0", "t1"))):
        cj, _ = _drive(je, jreqs, step, victims)
        cp, n = _drive(pe, preqs, step, victims)
        preempted += n
        _same(cp, cj, len(preqs))
        _matches_one_shot(cp, ref)
    assert preempted > 0 and pe.stats.restores > 0
    assert pe.stats.replays == 0 and pe.stats.replay_tokens == 0
    assert pe.stats.snapshots > 0           # recurrent state went to host
    if fam == "hybrid":
        assert pe.stats.device_resident_resumes > 0
    else:
        assert pe.stats.device_resident_resumes == 0
    assert _counters(pe.stats) == _counters(je.stats)
    assert pe._pages.used_pages == pe._prefix_idx.held_pages == 0
    assert pe._snap_store.bytes_used == 0


def test_ssm_rows_take_no_pages_and_budget_counts_recurrent_bytes():
    """A pure-SSM row holds no page (``_row_pages_needed`` is 0; the paged
    cache has no pool), its snapshot is its ssm/conv rows (fp32 and the
    model dtype, as CPU tensors), and a snapshot budget below one row's
    recurrent bytes turns every preemption into a replay (the reference's
    ``test_snapshot_store_budget`` rule), with the same tokens."""
    jreqs, preqs = _requests()
    ref = _one_shot("ssm", preqs, 64)
    _, pcfg, _, _, pparams, ptrees = _weights("ssm")
    pe = PtContinuous(pcfg, pparams, max_slots=2, max_adapters=2, seed=0,
                      max_len=64, paged_kv=True, kv_page_size=16,
                      device="cpu")
    for i in range(2):
        pe.set_adapters(i, ptrees[i])
    pe._ensure_built()
    assert "kp" not in pe._cache and "tbl" not in pe._cache
    row_bytes = (pe._cache["ssm"][:, 0].nbytes + pe._cache["conv"][:, 0].nbytes)
    snaps = []
    orig = pe._snap_store.try_add
    pe._snap_store.try_add = lambda s: (snaps.append(s), orig(s))[1]
    comps, n = _drive(pe, preqs, 3, ("t0", "t1"))
    assert n > 0 and snaps and pe.stats.restores == n
    for s in snaps:
        assert s.kpages is None and s.n_pages == 0
        assert s.ssm.dtype == torch.float32 and s.nbytes == row_bytes
    _matches_one_shot(comps, ref)
    assert pe._pages.peak_used == 0
    tight = PtContinuous(pcfg, pparams, max_slots=2, max_adapters=2, seed=0,
                         max_len=64, paged_kv=True, kv_page_size=16,
                         snapshot_budget_bytes=row_bytes - 1, device="cpu")
    for i in range(2):
        tight.set_adapters(i, ptrees[i])
    comps, n = _drive(tight, preqs, 3, ("t0", "t1"))
    assert n > 0 and tight.stats.snapshot_drops == n
    assert tight.stats.restores == 0 and tight.stats.replays == n
    _matches_one_shot(comps, ref)


@pytest.mark.parametrize("fam", RECURRENT)
def test_preempt_replay_parity_on_the_dense_cache(fam):
    """test_preemption_property.py::test_preempt_replay_parity_property on
    both packages: the dense cache replays a preempted row's prompt and
    prefix (seq_lens keeps its recurrent state exact) and continues with
    the uninterrupted tokens."""
    jreqs, preqs = _requests()
    ref = _one_shot(fam, preqs, 64)
    je, pe = _engines(fam, max_len=64)
    preempted = 0
    for step, victim in ((1, "t0"), (4, "t1"), (7, "t0"), (11, "t1")):
        cj, _ = _drive(je, jreqs, step, (victim,))
        cp, n = _drive(pe, preqs, step, (victim,))
        preempted += n
        _same(cp, cj, len(preqs))
        _matches_one_shot(cp, ref)
    assert preempted > 0 and pe.stats.replays > 0
    assert _counters(pe.stats) == _counters(je.stats)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("fam", RECURRENT)
def test_disaggregated_prefill_matches_one_shot(fam, paged):
    """test_prefill_disagg.py::test_disagg_matches_one_shot_token_for_token:
    the prefill workers' rows spliced into the pool (recurrent rows copied
    into the slot) give the one-shot tokens, and the JAX engine's; the
    decode thread runs no prefill."""
    jreqs, preqs = _requests()
    ref = _one_shot(fam, preqs, 64)
    kw = dict(max_len=64, disagg_prefill=True)
    if paged:
        kw.update(paged_kv=True, kv_page_size=16)
    je, pe = _engines(fam, **kw)
    cj, _ = _drive(je, jreqs)
    cp, _ = _drive(pe, preqs)
    _same(cp, cj, len(preqs))
    _matches_one_shot(cp, ref)
    assert pe.stats.splices >= len(preqs)
    assert pe.stats.decode_stall_seconds == 0.0
    keys = ("splices", "prefills", "restores", "completions", "replays")
    assert _counters(pe.stats, keys) == _counters(je.stats, keys)
    je.shutdown()
    pe.shutdown()


@pytest.mark.parametrize("fam", RECURRENT)
def test_chunked_prefill_matches_one_shot(fam):
    """test_prefill_disagg.py::test_chunked_prefill_parity: prompts of
    40-61 tokens prefilled by two workers in chunks rounded up to the SSD
    scan's chunk (16 -> 32 at the reduced configs), state carried across
    chunk boundaries, give the whole-prompt tokens; the JAX engine's too."""
    jreqs, preqs = _requests(n=4, seed=3, long_prompts=True, n_tenants=1)
    ref = _one_shot(fam, preqs, 96)
    je, pe = _engines(fam, max_len=96, disagg_prefill=True, prefill_chunk=16,
                      prefill_workers=2)
    pcfg = _weights(fam)[1]
    assert pe._prefill_chunk_eff == effective_chunk(pcfg, 16) \
        == je._prefill_chunk_eff == pcfg.ssm.chunk_size
    cj, _ = _drive(je, jreqs)
    cp, _ = _drive(pe, preqs)
    _same(cp, cj, len(preqs))
    _matches_one_shot(cp, ref)
    assert pe.stats.prefill_chunks > pe.stats.splices
    assert pe.stats.prefill_chunks == je.stats.prefill_chunks
    je.shutdown()
    pe.shutdown()


@pytest.mark.parametrize("fam", RECURRENT)
def test_prefix_cache_is_a_no_op_for_recurrent_state(fam):
    """test_prefix_cache.py's recurrent case: GRPO siblings of one prompt
    on the paged engine with its default prefix cache share nothing where
    the cache holds ssm/conv state (no hits, no forks, no index pages), and
    give the private-pages engine's tokens; the JAX engine's counters."""
    jreqs, preqs = _requests(n=2)
    jreqs = [dataclasses.replace(jreqs[0], seed=i) for i in range(4)]
    preqs = [dataclasses.replace(preqs[0], seed=i) for i in range(4)]
    je, pe = _engines(fam, max_len=64, paged_kv=True, kv_page_size=4)
    _, priv = _engines(fam, max_len=64, paged_kv=True, kv_page_size=4,
                       prefix_cache=False)
    cj, _ = _drive(je, jreqs)
    cp, _ = _drive(pe, preqs)
    cq, _ = _drive(priv, preqs)
    _same(cp, cj, 4)
    _same(cp, cq, 4)
    assert not pe._radix_on()
    assert pe.stats.prefix_hits == pe.stats.cow_forks == 0
    assert pe._prefix_idx.held_pages == 0
    assert _counters(pe.stats) == _counters(je.stats)


def test_moe_through_the_round_fused_and_continuous_engines():
    """Reduced deepseek-moe at capacity_factor 8 (dropless, so that a
    row's tokens do not depend on its batch): the round-fused ``generate``
    and the continuous engine (dense and paged, the prefix cache on) give
    the JAX engines' streams and each other's."""
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = _weights("moe")
    jreqs, preqs = _requests(n=4)
    jref, _ = RolloutEngine(jcfg, jparams, max_len=64, seed=0).generate(
        jreqs, jtrees)
    pref = _one_shot("moe", preqs, 64)
    for a, b in zip(jref, pref):
        assert a["tokens"] == b["tokens"]
        np.testing.assert_allclose(b["gen_logprobs"], a["gen_logprobs"],
                                   atol=LP_TOL)
    for paged in (False, True):
        kw = dict(paged_kv=True, kv_page_size=16) if paged else {}
        je, pe = _engines("moe", max_len=64, **kw)
        cj, _ = _drive(je, jreqs, 3, ("t1",))
        cp, _ = _drive(pe, preqs, 3, ("t1",))
        _same(cp, cj, len(preqs))
        _matches_one_shot(cp, pref)
        assert _counters(pe.stats) == _counters(je.stats)
