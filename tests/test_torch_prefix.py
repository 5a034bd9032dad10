"""The port's copy-on-write prefix cache against the JAX package's, on the CPU.

- ``PrefixIndex`` (``repro_torch.rollout.kvcache``) against the reference
  class under a hypothesis sequence of insert, match, match_full, pop_lru and
  invalidate: the same answers, ``held_pages`` and ``refcounts``.
- ``attention_prefill_chunk`` and ``forward_prefill_chunk`` against JAX's on
  three reduced fp32 configs (granite; qwen3's qk-norm; gemma2's softcaps
  and sliding window) at offsets 0, a page multiple and a non-multiple;
  activations and cache entries within 1e-5 (the same fp32 ops, summed in
  another order). A prompt prefilled chunk by chunk gives ``forward_seq``'s
  hidden states and cache within the same tolerance.
- ``ContinuousRolloutEngine(paged_kv=True)`` with its default prefix cache
  against the JAX engine's (``use_kernel=False``), in the scenarios of
  ``tests/test_prefix_cache.py`` that need no env stage: GRPO-group COW
  parity, preemption mid-fork, preemption at any step (hypothesis, few
  examples), radix suffix-prefill parity, and spill under pool pressure
  driven by preemptions; plus ``set_adapters`` invalidation and
  ``abort_tenant`` with device-parked rows. Token streams, loss masks and
  finish reasons equal, logprobs within 1e-5, every ``RolloutStats``
  counter equal (timings excepted), and ``check_page_invariants`` after
  every step of both engines.
- ``MARLaaSRuntime`` with ``paged_kv=True`` and the default prefix cache
  against the JAX runtime under ``tests/test_torch_runtime.py``'s
  deterministic schedules and tolerances, and the admission estimate with
  ``prefix_shared`` against the reference's.
- The schedule ``chip_smoke.py`` phase 11 runs at qwen3-0.6b's full size,
  here on its reduced config: its prefix-hit counts (recorded in ROADMAP),
  streams equal to the private-pages run's, and a too-small pool that
  evicts index entries and spills a parked row."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

try:        # property tests skip without hypothesis; the rest still run
    from hypothesis import given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False
requires_hypothesis = pytest.mark.skipif(not HAVE_HYPOTHESIS,
                                         reason="hypothesis not installed")

from conftest import tiny, tiny_lm
from repro.core.admission import AdmissionConfig as JAdmissionConfig
from repro.core.manager import TaskSpec as JSpec
from repro.core.runtime import (MARLaaSRuntime as JRuntime,
                                RuntimeConfig as JConfig)
from repro.data import tokenizer as tok
from repro.envs.tasks import make_env
from repro.lora.adapters import (batched_ctx as jax_batched_ctx, init_lora,
                                 stack_adapters as jax_stack)
from repro.models import attention as jatt
from repro.models import init_cache as jax_init_cache
from repro.models import init_params
from repro.models.model import forward_prefill_chunk as jax_prefill_chunk
from repro.rollout import kvcache as jkv
from repro.rollout.engine import ContinuousRolloutEngine, RolloutRequest
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core.admission import AdmissionConfig
from repro_torch.core.manager import TaskSpec
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.launch.serve import (make_adapters, make_group_requests,
                                      serve_config)
from repro_torch.lora.adapters import batched_ctx, stack_adapters
from repro_torch.models import attention as patt
from repro_torch.models import (forward_prefill_chunk, forward_seq,
                                init_cache)
from repro_torch.models import init_params as pt_init_params
from repro_torch.rollout import kvcache as pkv
from repro_torch.rollout.engine import (
    ContinuousRolloutEngine as PtContinuous, RolloutRequest as PtRequest)
from test_torch_runtime import (SPECS, _assert_final, _assert_first_step,
                                _assert_later_step, _flat, _pair)

ACT = dict(rtol=1e-5, atol=1e-5)
_TIMINGS = {"decode_seconds", "prefill_seconds", "env_wait_seconds",
            "wall_seconds", "splice_seconds", "splice_wait_seconds",
            "decode_stall_seconds", "env_wait_by_task"}
# 14-token template (``tests/test_prefix_cache.py``): with page_size 8 the
# prompts span >= 2 full pages + a partial tail
TEMPLATE = [5, 9, 4, 11, 7, 3, 8, 2, 6, 10, 12, 5, 9, 4]


# ===========================================================================
# PrefixIndex
# ===========================================================================

def _index_step(idx, op, adapter, tokens, n):
    """One operation on an index; returns what it observably did."""
    if op == "insert":
        full = len(tokens) // idx.page_size
        pages = [100 * adapter + i for i in range(full)]
        tail = 100 * adapter + 50 + len(tokens) if len(tokens) % idx.page_size \
            else None
        out = idx.insert(adapter, tokens, pages, tail_page=tail)
    elif op == "match":
        out = idx.match(adapter, tokens, max_tokens=n or None)
    elif op == "match_full":
        out = idx.match_full(adapter, tokens)
    elif op == "pop_lru":
        out = idx.pop_lru(n)
    else:
        out = idx.invalidate(adapter if n % 2 else None)
    return out, idx.held_pages, idx.refcounts()


@requires_hypothesis
def test_prefix_index_matches_reference_property():
    """Random insert / match / match_full / pop_lru / invalidate sequences
    over two adapters and prompts drawn from a small alphabet (so that
    prefixes collide): both indexes give the same pages, LRU victims,
    ``held_pages`` and refcounts after every operation."""

    @given(ops_=st.lists(st.tuples(
        st.sampled_from(["insert", "insert", "match", "match_full",
                         "pop_lru", "invalidate"]),
        st.integers(0, 1),
        st.lists(st.integers(0, 2), min_size=0, max_size=11),
        st.integers(0, 4)), min_size=1, max_size=40))
    @settings(max_examples=80, deadline=None)
    def check(ops_):
        j, p = jkv.PrefixIndex(page_size=3), pkv.PrefixIndex(page_size=3)
        for op, adapter, tokens, n in ops_:
            a = _index_step(j, op, adapter, tokens, n)
            b = _index_step(p, op, adapter, tokens, n)
            assert a == b, (op, adapter, tokens, n, a, b)

    check()


def test_prefix_index_match_and_tail():
    """``test_prefix_cache.py``'s unit case on the port's index."""
    idx = pkv.PrefixIndex(page_size=4)
    assert sorted(idx.insert(0, list(range(10)), [5, 6], tail_page=7)) == [5, 6, 7]
    assert idx.match_full(0, list(range(10))) == ([5, 6], 7)
    assert idx.match_full(0, list(range(8))) == ([5, 6], None)
    assert idx.match_full(0, list(range(9))) is None
    assert idx.match(0, list(range(9)), max_tokens=8) == [5, 6]
    assert idx.match(1, list(range(10))) == []
    assert idx.insert(0, list(range(10)), [5, 6], tail_page=7) == []
    assert idx.held_pages == 3 and idx.refcounts() == {5: 1, 6: 1, 7: 1}
    assert sorted(idx.invalidate(0)) == [5, 6, 7] and idx.held_pages == 0


# ===========================================================================
# chunked prefill
# ===========================================================================

CONFIGS = ["granite-3-2b", "qwen3-0.6b", "gemma2-27b"]


def _configs(name):
    """(JAX config, port config) of the same reduced fp32 model."""
    if name == "granite-3-2b":
        jcfg = tiny_lm(name)
        pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[name],
                                              dtype="float32"),
                                   vocab_size=tok.VOCAB_SIZE)
    else:
        jcfg = tiny(name)
        pcfg = pt_reduced(PT_REGISTRY[name], dtype="float32")
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(pcfg)
    return jcfg, pcfg


@pytest.fixture(scope="module", params=CONFIGS)
def model(request):
    jcfg, pcfg = _configs(request.param)
    jp = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(5)
    trees = []
    for t in range(2):
        tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(10 + t),
                                                  jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.2).astype(np.float32)
        trees.append(tree)
    return dict(jcfg=jcfg, pcfg=pcfg, jparams=jax.tree.map(jnp.asarray, jp),
                pparams=bridge.params_from_jax(jp, pcfg, "cpu"),
                jstack=jax_stack([jax.tree.map(jnp.asarray, t)
                                  for t in trees]),
                pstack=stack_adapters([bridge.lora_from_jax(t, "cpu")
                                       for t in trees]))


@pytest.mark.parametrize("q_start,window", [(0, 0), (8, 0), (5, 0), (5, 4)])
def test_attention_prefill_chunk(model, q_start, window):
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    rs = np.random.RandomState(3)
    B, Sq = 2, 6
    Sk = q_start + Sq
    q = rs.randn(B, Sq, jcfg.num_heads, jcfg.head_dim).astype(np.float32)
    k = rs.randn(B, Sk, jcfg.num_kv_heads, jcfg.head_dim).astype(np.float32)
    v = rs.randn(B, Sk, jcfg.num_kv_heads, jcfg.head_dim).astype(np.float32)
    want = jatt.attention_prefill_chunk(
        *(jnp.asarray(a) for a in (q, k, v)), jcfg, q_start=q_start,
        window=window)
    got = patt.attention_prefill_chunk(
        *(torch.from_numpy(a) for a in (q, k, v)), pcfg, q_start=q_start,
        window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ACT)


@pytest.mark.parametrize("start", [0, 8, 5])
def test_forward_prefill_chunk_matches_jax(model, start):
    """One chunk of 7 tokens at `start` over a cache whose first `start`
    entries a previous chunk wrote (the same numbers in both packages):
    hidden states and the chunk's cache entries within 1e-5."""
    jcfg, pcfg = model["jcfg"], model["pcfg"]
    rs = np.random.RandomState(4)
    B, C, Smax = 2, 7, 24
    toks = rs.randint(3, jcfg.vocab_size, size=(B, start + C)).astype(np.int32)
    ids = np.array([0, 1], np.int32)
    jl = jax_batched_ctx(model["jstack"], jnp.asarray(ids), jcfg)
    pl = batched_ctx(model["pstack"], torch.from_numpy(ids), pcfg)
    jc = jax_init_cache(jcfg, B, Smax)
    pc = init_cache(pcfg, B, Smax, device="cpu")
    if start:
        _, jc = jax_prefill_chunk(model["jparams"], jnp.asarray(toks[:, :start]),
                                  jcfg, jl, jc, start=0)
        _, pc = forward_prefill_chunk(model["pparams"],
                                      torch.from_numpy(toks[:, :start]), pcfg,
                                      pl, pc, start=0)
    jh, jc = jax_prefill_chunk(model["jparams"], jnp.asarray(toks[:, start:]),
                               jcfg, jl, jc, start=start,
                               seq_lens=jnp.full((B,), C, jnp.int32))
    with torch.inference_mode():
        ph, pc = forward_prefill_chunk(model["pparams"],
                                       torch.from_numpy(toks[:, start:]),
                                       pcfg, pl, pc, start=start,
                                       seq_lens=torch.full((B,), C))
    np.testing.assert_allclose(ph.numpy(), np.asarray(jh), **ACT)
    for key in ("k", "v"):
        np.testing.assert_allclose(pc[key][:, :, :start + C].numpy(),
                                   np.asarray(jc[key][:, :, :start + C]), **ACT)


def test_chunk_by_chunk_prefill_equals_forward_seq(model):
    """A 16-token prompt prefilled in chunks of 5, 3 and 8 (offsets 0, 5 and
    8): each chunk's hidden states and the cache equal ``forward_seq``'s on
    the whole prompt."""
    pcfg = model["pcfg"]
    rs = np.random.RandomState(6)
    B, S = 2, 16
    toks = torch.from_numpy(rs.randint(3, pcfg.vocab_size,
                                       size=(B, S)).astype(np.int32))
    lora = batched_ctx(model["pstack"], torch.tensor([1, 0]), pcfg)
    with torch.inference_mode():
        whole = init_cache(pcfg, B, S, device="cpu")
        h, whole, _ = forward_seq(model["pparams"], toks, pcfg, lora, whole)
        chunked = init_cache(pcfg, B, S, device="cpu")
        for lo, hi in ((0, 5), (5, 8), (8, 16)):
            hc, chunked = forward_prefill_chunk(model["pparams"],
                                                toks[:, lo:hi], pcfg, lora,
                                                chunked, start=lo)
            np.testing.assert_allclose(hc.numpy(), h[:, lo:hi].numpy(), **ACT)
    for key in ("k", "v"):
        np.testing.assert_allclose(chunked[key].numpy(), whole[key].numpy(),
                                   **ACT)


# ===========================================================================
# the engine against the JAX engine
# ===========================================================================

@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, JAX params, JAX trees, port params, port trees):
    tiny_lm() granite, two tenants with b ~ N(0, 0.3^2)."""
    jcfg = tiny_lm("granite-3-2b")
    pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY["granite-3-2b"],
                                          dtype="float32"),
                               vocab_size=tok.VOCAB_SIZE)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(7)
    trees = []
    for t in range(3):
        tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1 + t),
                                                  jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.3).astype(np.float32)
        trees.append(tree)
    return (jcfg, pcfg, jax.tree.map(jnp.asarray, params),
            [jax.tree.map(jnp.asarray, t) for t in trees],
            bridge.params_from_jax(params, pcfg, "cpu"),
            [bridge.lora_from_jax(t, "cpu") for t in trees])


def _engines(weights, n_adapters=1, **kw):
    """The JAX and the port engine, paged, with the default prefix cache
    (``kv_page_size`` 8, ``max_len`` 64 and 3 slots unless given)."""
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    kw = dict(dict(max_slots=3, max_len=64, kv_page_size=8), **kw)
    je = ContinuousRolloutEngine(jcfg, jparams, seed=0, paged_kv=True,
                                 max_adapters=n_adapters, **kw)
    pe = PtContinuous(pcfg, pparams, seed=0, paged_kv=True,
                      max_adapters=n_adapters, device="cpu", **kw)
    assert je.prefix_cache and pe.prefix_cache
    for i in range(n_adapters):
        je.set_adapters(i, jtrees[i])
        pe.set_adapters(i, ptrees[i])
    return je, pe


def _group(n, max_new, seed=7):
    """A GRPO group: n same-prompt rows of tenant t0 (template + gsm8k)."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    pj, tj = jenv.sample_prompt(random.Random(seed))
    pp, tp = penv.sample_prompt(random.Random(seed))
    assert (pj, tj) == (pp, tp)
    jreqs = [RolloutRequest("t0", 0, TEMPLATE + pj, tj, jenv,
                            max_new_tokens=max_new, seed=i) for i in range(n)]
    preqs = [PtRequest("t0", 0, TEMPLATE + pp, tp, penv,
                       max_new_tokens=max_new, seed=i) for i in range(n)]
    return jreqs, preqs


def _distinct(n, max_new, n_tenants=1, seed=3):
    """n rows with different questions behind the template (the radix
    case), tenant i % n_tenants on adapter i % n_tenants."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    rj, rp = random.Random(seed), random.Random(seed)
    jreqs, preqs = [], []
    for i in range(n):
        pj, tj = jenv.sample_prompt(rj)
        pp, tp = penv.sample_prompt(rp)
        t = i % n_tenants
        jreqs.append(RolloutRequest(f"t{t}", t, TEMPLATE + [2 + i] + pj, tj,
                                    jenv, max_new_tokens=max_new, seed=i))
        preqs.append(PtRequest(f"t{t}", t, TEMPLATE + [2 + i] + pp, tp, penv,
                               max_new_tokens=max_new, seed=i))
    return jreqs, preqs


def _drive(eng, reqs, preempt_at=(), victims=("t0",), actions=None,
           max_iters=600):
    """Submit, step to idle (preempting `victims` at the listed steps, or
    calling ``actions[step](eng)``), page invariants after every step;
    completions by request index."""
    pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, it = {}, 0
    while not eng.idle() and it < max_iters:
        eng.step()
        it += 1
        if it in preempt_at:
            for v in victims:
                eng.preempt_tenant(v)
        if actions and it in actions:
            actions[it](eng)
        eng.check_page_invariants()
        for c in eng.drain_completions():
            assert pos_of[c.submit_index] not in comps
            comps[pos_of[c.submit_index]] = c
    assert len(comps) == len(reqs), "engine failed to drain"
    eng.check_page_invariants()
    return comps


def _counters(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in _TIMINGS}


def _same(cj, cp):
    assert sorted(cj) == sorted(cp)
    for i in cj:
        a, b = cj[i], cp[i]
        assert list(a.tokens) == list(b.tokens), i
        assert list(a.gen_loss_mask) == list(b.gen_loss_mask), i
        assert a.finish_reason == b.finish_reason, i
        np.testing.assert_allclose(b.gen_logprobs, a.gen_logprobs, rtol=1e-5,
                                   atol=1e-5)


def _pool_view(eng):
    return (eng._pages.used_pages, eng._pages.free_pages,
            eng._prefix_idx.held_pages, eng._snap_store.bytes_used)


def test_grpo_group_cow_parity(weights):
    """``test_prefix_cache.py::test_grpo_group_cow_parity``: six same-prompt
    rows through three slots: the siblings install over the leader's pages
    (tail included) with no prompt prefill, the first decode write past the
    shared boundary forks the tail, and both engines agree; at idle only the
    index's pages remain."""
    jreqs, preqs = _group(6, 8)
    je, pe = _engines(weights)
    cj, cp = _drive(je, jreqs), _drive(pe, preqs)
    _same(cj, cp)
    assert _counters(pe.stats) == _counters(je.stats)
    st_ = pe.stats
    assert st_.prefix_hits == 5 and st_.cow_forks >= 1
    assert st_.prefix_hit_tokens == 5 * (len(preqs[0].prompt) // 8 * 8)
    assert st_.prefill_tokens * 2 <= sum(len(r.prompt) for r in preqs)
    assert _pool_view(pe) == _pool_view(je)
    assert pe._pages.used_pages == pe._prefix_idx.held_pages > 0
    assert pe.page_stats()["kv_prefix_pages"] == je.page_stats()["kv_prefix_pages"] > 0


def test_grpo_group_preempt_mid_fork(weights):
    """``test_grpo_group_preempt_mid_fork``: five siblings on two slots,
    preempted at steps 3, 9 and 15 while they share pages: the rows park in
    the pool (no host snapshot), resume by re-attaching their pages, and
    both engines agree."""
    jreqs, preqs = _group(5, 10)
    je, pe = _engines(weights, max_slots=2)
    cj = _drive(je, jreqs, preempt_at=(3, 9, 15))
    cp = _drive(pe, preqs, preempt_at=(3, 9, 15))
    _same(cj, cp)
    assert _counters(pe.stats) == _counters(je.stats)
    st_ = pe.stats
    assert st_.prefix_hits >= 1 and st_.cow_forks >= 1
    assert st_.device_resident_resumes > 0 and st_.preemptions > 0
    assert st_.snapshots == st_.snapshot_drops == 0
    assert _pool_view(pe) == _pool_view(je)
    assert pe._snap_store.bytes_used == 0


@requires_hypothesis
def test_grpo_group_preempt_any_step_property(weights):
    """``test_grpo_group_cow_parity_property`` with few examples: the group
    preempted at ANY step (mid-prefill, mid-fork, after divergence) gives
    the JAX engine's tokens and counter deltas, with page conservation after
    every step and the same index at idle. One pair of engines serves every
    example, as the JAX test reuses one."""
    je, pe = _engines(weights, max_slots=2)
    jreqs, preqs = _group(4, 8)

    @given(preempt_step=st.integers(1, 12))
    @settings(max_examples=4, deadline=None, derandomize=True)
    def check(preempt_step):
        before = (_counters(je.stats), _counters(pe.stats))
        cj = _drive(je, jreqs, preempt_at=(preempt_step,))
        cp = _drive(pe, preqs, preempt_at=(preempt_step,))
        _same(cj, cp)
        after = (_counters(je.stats), _counters(pe.stats))
        dj, dp = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
        assert dp == dj
        assert _pool_view(pe) == _pool_view(je)

    check()
    assert pe.stats.prefix_hits > 0 and pe.stats.cow_forks > 0
    assert _counters(pe.stats) == _counters(je.stats)


def test_radix_suffix_prefill_parity(weights):
    """``test_radix_suffix_prefill_parity``: four different questions behind
    one template on two slots: later rows match the template's pages and
    prefill only their suffix (``forward_prefill_chunk`` at the matched
    offset); prefill tokens fall by exactly the matched length."""
    jreqs, preqs = _distinct(4, 6)
    je, pe = _engines(weights, max_slots=2)
    cj, cp = _drive(je, jreqs), _drive(pe, preqs)
    _same(cj, cp)
    assert _counters(pe.stats) == _counters(je.stats)
    st_ = pe.stats
    assert st_.prefix_hits > 0 and st_.prefix_hit_tokens > 0
    assert st_.prefill_tokens == sum(len(r.prompt) for r in preqs) \
        - st_.prefix_hit_tokens
    assert _pool_view(pe) == _pool_view(je)


def _count_calls(eng, name, counts, key):
    """Wrap ``eng._prefix_idx.pop_lru`` or ``eng._spill_dev_parked`` to count
    what it frees."""
    owner = eng._prefix_idx if name == "pop_lru" else eng
    fn = getattr(owner, name)

    def counted(*a):
        out = fn(*a)
        counts[key] = counts.get(key, 0) + (len(out) if name == "pop_lru"
                                            else int(out))
        return out
    setattr(owner, name, counted)


def test_spill_under_pool_pressure(weights):
    """``test_device_parked_spill_under_pool_pressure``, with preemptions
    in place of tool calls: 4 GRPO pairs of two tenants on 3 slots and a
    pool of 11 pages of 8 tokens, both tenants preempted in turn at steps
    3, 5 and 7. Allocation evicts index entries (LRU) and spills a
    device-parked row to a host snapshot; rows the pool cannot grow finish
    with "capacity"; both engines agree on every token, counter, eviction
    and spill, and the pool conserves pages after every step."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    rng = random.Random(3)
    jreqs, preqs = [], []
    for g in range(4):
        pj, tj = jenv.sample_prompt(rng)
        t = g % 2
        for _ in range(2):
            i = len(jreqs)
            jreqs.append(RolloutRequest(f"t{t}", t, TEMPLATE + pj, tj, jenv,
                                        max_new_tokens=12, seed=i))
            preqs.append(PtRequest(f"t{t}", t, TEMPLATE + list(pj), tj, penv,
                                   max_new_tokens=12, seed=i))
    je, pe = _engines(weights, n_adapters=2, kv_pool_pages=11)
    counts = {}
    for tag, eng in (("jax", je), ("port", pe)):
        _count_calls(eng, "pop_lru", counts, (tag, "evicted"))
        _count_calls(eng, "_spill_dev_parked", counts, (tag, "spilled"))
    acts = {3: lambda e: e.preempt_tenant("t0"),
            5: lambda e: e.preempt_tenant("t1"),
            7: lambda e: e.preempt_tenant("t0")}
    cj, cp = _drive(je, jreqs, actions=acts), _drive(pe, preqs, actions=acts)
    _same(cj, cp)
    assert _counters(pe.stats) == _counters(je.stats)
    assert counts[("port", "evicted")] == counts[("jax", "evicted")] > 0
    assert counts[("port", "spilled")] == counts[("jax", "spilled")] > 0
    st_ = pe.stats
    assert st_.snapshots > 0 and st_.pool_exhausted > 0
    assert "capacity" in {c.finish_reason for c in cp.values()}
    assert pe._pages.used_pages == pe._prefix_idx.held_pages
    assert _pool_view(pe) == _pool_view(je)


def test_set_adapters_invalidates_the_index(weights):
    """Rewriting an adapter slot drops that slot's index entries (their K/V
    was computed under the old weights) and returns their pages; the other
    slot's entries stay. The same requests then run under the new adapter
    with no stale hit, as in the JAX engine."""
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    jreqs, preqs = _distinct(4, 4, n_tenants=2)
    je, pe = _engines(weights, n_adapters=2)
    _same(_drive(je, jreqs), _drive(pe, preqs))
    held = pe._prefix_idx.refcounts()
    assert held and pe._prefix_idx.held_pages == je._prefix_idx.held_pages
    slot1 = pe._prefix_idx.match(1, preqs[1].prompt)
    assert slot1 and pe._prefix_idx.match(0, preqs[0].prompt)
    je.set_adapters(0, jtrees[2])
    pe.set_adapters(0, ptrees[2])
    pe.check_page_invariants()
    assert _pool_view(pe) == _pool_view(je)
    assert pe._prefix_idx.match(0, preqs[0].prompt) == []
    assert pe._prefix_idx.match(1, preqs[1].prompt) == slot1
    kept = pe._prefix_idx.refcounts()
    assert set(slot1) <= set(kept) and len(kept) < len(held)
    assert all(held[p] == n for p, n in kept.items())
    assert pe._pages.used_pages == pe._prefix_idx.held_pages == len(kept)
    before = pe.stats.prefix_hits
    _same(_drive(je, jreqs), _drive(pe, preqs))
    assert _counters(pe.stats) == _counters(je.stats)
    assert pe.stats.prefix_hits > before
    assert _pool_view(pe) == _pool_view(je)


def test_abort_tenant_with_device_parked_rows(weights):
    """t1's rows are preempted (they park in the pool), t0's higher-priority
    rows take their slots, then t1 is aborted while parked and queued: each
    of its rows yields one "quarantined" completion, its parked pages return
    to the pool, and t0's rows finish as in the JAX engine. At idle the
    pool holds the index's pages alone."""
    jreqs, preqs = _distinct(6, 8, n_tenants=2)
    for r in jreqs + preqs:
        r.priority = 1 if r.task_id == "t0" else 0
    jreqs = jreqs[1::2] + jreqs[0::2]          # t1's rows first
    preqs = preqs[1::2] + preqs[0::2]
    je, pe = _engines(weights, n_adapters=2)
    half, seen = len(jreqs) // 2, {}

    def run(eng, reqs):
        """t1's rows first; after step 2 t0's arrive and t1 is preempted,
        after step 3 t1 is aborted."""
        pos = {eng.submit(r): i for i, r in enumerate(reqs[:half])}
        comps, it = {}, 0
        while not eng.idle() and it < 400:
            eng.step()
            it += 1
            if it == 2:
                for i, r in enumerate(reqs[half:]):
                    pos[eng.submit(r)] = half + i
                eng.preempt_tenant("t1")
                seen[("parked", eng is pe)] = len(eng._dev_parked)
            if it == 3:
                seen[("aborted", eng is pe)] = eng.abort_tenant("t1")
            eng.check_page_invariants()
            for c in eng.drain_completions():
                comps[pos[c.submit_index]] = c
        eng.check_page_invariants()
        return comps

    cj, cp = run(je, jreqs), run(pe, preqs)
    _same(cj, cp)
    assert _counters(pe.stats) == _counters(je.stats)
    assert seen[("parked", True)] == seen[("parked", False)] > 0
    assert seen[("aborted", True)] == seen[("aborted", False)] == half
    assert [cp[i].finish_reason for i in range(half)] == ["quarantined"] * half
    assert pe._dev_parked == [] and pe.stats.device_resident_resumes == 0
    assert pe._pages.used_pages == pe._prefix_idx.held_pages
    assert _pool_view(pe) == _pool_view(je)


# ===========================================================================
# the runtime against the JAX runtime
# ===========================================================================

@pytest.fixture(scope="module")
def rt_weights():
    """``tests/test_torch_runtime.py``'s weights: (JAX cfg, port cfg, JAX
    params, port params, numpy adapter trees)."""
    jcfg = tiny_lm("granite-3-2b")
    pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY["granite-3-2b"],
                                          dtype="float32"),
                               vocab_size=tok.VOCAB_SIZE)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    rs = np.random.RandomState(7)
    trees = []
    for t in range(2):
        tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1 + t),
                                                  jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.3).astype(np.float32)
        trees.append(tree)
    return (jcfg, pcfg, jax.tree.map(jnp.asarray, params),
            bridge.params_from_jax(params, pcfg, "cpu"), trees)


@pytest.mark.parametrize("kw", [
    dict(), dict(async_train=True, max_staleness=0)], ids=["sync", "async0"])
def test_runtime_paged_prefix_cache_matches_jax(rt_weights, kw):
    """``test_deterministic_runs_match_jax``'s ``marlaas`` schedule with one
    tenant over the paged pool with the default prefix cache (pages of 4
    tokens, so that the short gsm8k prompts fill whole pages and the GRPO
    pair shares them): the same versions, reward histories, row account,
    counters and updates as the JAX runtime, and the same prefix hits."""
    jrt, prt, jcommits, pcommits = _pair(rt_weights, "marlaas", 1,
                                         paged_kv=True, kv_page_size=4, **kw)
    assert prt.cengine.prefix_cache and jrt.cengine.prefix_cache
    assert prt.acfg.prefix_shared and jrt.acfg.prefix_shared
    assert prt.mgr.all_done() and jrt.mgr.all_done()
    for tid, jst in jrt.mgr.task_items():
        pst = prt.mgr.state(tid)
        assert (pst.version, pst.steps_done) == (jst.version, jst.steps_done) \
            == (2, 2)
        assert pst.reward_history == jst.reward_history
        pc, jc = pcommits[tid], jcommits[tid]
        assert len(pc) == len(jc) == 2
        _assert_first_step(pc[0][1], jc[0][1], jc[0][2])
        _assert_later_step(pc[1], jc[1], 2)
        init = rt_weights[4][[s["task_id"] for s in SPECS].index(tid)]
        _assert_final(pst, jst, pc, _flat(init))
    assert prt.row_accounting() == jrt.row_accounting()
    assert prt.rec.counters_snapshot() == jrt.rec.counters_snapshot()
    assert prt.mgr.drop_counters() == jrt.mgr.drop_counters()
    pst_, jst_ = prt.cengine.stats, jrt.cengine.stats
    assert (pst_.prefix_hits, pst_.prefix_hit_tokens, pst_.cow_forks) == \
        (jst_.prefix_hits, jst_.prefix_hit_tokens, jst_.cow_forks)
    assert pst_.prefix_hits > 0
    assert prt.cengine._pages.used_pages == prt.cengine._prefix_idx.held_pages


def test_admission_estimate_with_prefix_sharing_matches_jax(rt_weights):
    """With ``paged_kv`` and the default prefix cache both runtimes charge a
    GRPO group's full prompt pages once (``prefix_shared``): the same
    admission config and the same bytes admitted for each tenant, below the
    private-pages charge."""
    jcfg, pcfg, jparams, pparams, _ = rt_weights
    acfg = dict(memory_budget_bytes=1e9, strict=False)
    jrt = JRuntime(jcfg, jparams, JConfig(paged_kv=True, kv_page_size=4,
                                          max_len=48, use_kernel=False),
                   JAdmissionConfig(**acfg))
    prt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        paged_kv=True, kv_page_size=4, max_len=48, device="cpu"),
        AdmissionConfig(**acfg))
    assert dataclasses.asdict(prt.acfg) == dataclasses.asdict(jrt.acfg)
    assert prt.acfg.prefix_shared and prt.acfg.paged
    private = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        paged_kv=True, prefix_cache=False, kv_page_size=4, max_len=48,
        device="cpu"), AdmissionConfig(**acfg))
    for s in SPECS:
        spec = dict(s, group_size=4, num_groups=2, max_new_tokens=12)
        for rt, Spec in ((jrt, JSpec), (prt, TaskSpec), (private, TaskSpec)):
            assert rt.admission.try_admit(Spec(**spec), 20, 9.0)
        got = prt.admission.admitted_bytes(s["task_id"])
        assert got == jrt.admission.admitted_bytes(s["task_id"]) > 0
        assert got < private.admission.admitted_bytes(s["task_id"])


# ===========================================================================
# chip_smoke.py phase 11's schedule, on the reduced config
# ===========================================================================

PHASE11 = dict(tenants=4, prompts=2, group=4, header=128, max_new=64,
               slots=16, page=16, max_len=512, preempt_at=4, small_pool=48)


def expected_prefix_hits(reqs, page):
    """The prefix hits and hit tokens of phase 11's schedule, from the
    prompts alone: the first row of each tenant's first group prefills
    privately; every other row of a group shares all of its leader's pages
    (a match on the whole prompt: the full pages, plus the tail, which is
    recomputed when the prompt is page-aligned); the leader of a later group
    shares the full pages its prompt has in common with the tenant's earlier
    prompts (at least one token left to prefill). ``chip_smoke.py`` computes
    the same."""
    hits = tokens = 0
    seen = []
    for r in reqs:
        L = len(r.prompt)
        if (r.adapter_index, r.prompt) in seen:
            hits += 1
            tokens += L // page * page if L % page else L - page
            continue
        best = 0
        for a, p in seen:
            if a != r.adapter_index:
                continue
            n = 0
            while (n + 1) * page <= min(L - 1, len(p)) and \
                    p[n * page:(n + 1) * page] == r.prompt[n * page:(n + 1) * page]:
                n += 1
            best = max(best, n)
        if best:
            hits += 1
            tokens += best * page
        seen.append((r.adapter_index, r.prompt))
    return hits, tokens


def _phase11_run(cfg, params, adapters, prefix_cache, pool=0):
    """Phase 11's drive on the CPU: each tenant's first group-of-4 prompt,
    then after decode step 4 the second prompts at priority 1 while
    tenant-1 is preempted; page invariants after every step. Returns the
    completions by submit index, the stats, the evicted index pages and
    the spills."""
    P = PHASE11
    reqs = make_group_requests(P["tenants"], P["prompts"], P["group"],
                               header_len=P["header"],
                               max_new_tokens=P["max_new"], seed=11)
    early = [r for i, r in enumerate(reqs) if (i // P["group"]) % 2 == 0]
    late = [r for r in reqs if r not in early]
    for r in late:
        r.priority = 1
    eng = PtContinuous(cfg, params, max_slots=P["slots"], max_adapters=4,
                       max_len=P["max_len"], paged_kv=True,
                       prefix_cache=prefix_cache, kv_page_size=P["page"],
                       kv_pool_pages=pool, device="cpu")
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    counts = {}
    if prefix_cache:
        _count_calls(eng, "pop_lru", counts, "evicted")
        _count_calls(eng, "_spill_dev_parked", counts, "spilled")
    for r in early:
        eng.submit(r)
    comps, late_in = {}, False
    while not eng.idle():
        eng.step()
        eng.check_page_invariants()
        if not late_in and eng.stats.decode_steps >= P["preempt_at"]:
            for r in late:
                eng.submit(r)
            assert eng.preempt_tenant("tenant-1") > 0
            late_in = True
        for c in eng.drain_completions():
            comps[c.submit_index] = c
    assert sorted(comps) == list(range(len(reqs)))
    return comps, eng, counts, early + late


def test_phase11_schedule_counts():
    """On qwen3-0.6b's reduced config, phase 11's schedule: the prefix hits
    and hit tokens that ``expected_prefix_hits`` gives (28 and 3584, which
    the card run must reproduce), device-resident resumes and no snapshot,
    prefill tokens at most half the private run's, the same streams as the
    private run, and at idle only the index's pages; then with 48 pages the
    index evicts entries and a parked row spills, and every row finishes."""
    cfg = serve_config("qwen3-0.6b", reduce=True)
    params = pt_init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapters = make_adapters(cfg, 4, seed=0, device="cpu", b_scale=0.3)
    shared, eng, counts, order = _phase11_run(cfg, params, adapters, True)
    hits, tokens = expected_prefix_hits(order, PHASE11["page"])
    assert (hits, tokens) == (28, 3584)
    st_ = eng.stats
    assert (st_.prefix_hits, st_.prefix_hit_tokens) == (hits, tokens)
    assert st_.cow_forks > 0 and st_.device_resident_resumes > 0
    assert st_.snapshots == 0 and counts.get("spilled", 0) == 0
    assert eng._pages.used_pages == eng._prefix_idx.held_pages
    private, peng, _, _ = _phase11_run(cfg, params, adapters, False)
    assert 2 * st_.prefill_tokens <= peng.stats.prefill_tokens
    assert peng.stats.snapshots > 0 and peng._pages.used_pages == 0
    for i in shared:
        assert list(shared[i].tokens) == list(private[i].tokens), i
        np.testing.assert_allclose(shared[i].gen_logprobs,
                                   private[i].gen_logprobs, atol=1e-5)
    _, small, counts, _ = _phase11_run(cfg, params, adapters, True,
                                       pool=PHASE11["small_pool"])
    assert counts["evicted"] > 0 and counts["spilled"] > 0
    assert small._pages.peak_used <= PHASE11["small_pool"]
    assert small._pages.used_pages == small._prefix_idx.held_pages
