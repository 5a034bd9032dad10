"""The port's disaggregated prefill stage against the JAX package's, on the CPU.

``tests/test_prefill_disagg.py``'s scenarios on the attention family
(``tiny_lm()`` granite, weights carried over with ``repro_torch.bridge``,
adapters with b ~ N(0, 0.3^2)), each run on the port's
``ContinuousRolloutEngine(disagg_prefill=True)`` and held against the JAX
package's one-shot ``generate`` (the uninterrupted oracle) and, where a
counter does not depend on thread timing, against the JAX engine in the
same mode:

- disaggregated output equals one-shot output token for token (loss masks
  equal, logprobs within 1e-5, the reference's tolerance) on the dense
  cache and on the paged pool with the prefix cache off and on; splices,
  prefill calls and prefill tokens equal the JAX engine's; decode never
  stalls on a prefill;
- chunked prefill: rows longer than the chunk prefill in 16-token chunks on
  two workers, with ``effective_chunk``'s rounding and the JAX engine's
  chunk count;
- preemption at any step (hypothesis, derandomised, few examples) replays
  the victims through the workers with the uninterrupted tokens, and
  ``tests/test_preemption_property.py``'s property on the fused engine;
- the fused baseline books its refills as decode stall;
- pipeline accounting: rows queued, held by a worker and ready to splice
  are seen by ``queued``/``queue_depths``/``active_tenants``/
  ``queued_progress`` and drained by ``abort_tenant``;
- an adapter install while a worker prefills a row of that slot leaves the
  row's first token that of the old adapter, as in the JAX engine (whose
  write donates nothing) — the port's write is copy-on-write;
- ``MARLaaSRuntime`` with the stage on against the JAX runtime
  (``use_kernel=False``, prompt streams pinned): versions, reward
  histories, updates, row accounts; and the recorder's prefill intervals
  and queue samples."""
import dataclasses
import random
import threading
import time

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

from conftest import tiny_lm
from repro.data import tokenizer as tok
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout.engine import (ContinuousRolloutEngine, RolloutEngine,
                                  RolloutRequest)
from repro.rollout.prefill import effective_chunk as jax_effective_chunk
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core.metrics import summarize
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.rollout.engine import (
    ContinuousRolloutEngine as PtContinuous, RolloutRequest as PtRequest)
from repro_torch.rollout.prefill import effective_chunk
from test_torch_runtime import (SPECS, _assert_final, _assert_first_step,
                                _assert_later_step, _flat, _pair)

LP_TOL = 1e-5       # the reference tests' logprob tolerance
MODES = {"dense": {},
         "paged": dict(paged_kv=True, kv_page_size=8, prefix_cache=False),
         "paged_prefix": dict(paged_kv=True, kv_page_size=8)}
# 14-token template (``tests/test_prefix_cache.py``): with pages of 8 a
# GRPO group's prompts fill whole pages that the prefix cache can share
TEMPLATE = [5, 9, 4, 11, 7, 3, 8, 2, 6, 10, 12, 5, 9, 4]


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, JAX params, JAX trees, port params, port trees)."""
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


def _requests(n=3, seed=7, budget=lambda i: 5 + 2 * i, prompt=None,
              group=1):
    """The same gsm8k requests for both packages (``_family``'s three
    rows): tenant i % 2 on adapter i % 2, explicit seeds; `prompt` maps a
    sampled prompt to the one used; `group` rows share each prompt."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    rj, rp = random.Random(seed), random.Random(seed)
    jreqs, preqs = [], []
    for i in range(n):
        if i % group == 0:
            pj, tj = jenv.sample_prompt(rj)
            pp, tp = penv.sample_prompt(rp)
            assert (pj, tj) == (pp, tp)
            if prompt is not None:
                pj = pp = prompt(i, list(pj))
        t = (i // group) % 2
        kw = dict(max_new_tokens=budget(i), seed=i)
        jreqs.append(RolloutRequest(f"t{t}", t, list(pj), tj, jenv, **kw))
        preqs.append(PtRequest(f"t{t}", t, list(pp), tp, penv, **kw))
    return jreqs, preqs


def _oneshot(weights, jreqs, max_len):
    jcfg, _, jparams, jtrees, _, _ = weights
    ref, _ = RolloutEngine(jcfg, jparams, max_len=max_len, seed=0).generate(
        jreqs, jtrees[:2])
    return ref


def _engines(weights, jax_too=True, **kw):
    """The port engine (and the JAX one) with `kw`, adapters 0 and 1."""
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    kw = dict(dict(max_slots=2, max_adapters=2, max_len=64, seed=0), **kw)
    pe = PtContinuous(pcfg, pparams, device="cpu", **kw)
    je = ContinuousRolloutEngine(jcfg, jparams, **kw) if jax_too else None
    for i in range(2):
        pe.set_adapters(i, ptrees[i])
        if je is not None:
            je.set_adapters(i, jtrees[i])
    return je, pe


def _drive(eng, reqs, preempt_step=0, victim=None, deadline_s=120.0):
    """``test_prefill_disagg.py::_drive``: pump to completion (optionally
    preempting `victim` after `preempt_step` productive steps), page
    invariants after every step of a paged engine; completions by request
    index and the rows preempted."""
    pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, preempted, iters = {}, 0, 0
    deadline = time.monotonic() + deadline_s
    while not eng.idle() and time.monotonic() < deadline:
        progressed = eng.step()
        if eng.paged_kv:
            eng.check_page_invariants()
        if progressed:
            iters += 1
            if iters == preempt_step and victim is not None:
                preempted = eng.preempt_tenant(victim)
        for c in eng.drain_completions():
            assert pos_of[c.submit_index] not in comps
            comps[pos_of[c.submit_index]] = c
        if not progressed:
            time.sleep(0.0005)      # waiting on the prefill workers
    assert len(comps) == len(reqs), f"drained {len(comps)}/{len(reqs)}"
    return comps, preempted


def _matches(comps, ref, ctx=""):
    for i, r in enumerate(ref):
        c = comps[i]
        assert list(c.tokens) == r["tokens"], f"{ctx}: tokens of row {i}"
        assert list(c.gen_loss_mask) == r["gen_loss_mask"], ctx
        np.testing.assert_allclose(c.gen_logprobs, r["gen_logprobs"],
                                   atol=LP_TOL)


_STAGE_COUNTS = ("splices", "prefill_chunks", "prefill_tokens", "prefills",
                 "completions", "tokens_generated", "sampled_tokens",
                 "prefix_hits", "prefix_hit_tokens", "cow_forks")


def _counts(eng, keys=_STAGE_COUNTS):
    return {k: getattr(eng.stats, k) for k in keys}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_disagg_matches_one_shot_token_for_token(weights, mode):
    """``test_disagg_matches_one_shot_token_for_token`` (attention): the
    workers' prefill and the copy-only splice give the one-shot tokens, on
    the dense cache and on the paged pool; the stage's counters equal the
    JAX engine's in the same mode, the decode thread books no stall, and at
    idle a paged engine holds only the prefix index's pages."""
    jreqs, preqs = _requests()
    ref = _oneshot(weights, jreqs, 64)
    je, pe = _engines(weights, disagg_prefill=True, **MODES[mode])
    cj, _ = _drive(je, jreqs)
    cp, _ = _drive(pe, preqs)
    _matches(cj, ref, f"jax {mode}")
    _matches(cp, ref, f"port {mode}")
    assert _counts(pe) == _counts(je)
    assert pe.stats.splices == len(preqs)
    assert pe.stats.decode_stall_seconds == 0.0      # decode ran no prefill
    assert pe.stats.prefill_seconds > 0.0            # the workers did
    assert pe.queue_depths() == (0, 0) and pe._stage_inflight == []
    if pe.paged_kv:
        held = pe._prefix_idx.held_pages if pe.prefix_cache else 0
        assert pe._pages.used_pages == held
    je.shutdown()
    pe.shutdown()
    assert pe._workers == [] and pe.forward_counts["prefill_whole"].n == 3


def test_disagg_grpo_group_shares_pages(weights):
    """The prefix cache beside the workers: a GRPO group of four rows behind
    a page-aligned template. A worker prefills the leader; its siblings stay
    queued (``_try_pop`` leaves the GRPO siblings of rows in the stage to
    the decode thread) and install over its pages. Every row is installed
    once (by a splice or a shared-page install), tokens equal one-shot's,
    and page refcounts stay exact after every step."""
    jreqs, preqs = _requests(n=4, group=4, budget=lambda i: 6,
                             prompt=lambda i, p: TEMPLATE + p)
    ref = _oneshot(weights, jreqs, 64)
    _, pe = _engines(weights, jax_too=False, disagg_prefill=True,
                     **MODES["paged_prefix"])
    cp, _ = _drive(pe, preqs)
    _matches(cp, ref, "group")
    st_ = pe.stats
    assert st_.splices + st_.prefix_hits == len(preqs)
    assert st_.prefix_hits >= 1 and st_.cow_forks >= 1
    assert pe._pages.used_pages == pe._prefix_idx.held_pages > 0
    pe.shutdown()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_chunked_prefill_parity(weights, paged):
    """``test_chunked_prefill_parity`` (attention): 40- to 61-token prompts
    prefilled in 16-token chunks on two workers (round-robin, a chunk a
    job) give the whole-prompt one-shot tokens; the chunk is
    ``effective_chunk``'s, as in the JAX package, and the number of prefill
    calls is the JAX engine's (dense) and the prompts' chunk count."""
    jreqs, preqs = _requests(n=4, seed=3, budget=lambda i: 5,
                             prompt=lambda i, p: (p * 10)[:40 + 7 * i])
    for i, (j, p) in enumerate(zip(jreqs, preqs)):
        j.adapter_index = p.adapter_index = 0
        j.task_id = p.task_id = "t0"
    ref = _oneshot(weights, jreqs, 96)
    kw = dict(max_len=96, disagg_prefill=True, prefill_chunk=16,
              prefill_workers=2)
    if paged:
        kw.update(MODES["paged"])
    je, pe = _engines(weights, jax_too=not paged, **kw)
    assert pe._prefill_chunk_eff == effective_chunk(pe.cfg, 16) \
        == jax_effective_chunk(weights[0], 16) == 16
    assert [effective_chunk(pe.cfg, c) for c in (0, 1, 9, 16, 17)] == \
        [jax_effective_chunk(weights[0], c) for c in (0, 1, 9, 16, 17)] \
        == [0, 8, 16, 16, 24]
    cp, _ = _drive(pe, preqs)
    _matches(cp, ref, "chunked")
    want = sum(-(-len(r.prompt) // 16) for r in preqs)
    assert pe.stats.prefill_chunks == want > pe.stats.splices == len(preqs)
    assert pe.forward_counts["prefill_chunk"].n == want
    if je is not None:
        cj, _ = _drive(je, jreqs)
        _matches(cj, ref, "jax chunked")
        assert _counts(pe) == _counts(je)
        je.shutdown()
    pe.shutdown()


@requires_hypothesis
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_preempt_replay_parity_disagg(weights, paged):
    """``test_preempt_replay_parity_disagg``: preempting a tenant at ANY
    step (hypothesis, derandomised, few examples) replays its rows through
    the workers, which splice them back with their counters: the
    uninterrupted tokens, and never a decode stall. One engine serves every
    example, as the JAX test reuses one."""
    jreqs, preqs = _requests()
    ref = _oneshot(weights, jreqs, 64)
    kw = dict(MODES["paged"], resume_restore=False) if paged else {}
    _, pe = _engines(weights, jax_too=False, disagg_prefill=True, **kw)
    seen = {"n": 0}

    @given(preempt_step=st.integers(1, 14),
           victim=st.sampled_from(["t0", "t1"]))
    @settings(max_examples=5, deadline=None, derandomize=True)
    def check(preempt_step, victim):
        comps, preempted = _drive(pe, preqs, preempt_step, victim)
        seen["n"] += preempted
        _matches(comps, ref, f"preempt {victim}@{preempt_step}")

    check()
    assert seen["n"] > 0 and pe.stats.replays > 0
    assert pe.stats.decode_stall_seconds == 0.0
    pe.shutdown()


@requires_hypothesis
def test_preempt_replay_parity_property_fused(weights):
    """``tests/test_preemption_property.py::test_preempt_replay_parity_property``
    on the attention family, on the port's fused engine: any (step, victim)
    gives the uninterrupted tokens."""
    jreqs, preqs = _requests()
    ref = _oneshot(weights, jreqs, 64)
    _, pe = _engines(weights, jax_too=False)
    seen = {"n": 0}

    @given(preempt_step=st.integers(1, 14),
           victim=st.sampled_from(["t0", "t1"]))
    @settings(max_examples=6, deadline=None, derandomize=True)
    def check(preempt_step, victim):
        comps, preempted = _drive(pe, preqs, preempt_step, victim)
        seen["n"] += preempted
        _matches(comps, ref, f"fused preempt {victim}@{preempt_step}")

    check()
    assert seen["n"] > 0
    assert pe.stats.preemptions > 0 and pe.stats.replays > 0


def test_fused_baseline_books_decode_stall(weights):
    """``test_fused_baseline_books_decode_stall``: the fused refill books its
    time as prefill and as decode stall (not decode); the disaggregated
    engine on the same requests books no stall."""
    _, preqs = _requests()
    _, fused = _engines(weights, jax_too=False)
    res, st_ = fused.run_requests(preqs, [])
    assert all(r is not None for r in res)
    assert st_.decode_stall_seconds > 0.0
    assert st_.prefill_seconds == pytest.approx(st_.decode_stall_seconds)
    assert st_.decode_seconds > 0.0
    _, disagg = _engines(weights, jax_too=False, disagg_prefill=True)
    res2, st2 = disagg.run_requests(preqs, [])
    assert [r["tokens"] for r in res2] == [r["tokens"] for r in res]
    assert st2.decode_stall_seconds == 0.0 and st2.prefill_seconds > 0.0
    fused.shutdown()
    disagg.shutdown()


def test_engine_pipeline_accounting(weights):
    """``test_engine_pipeline_accounting``, and abort in the stage: the
    workers are held inside their first prefill call, so a row sits in
    ``_stage_inflight``; ``queued``/``queue_depths``/``active_tenants``/
    ``queued_progress`` see it, ``abort_tenant`` ends it (the worker's late
    emit is dropped) and every row yields one completion; then the engine
    drains to idle with nothing left in any queue."""
    _, preqs = _requests()
    _, eng = _engines(weights, jax_too=False, disagg_prefill=True)
    eng._ensure_built()
    whole, entered, go = eng._pkernels.whole, threading.Event(), \
        threading.Event()

    def held(*a, **kw):
        entered.set()
        assert go.wait(30)
        return whole(*a, **kw)
    eng._pkernels.whole = held
    idx = {eng.submit(r): i for i, r in enumerate(preqs)}
    assert eng.queued() == len(preqs)
    assert eng.active_tenants() == {"t0", "t1"}
    eng.step()                                  # starts the worker
    assert entered.wait(30)
    q, ready = eng.queue_depths()
    assert (q, ready) == (len(preqs), 0) and len(eng._stage_inflight) == 1
    held_row = eng._stage_inflight[0]
    tid = held_row.req.task_id
    rows, sampled = eng.queued_progress(tid)
    assert rows == sum(r.task_id == tid for r in preqs) and sampled == 0.0
    n = eng.abort_tenant(tid)
    assert n == rows and eng._stage_inflight == []
    go.set()
    comps = {idx[c.submit_index]: c for c in eng.drain(deadline_s=60.0)}
    comps.update({idx[c.submit_index]: c for c in eng.drain_completions()})
    assert sorted(comps) == [0, 1, 2]
    assert {c.finish_reason for c in comps.values()
            if c.task_id == tid} == {"quarantined"}
    assert eng.queued() == 0 and eng.idle()
    assert eng.active_tenants() == frozenset()
    assert eng.queue_depths() == (0, 0) and not eng._ready
    eng.shutdown()


def test_adapter_install_during_worker_prefill(weights):
    """A worker is held inside its prefill call of a row on adapter slot 0
    while the decode thread installs another tree at slot 0. The JAX engine
    writes its buffer without donating it, so the call in flight keeps the
    old adapters; the port writes copy-on-write, with the same effect: the
    row's first token and logprob are those of the old adapter, the rest of
    its tokens the new one's, equal to the JAX engine's."""
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    jreqs, preqs = _requests(n=1, budget=lambda i: 6)
    out = {}
    for tag, (eng, reqs, new_tree) in {
            "jax": (_engines(weights, disagg_prefill=True)[0], jreqs,
                    jtrees[2]),
            "port": (_engines(weights, jax_too=False,
                              disagg_prefill=True)[1], preqs,
                     ptrees[2])}.items():
        eng._ensure_built()
        ker = eng._pkernels
        whole, entered, go = ker.whole, threading.Event(), threading.Event()

        def held(*a, whole=whole, entered=entered, go=go, **kw):
            entered.set()
            assert go.wait(30)
            return whole(*a, **kw)
        ker.whole = held
        before = eng._stacked
        eng.submit(reqs[0])
        deadline = time.monotonic() + 60
        while not entered.is_set() and time.monotonic() < deadline:
            eng.step()
            time.sleep(0.001)
        assert entered.is_set()
        eng.set_adapters(0, new_tree)
        assert eng._stacked is not before      # a new buffer, the old intact
        go.set()
        comps = eng.drain(deadline_s=60.0)
        assert len(comps) == 1
        out[tag] = comps[0]
        eng.shutdown()
    a, b = out["jax"], out["port"]
    assert list(b.tokens) == list(a.tokens)
    np.testing.assert_allclose(b.gen_logprobs, a.gen_logprobs, atol=LP_TOL)
    # the first token came off the old adapter, the next ones off the new:
    # the uninterrupted runs under either tree differ from this one
    ref_old = _oneshot(weights, jreqs, 64)[0]
    assert b.gen_logprobs[0] == pytest.approx(ref_old["gen_logprobs"][0],
                                              abs=LP_TOL)
    assert list(b.tokens) != ref_old["tokens"] or \
        not np.allclose(b.gen_logprobs, ref_old["gen_logprobs"], atol=LP_TOL)


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


def test_runtime_disagg_matches_jax(rt_weights):
    """``test_runtime_disagg_end_to_end`` against the JAX runtime: the
    ``marlaas`` schedule with one tenant and the prefill stage on (two
    workers, 16-token chunks), prompt streams pinned: the same versions,
    reward histories, updates and row account as the JAX runtime; the
    decode thread never stalled on a prefill; the recorder holds the
    workers' prefill intervals, decode intervals and queue-depth samples;
    the workers are halted with the rollout loop."""
    jrt, prt, jcommits, pcommits = _pair(
        rt_weights, "marlaas", 1, disagg_prefill=True, prefill_workers=2,
        prefill_chunk=16)
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
    assert prt.mgr.drop_counters() == jrt.mgr.drop_counters()
    pst_, jst_ = prt.cengine.stats, jrt.cengine.stats
    assert pst_.splices == jst_.splices > 0
    assert pst_.decode_stall_seconds == jst_.decode_stall_seconds == 0.0
    out = summarize(prt.mgr, prt.rec)
    assert out["prefill_busy_s"] > 0.0 and out["decode_busy_s"] > 0.0
    assert "prefill_q_mean" in out
    assert prt.cengine._workers == []
