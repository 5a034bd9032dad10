"""The port's ContinuousRolloutEngine against the JAX package's, on the CPU.

Both engines get the same bridged fp32 weights and randomised-b adapters,
the same requests and seeds, and the same external drive (the same step
count between ``submit``/``preempt`` calls); both run with
``prefix_cache=False``, the private-pages engine (the prefix cache is held
to the JAX engine's in ``tests/test_torch_prefix.py``). Token
streams, loss masks and finish reasons must be equal, logprobs within 1e-5,
and the ``RolloutStats`` counters equal (timings excepted). Each paged
engine's ``check_page_invariants()`` runs after every step.

Scenarios, from the JAX package's tests: continuous equals one-shot
(``test_continuous.py:68``), SRPT keeps a short tenant from starving
(``:101``), forced tool tokens are budget-exempt (``:137``), preemption
replay with ``resume_restore=False`` (``:186``), preemption at any step with
snapshot restore (``test_paged_kv.py:173``, attention), pool exhaustion
(``:340``) and a prompt larger than the pool (``:368``). Each later stage's
switch builds the engine and serves through it: the paged engine's default
prefix cache, the prefill workers, the env stage, the tracer, chaos
injection and the env stage's wedge detection."""
import dataclasses
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny_lm
from repro.data import tokenizer as tok
from repro.envs.base import Env
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout.engine import (ContinuousRolloutEngine, RolloutEngine,
                                  RolloutRequest)
from repro_torch import bridge
from repro_torch.core.chaos import ChaosConfig, ChaosInjector
from repro_torch.obs import Tracer
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.envs.base import Env as PtEnv
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.rollout.engine import (
    ContinuousRolloutEngine as PtContinuous, RolloutEngine as PtEngine,
    RolloutRequest as PtRequest)

_TIMINGS = {"decode_seconds", "prefill_seconds", "env_wait_seconds",
            "wall_seconds", "splice_seconds", "splice_wait_seconds",
            "decode_stall_seconds", "env_wait_by_task"}


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
    for t in range(2):
        tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1 + t),
                                                  jcfg))
        for leaf in tree["layers"].values():
            leaf["b"] = (rs.randn(*leaf["b"].shape) * 0.3).astype(np.float32)
        trees.append(tree)
    return (jcfg, pcfg, jax.tree.map(jnp.asarray, params),
            [jax.tree.map(jnp.asarray, t) for t in trees],
            bridge.params_from_jax(params, pcfg, "cpu"),
            [bridge.lora_from_jax(t, "cpu") for t in trees])


def _requests(n, seed, budget, n_tenants=2, prompt_pad=0, **kw):
    """The same gsm8k requests for both engines (each its own env)."""
    jenv, penv = make_env("gsm8k"), pt_make_env("gsm8k")
    rj, rp = random.Random(seed), random.Random(seed)
    jreqs, preqs = [], []
    for i in range(n):
        pj, tj = jenv.sample_prompt(rj)
        pp, tp = penv.sample_prompt(rp)
        assert (pj, tj) == (pp, tp)
        pj = pj + [5] * (prompt_pad - len(pj))
        args = (f"t{i % n_tenants}", i % n_tenants, pj, tj)
        kws = dict(max_new_tokens=budget(i), seed=i, **kw)
        jreqs.append(RolloutRequest(*args, jenv, **kws))
        preqs.append(PtRequest(*args[:2], list(pj), tp, penv, **kws))
    return jreqs, preqs


def _engines(weights, **kw):
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    je = ContinuousRolloutEngine(jcfg, jparams, seed=0, prefix_cache=False,
                                 **kw)
    pe = PtContinuous(pcfg, pparams, seed=0, prefix_cache=False,
                      device="cpu", **kw)
    for i in range(min(kw.get("max_adapters", 2), 2)):
        je.set_adapters(i, jtrees[i])
        pe.set_adapters(i, ptrees[i])
    return je, pe


def _drive(eng, reqs, preempt_at=(), victims=("t0", "t1"), max_iters=600):
    """Submit, step to idle (preempting `victims` at the listed steps) and
    return the completions by request index; page invariants after every
    step of a paged engine."""
    pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, it = {}, 0
    while not eng.idle() and it < max_iters:
        eng.step()
        it += 1
        if it in preempt_at:
            for v in victims:
                eng.preempt_tenant(v)
        if eng.paged_kv:
            eng.check_page_invariants()
        for c in eng.drain_completions():
            comps[pos_of[c.submit_index]] = c
    assert len(comps) == len(reqs), "engine failed to drain"
    return comps


def _counters(stats):
    return {f.name: getattr(stats, f.name) for f in dataclasses.fields(stats)
            if f.name not in _TIMINGS}


def _same_rows(cj, cp, n):
    for i in range(n):
        a, b = cj[i], cp[i]
        assert list(a.tokens) == list(b.tokens), i
        assert list(a.gen_loss_mask) == list(b.gen_loss_mask), i
        assert a.finish_reason == b.finish_reason, i
        np.testing.assert_allclose(b.gen_logprobs, a.gen_logprobs, rtol=1e-5,
                                   atol=1e-5)


def _no_eos(eng, xp):
    """Remap sampled EOS to a plain char token so row lengths are exactly
    their budgets (``test_continuous.py``'s helper, for either engine; `xp`
    is jnp or torch)."""
    eng._ensure_built()
    step, refill = eng._step_fn, eng._refill_fn

    def wrap_step(*a):
        out = step(*a)
        return (xp.where(out[0] == tok.EOS, 10, out[0]),) + tuple(out[1:])

    def wrap_refill(*a):
        first, lp, cache, state = refill(*a)
        state = (xp.where(state[0] == tok.EOS, 10, state[0]),) \
            + tuple(state[1:])
        return xp.where(first == tok.EOS, 10, first), lp, cache, state

    eng._step_fn, eng._refill_fn = wrap_step, wrap_refill


# ===========================================================================
# scenarios
# ===========================================================================

def test_continuous_matches_jax_and_one_shot(weights):
    """``test_continuous.py:68``: 3 slots, 6 queued mixed-length requests
    across 2 adapters, on the dense and the paged cache: equal to the JAX
    engine's run and to the port's one-shot ``generate``."""
    jcfg, pcfg, _, _, pparams, ptrees = weights
    jreqs, preqs = _requests(6, 0, lambda i: 4 + 3 * (i % 3))
    one, _ = PtEngine(pcfg, pparams, max_len=64, seed=0,
                      device="cpu").generate(preqs, ptrees)
    for paged in (False, True):
        je, pe = _engines(weights, max_slots=3, max_adapters=2, max_len=64,
                          paged_kv=paged, kv_page_size=16)
        cj, cp = _drive(je, jreqs), _drive(pe, preqs)
        _same_rows(cj, cp, 6)
        assert _counters(je.stats) == _counters(pe.stats)
        assert pe.stats.prefills == 6 and pe.stats.refills >= 2
        for i, r in enumerate(one):
            assert list(cp[i].tokens) == r["tokens"]
            np.testing.assert_allclose(cp[i].gen_logprobs, r["gen_logprobs"],
                                       rtol=1e-5, atol=1e-5)
        if paged:
            assert pe._pages.used_pages == 0
            assert pe.page_stats()["kv_pages_peak"] > 0


def test_short_tenant_not_starved(weights):
    """``test_continuous.py:101``: a tenant's long rows queued first cannot
    block another tenant's short rows under SRPT; the same finish order and
    step numbers as the JAX engine (dense), and the same tokens paged."""
    jreqs, preqs = _requests(8, 1, lambda i: 48 if i < 2 else 4)
    for r in jreqs + preqs:      # tenant "long" (adapter 0) then "short"
        long_ = r.max_new_tokens == 48
        r.task_id, r.adapter_index = ("long", 0) if long_ else ("short", 1)
    je, pe = _engines(weights, max_slots=3, max_adapters=2, max_len=96)
    _no_eos(je, jnp)
    _no_eos(pe, torch)
    cj, cp = _drive(je, jreqs), _drive(pe, preqs)
    _same_rows(cj, cp, 8)
    assert _counters(je.stats) == _counters(pe.stats)
    assert [c.finished_step for c in cp.values()] == \
        [c.finished_step for c in cj.values()]
    short = [cp[i].finished_step for i in range(2, 8)]
    assert max(short) < min(cp[0].finished_step, cp[1].finished_step)
    _, pe2 = _engines(weights, max_slots=3, max_adapters=2, max_len=96,
                      paged_kv=True, kv_page_size=16)
    _no_eos(pe2, torch)
    _same_rows(cj, _drive(pe2, preqs), 8)


def test_forced_tool_tokens_do_not_consume_budget(weights):
    """``test_continuous.py:137`` through the continuous engines: the first
    decode step emits CALL, the row freezes in its slot while the tool runs,
    and the 22 force-fed tokens do not count against its budget of 4."""

    def env_of(base):
        class LongToolEnv(base):
            name = "longtool"
            is_agentic = True
            env_latency_mean = 0.0

            def sample_prompt(self, rng):
                return [tok.BOS] + tok.encode("abc?"), "42"

            def verify(self, truth, completion_ids):
                return 0.0

            def tool_call(self, query_ids, truth=None):
                return tok.encode("0123456789" * 2)      # 20 tokens
        return LongToolEnv()

    prompt = [tok.BOS] + tok.encode("abc?")
    out = {}
    for name, paged in (("jax", False), ("port", False), ("port", True)):
        je, pe = _engines(weights, max_slots=2, max_adapters=1, max_len=96,
                          paged_kv=paged, kv_page_size=16, sim_latency=True)
        eng, xp, Req, base = ((je, jnp, RolloutRequest, Env) if name == "jax"
                              else (pe, torch, PtRequest, PtEnv))
        _no_eos(eng, xp)
        step, count = eng._step_fn, {"n": 0}

        def forced_call_step(*a, step=step, count=count, xp=xp):
            nxt, lp, cache, ctr = step(*a)
            count["n"] += 1
            if count["n"] == 1:              # first decode step emits CALL
                nxt = xp.full_like(nxt, tok.CALL)
            return nxt, lp, cache, ctr

        eng._step_fn = forced_call_step
        env = env_of(base)
        eng.submit(Req("lt", 0, list(prompt), "42", env, max_new_tokens=4,
                       seed=0))
        comps = eng.drain(deadline_s=60)
        assert len(comps) == 1
        out[(name, paged)] = (comps[0], eng.stats)
        eng.shutdown()
    for key in (("port", False), ("port", True)):
        _same_rows({0: out[("jax", False)][0]}, {0: out[key][0]}, 1)
    c, st = out[("port", True)]
    mask, toks = c.gen_loss_mask, c.tokens[c.prompt_len:]
    assert tok.RESP in toks and tok.ENDRESP in toks
    assert sum(1 for m in mask if m == 1.0) == 4 == st.sampled_tokens
    end = toks.index(tok.ENDRESP)
    assert all(m == 1.0 for m in mask[end + 1:]) and len(toks) > end + 1
    assert c.forced_tokens == 22 and c.finish_reason == "budget"


@pytest.mark.parametrize("paged", [False, True])
def test_preempt_replay_matches_jax(weights, paged):
    """``test_continuous.py:186``: both tenants preempted mid-run (steps 3
    and 7) and prefix-replayed (``resume_restore=False``): the same tokens
    as the JAX engine, which replays on the dense cache, and the same
    preemption and replay counters."""
    jreqs, preqs = _requests(4, 3, lambda i: 6 + 2 * i)
    je, _ = _engines(weights, max_slots=2, max_adapters=2, max_len=64)
    _, pe = _engines(weights, max_slots=2, max_adapters=2, max_len=64,
                     paged_kv=paged, kv_page_size=16, resume_restore=False)

    def drive(eng, reqs):
        pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
        comps, it, n = {}, 0, 0
        while not eng.idle() and it < 400:
            eng.step()
            it += 1
            if it in (3, 7):
                n += eng.preempt_tenant(f"t{it % 2}")
            if eng.paged_kv:
                eng.check_page_invariants()
            for c in eng.drain_completions():
                comps[pos_of[c.submit_index]] = c
        return comps, n

    (cj, nj), (cp, np_) = drive(je, jreqs), drive(pe, preqs)
    assert nj == np_ > 0
    _same_rows(cj, cp, 4)
    keys = ("preemptions", "replays", "replay_tokens", "prefills", "refills",
            "completions", "tokens_generated", "sampled_tokens",
            "decode_steps", "prefill_tokens", "restores", "snapshots")
    assert {k: getattr(pe.stats, k) for k in keys} == \
        {k: getattr(je.stats, k) for k in keys}
    assert pe.stats.replays == np_ and pe.stats.restores == 0


@pytest.fixture(scope="module")
def restore_engines(weights):
    """One JAX and one port paged engine (2 slots, page 16, snapshot
    restore), reused across the preemption steps below, and the one-shot
    reference of their 3 requests."""
    jreqs, preqs = _requests(3, 7, lambda i: 5 + 2 * i)
    jcfg, _, jparams, jtrees, _, _ = weights
    ref, _ = RolloutEngine(jcfg, jparams, max_len=64, seed=0).generate(
        jreqs, jtrees)
    je, pe = _engines(weights, max_slots=2, max_adapters=2, max_len=64,
                      paged_kv=True, kv_page_size=16)
    return je, pe, jreqs, preqs, ref


@pytest.mark.parametrize("preempt_step,victims", [
    (1, ("t0",)), (3, ("t1",)), (5, ("t0", "t1")), (8, ("t0",)),
    (12, ("t0", "t1"))])
def test_preempt_at_any_step_restores(restore_engines, preempt_step, victims):
    """``test_paged_kv.py:173`` (attention): preempting at a given step
    snapshots the victims' live pages to host and splices them back: tokens
    equal to the JAX engine's and to the uninterrupted one-shot run, the
    same counters, no replay, and at idle no page and no snapshot byte
    held."""
    je, pe, jreqs, preqs, ref = restore_engines
    before = (_counters(je.stats), _counters(pe.stats))
    cj = _drive(je, jreqs, (preempt_step,), victims)
    cp = _drive(pe, preqs, (preempt_step,), victims)
    _same_rows(cj, cp, len(preqs))
    for i, r in enumerate(ref):
        assert list(cp[i].tokens) == r["tokens"]
        np.testing.assert_allclose(cp[i].gen_logprobs, r["gen_logprobs"],
                                   rtol=1e-5, atol=1e-5)
    after = (_counters(je.stats), _counters(pe.stats))
    delta = [{k: a[k] - b[k] for k in a} for a, b in zip(after, before)]
    assert delta[0] == delta[1]
    assert delta[1]["replays"] == 0 and delta[1]["replay_tokens"] == 0
    if delta[1]["preemptions"]:
        assert delta[1]["restores"] == delta[1]["snapshots"] \
            == delta[1]["preemptions"]
        assert delta[1]["replay_tokens_saved"] > 0
    assert pe._pages.used_pages == 0 and pe._snap_store.bytes_used == 0


def test_preemptions_happen_in_the_restore_cases(restore_engines):
    """The parametrised drive above preempted and restored rows at least
    once (runs after it in the file's order)."""
    _, pe, _, _, _ = restore_engines
    assert pe.stats.preemptions > 0 and pe.stats.restores > 0


def test_pool_exhaustion_finishes_rows(weights):
    """``test_paged_kv.py:340``: 3 pages of 8 tokens for 2 slots; growth
    past a page boundary starves the pool, rows finish with "capacity",
    nothing leaks, as in the JAX engine."""
    jreqs, preqs = _requests(6, 3, lambda i: 40, n_tenants=1)
    je, pe = _engines(weights, max_slots=2, max_adapters=1, max_len=64,
                      paged_kv=True, kv_page_size=8, kv_pool_pages=3)
    cj, cp = _drive(je, jreqs), _drive(pe, preqs)
    _same_rows(cj, cp, 6)
    assert _counters(je.stats) == _counters(pe.stats)
    assert pe.stats.pool_exhausted > 0
    assert "capacity" in {c.finish_reason for c in cp.values()}
    assert pe._pages.used_pages == 0
    assert pe.page_stats()["kv_pages_peak"] <= 3


def test_prompt_larger_than_pool_finishes_capacity(weights):
    """``test_paged_kv.py:368``: a 20-token prompt can never fit a pool of
    2 pages of 8 tokens; it finishes with "capacity" instead of
    deadlocking."""
    jreqs, preqs = _requests(1, 3, lambda i: 4, n_tenants=1, prompt_pad=20)
    je, pe = _engines(weights, max_slots=2, max_adapters=1, max_len=64,
                      paged_kv=True, kv_page_size=8, kv_pool_pages=2)
    cj, cp = _drive(je, jreqs), _drive(pe, preqs)
    assert cp[0].finish_reason == cj[0].finish_reason == "capacity"
    assert list(cp[0].tokens) == list(cj[0].tokens)
    assert _counters(je.stats) == _counters(pe.stats)


@pytest.mark.parametrize("flag", [
    dict(disagg_prefill=True), dict(env_stage=True),
    dict(paged_kv=True, prefix_cache=True), dict(tracer=Tracer()),
    dict(chaos=ChaosInjector(ChaosConfig(seed=0, prefill_worker_kill=1.0,
                                         max_faults_per_site=1)),
         disagg_prefill=True),
    dict(supervise_wedge_s=1.0, env_stage=True)])
def test_later_stages_raise(weights, flag):
    """Each later stage's switch builds the engine, which serves through
    it: a GRPO pair over the prefix cache, the sibling sharing the leader's
    pages; two rows spliced from the prefill workers; two rows with the env
    stage registered with the supervisor; two traced rows, each episode
    from ``queued`` to ``completed``; two rows whose first prefill worker
    is killed, the supervisor requeueing its row and restarting it; the
    env stage's wedge check on every supervision tick.
    ``tests/test_torch_disagg.py``, ``tests/test_torch_env_stage.py``,
    ``tests/test_torch_obs.py`` and ``tests/test_torch_faults.py`` hold them
    against the JAX engine."""
    _, pcfg, _, _, pparams, ptrees = weights
    if "tracer" in flag:
        eng = PtContinuous(pcfg, pparams, device="cpu", max_len=32, **flag)
        eng.set_adapters(0, ptrees[0])
        _, preqs = _requests(2, 2, lambda i: 4)
        comps = _drive(eng, preqs)
        tr = flag["tracer"]
        assert sorted(tr.components()) == [0, 1]
        for c in comps.values():
            seq = tr.state_sequence(c.meta["trace_id"])
            assert seq[:3] == ["queued", "prefill", "decode"]
            assert seq[-1] == "completed"
        return
    if "supervise_wedge_s" in flag:
        eng = PtContinuous(pcfg, pparams, device="cpu", max_len=32, **flag)
        eng.set_adapters(0, ptrees[0])
        calls = []
        mark = eng._env.mark_wedged
        eng._env.mark_wedged = lambda s: calls.append(s) or mark(s)
        _, preqs = _requests(2, 2, lambda i: 4)
        comps = _drive(eng, preqs)
        assert sorted(comps) == [0, 1] and calls and set(calls) == {1.0}
        assert eng._env.wedged == 0
        eng.shutdown()
        return
    if "chaos" in flag:
        eng = PtContinuous(pcfg, pparams, device="cpu", max_len=32, **flag)
        eng.set_adapters(0, ptrees[0])
        _, preqs = _requests(2, 2, lambda i: 4)
        pos = {eng.submit(r): i for i, r in enumerate(preqs)}
        comps = {pos[c.submit_index]: c for c in eng.drain(deadline_s=60.0)}
        assert sorted(comps) == [0, 1]
        assert flag["chaos"].counts() == {"prefill_worker_kill": 1}
        sup = eng.supervisor.counters
        assert sup["prefill_worker_restarts"] >= 1
        assert sup["prefill_worker_jobs_recovered"] == 1
        assert eng.stats.splices == 2
        eng.shutdown()
        return
    if flag.get("disagg_prefill") or flag.get("env_stage"):
        eng = PtContinuous(pcfg, pparams, device="cpu", max_len=32, **flag)
        eng.set_adapters(0, ptrees[0])
        _, preqs = _requests(2, 2, lambda i: 4)
        pos = {eng.submit(r): i for i, r in enumerate(preqs)}
        # drain() waits for the workers, where _drive would count idle spins
        comps = {pos[c.submit_index]: c for c in eng.drain(deadline_s=60.0)}
        assert sorted(comps) == [0, 1]
        assert all(len(c.tokens) > c.prompt_len for c in comps.values())
        if flag.get("disagg_prefill"):
            assert eng.stats.splices == 2 and eng.stats.prefill_seconds > 0
            assert eng.stats.decode_stall_seconds == 0.0
        else:
            assert eng._env is not None and eng.env_depths() == (0, 0)
        eng.shutdown()
        return
    if flag.get("prefix_cache"):
        eng = PtContinuous(pcfg, pparams, device="cpu", kv_page_size=4,
                           max_len=32, **flag)
        eng.set_adapters(0, ptrees[0])
        _, preqs = _requests(1, 2, lambda i: 4)
        comps = _drive(eng, preqs * 2)
        assert [len(c.tokens) > c.prompt_len for c in comps.values()] \
            == [True, True]
        assert eng.prefix_cache and eng.stats.prefix_hits == 1
        assert eng._pages.used_pages == eng._prefix_idx.held_pages > 0
        return


def test_paged_engine_defaults_raise_and_dense_default_runs(weights):
    """The JAX default ``prefix_cache=True`` holds with the paged cache, as
    there; the dense engine has no prefix cache; and the default device is
    the card, refused without one."""
    _, pcfg, _, _, pparams, _ = weights
    assert PtContinuous(pcfg, pparams, paged_kv=True, device="cpu").prefix_cache
    assert not PtContinuous(pcfg, pparams, device="cpu").prefix_cache
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PtContinuous(pcfg, pparams)


def test_stacked_adapter_buffer_matches_jax(weights):
    """``init_stacked_buffer`` + the in-place slot write give the JAX
    package's buffer (zeros, then ``.at[:, i].set(tree)``) leaf for leaf."""
    from repro.lora.adapters import init_stacked_buffer as jinit_buf
    from repro_torch.lora.adapters import init_stacked_buffer, write_adapter_slot
    _, _, _, jtrees, _, ptrees = weights
    jbuf = jinit_buf(jtrees[0], 3)
    jbuf = jax.tree.map(lambda b, l: b.at[:, 1].set(l), jbuf, jtrees[1])
    pbuf = init_stacked_buffer(ptrees[0], 3)
    write_adapter_slot(pbuf, ptrees[1], 1)
    jl, pl = jax.tree.leaves(jbuf), []
    for tgt in sorted(pbuf["layers"]):
        pl += [pbuf["layers"][tgt]["a"], pbuf["layers"][tgt]["b"]]
    assert len(jl) == len(pl)
    for a, b in zip(jl, pl):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_preempt_slots_and_introspection_match_jax(weights):
    """``preempt_slots`` (victims by priority, then longest remaining budget,
    protected tenants spared) and the queue introspection the admission
    controller reads agree with the JAX engine mid-run, and the rows then
    finish as the JAX engine's do."""
    jreqs, preqs = _requests(6, 5, lambda i: 6 + 2 * i)
    je, pe = _engines(weights, max_slots=3, max_adapters=2, max_len=64,
                      paged_kv=True, kv_page_size=16)
    pos_j = {je.submit(r): i for i, r in enumerate(jreqs)}
    pos_p = {pe.submit(r): i for i, r in enumerate(preqs)}
    for _ in range(3):
        je.step()
        pe.step()
    assert pe.preempt_slots(2, protect=("t1",)) == \
        je.preempt_slots(2, protect=("t1",)) > 0
    pe.check_page_invariants()
    views = [(eng.occupancy(), eng.queued(), eng.idle(), eng.active_tenants(),
              eng.occupant_tasks(), eng.queued_progress("t0"),
              eng.queued_state_bytes("t0"), eng.queued_state_bytes("t1"))
             for eng in (je, pe)]
    assert views[0] == views[1]
    cj = {pos_j[c.submit_index]: c for c in je.drain()}
    cp = {pos_p[c.submit_index]: c for c in pe.drain()}
    _same_rows(cj, cp, 6)
    assert _counters(je.stats) == _counters(pe.stats)
