"""The port's env-interaction stage against the JAX package's, on the CPU.

``tests/test_env_stage.py``'s scenarios on the attention family
(``tiny_lm()`` granite, weights carried over with ``repro_torch.bridge``,
adapters with b ~ N(0, 0.3^2)). Agentic rows emit CALL deterministically:
both packages' samplers are biased alike at fixed token counters (EOS
remapped), module-wide, as the reference test biases the JAX one.

- Parking and resuming gives the freeze-in-slot tokens (the JAX one-shot
  ``generate``: loss masks equal, logprobs within 1e-5): with the prefill
  workers on the dense cache, with the fused refill, and over the paged
  pool (resumes restoring the pages kept in the pool, or replaying through
  the workers with response-prefill fusion); parks, resumes, splices,
  restores, fused forced tokens and ``tool_wait_slot_steps`` (0) equal the
  JAX engine's in the same mode. The frozen baseline books slot dead weight
  where the env stage books none.
- Preemption at any turn (hypothesis, derandomised), the turn budget,
  budget-exempt forced tokens and stateful sessions under preemption.
- ``EnvStage`` itself, each scenario written once and run on both
  packages' classes (as ``tests/test_torch_core.py`` does): the per-tenant
  cap, ``halt`` cancelling the backlog, typed retries, the resume-first pop
  order; and the engine's tool-call lifecycle: cancelled futures, late
  responses that never reach a row, one completion a timed-out row, a tool
  error that strands no sibling.
- Pipeline accounting with parked rows, the recorder's env intervals and
  ``summarize``, ``tests/test_prefix_cache.py``'s device-resident parking
  and response-prefill fusion (fused refill and workers), and
  ``MARLaaSRuntime`` with all three stages against the JAX runtime."""
import dataclasses
import random
import threading
import time
from types import SimpleNamespace

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

import repro.rollout.engine as j_eng_mod
import repro.rollout.prefill as j_pf_mod
import repro_torch.rollout.engine as p_eng_mod
import repro_torch.rollout.prefill as p_pf_mod
from conftest import tiny_lm
from repro.core import metrics as j_met
from repro.core.manager import MultiTaskManager as JManager
from repro.core.manager import TaskSpec as JSpec
from repro.core.runtime import MARLaaSRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.data import tokenizer as tok
from repro.envs import base as j_base
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout import env_stage as j_env
from repro.rollout import scheduler as j_sched
from repro.rollout.engine import (ContinuousRolloutEngine, RolloutEngine,
                                  RolloutRequest)
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core import metrics as p_met
from repro_torch.core.manager import MultiTaskManager as PManager
from repro_torch.core.manager import TaskSpec
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.envs import base as p_base
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.rollout import env_stage as p_env
from repro_torch.rollout import scheduler as p_sched
from repro_torch.rollout.engine import (
    ContinuousRolloutEngine as PtContinuous, RolloutRequest as PtRequest)

CALL_AT = (2, 9)          # sampled-token counters that emit CALL
LP_TOL = 1e-5             # the reference tests' logprob tolerance
REF = SimpleNamespace(env=j_env, base=j_base, sched=j_sched, met=j_met,
                      Manager=JManager)
PORT = SimpleNamespace(env=p_env, base=p_base, sched=p_sched, met=p_met,
                       Manager=PManager)
PKGS = {"jax": REF, "port": PORT}


@pytest.fixture(scope="module", autouse=True)
def _biased_sampling():
    """Every engine's sampler, in both packages, returns CALL at the
    CALL_AT counters and never EOS (remapped, so that rows run their full
    budget); undone after the module."""
    mp = pytest.MonkeyPatch()
    j_orig, p_orig = j_pf_mod._sample_rows, p_pf_mod._sample_rows

    def j_biased(logits, keys, counters, temps):
        s = j_orig(logits, keys, counters, temps)
        s = jnp.where(s == tok.EOS, 10, s)
        hit = jnp.zeros(counters.shape, bool)
        for c in CALL_AT:
            hit = hit | (counters == c)
        return jnp.where(hit, tok.CALL, s)

    def p_biased(logits, keys, counters, temps):
        s = p_orig(logits, keys, counters, temps)
        s = torch.where(s == tok.EOS, 10, s)
        hit = torch.zeros(counters.shape, dtype=torch.bool,
                          device=counters.device)
        for c in CALL_AT:
            hit = hit | (counters == c)
        return torch.where(hit, tok.CALL, s)

    for mod in (j_pf_mod, j_eng_mod):
        mp.setattr(mod, "_sample_rows", j_biased)
    for mod in (p_pf_mod, p_eng_mod):
        mp.setattr(mod, "_sample_rows", p_biased)
    yield
    mp.undo()


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


def _requests(n=6, seed=7, max_new=6, latency=0.0, envs=None, seed0=0):
    """``_requests``: rows alternating a multi-turn agentic env (hopsearch,
    kb 8, 2 hops) and gsm8k, explicit seeds; the same for both packages."""
    out = []
    for mk, Req in ((make_env, RolloutRequest), (pt_make_env, PtRequest)):
        if envs is None:
            agentic = mk("hopsearch", kb_size=8, hops=2, seed=0)
            agentic.env_latency_mean, agentic.env_latency_std = latency, 0.0
            pick = [agentic, mk("gsm8k")]
        else:
            pick = [mk(*envs[0]), mk(*envs[1])]
            for e in pick:
                e.env_latency_mean = latency
        rng = random.Random(seed)
        reqs = []
        for i in range(n):
            env = pick[i % 2]
            prompt, truth = env.sample_prompt(rng)
            reqs.append(Req(f"t{i % 2}", i % 2, list(prompt), truth, env,
                            max_new_tokens=max_new, seed=seed0 + i))
        out.append(reqs)
    assert [r.prompt for r in out[0]] == [r.prompt for r in out[1]]
    return out


_REFS = {}


def _oneshot(weights, jreqs, key):
    """The freeze-in-slot oracle: the JAX one-shot ``generate``."""
    if key not in _REFS:
        jcfg, _, jparams, jtrees, _, _ = weights
        _REFS[key], _ = RolloutEngine(jcfg, jparams, max_len=96,
                                      seed=0).generate(jreqs, jtrees)
    return _REFS[key]


def _engine(weights, pkg="port", **kw):
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    kw = dict(dict(max_slots=2, max_adapters=2, max_len=96, seed=0), **kw)
    if pkg == "port":
        eng = PtContinuous(pcfg, pparams, device="cpu", **kw)
        trees = ptrees
    else:
        eng = ContinuousRolloutEngine(jcfg, jparams, **kw)
        trees = jtrees
    for i in range(min(kw["max_adapters"], 2)):
        eng.set_adapters(i, trees[i])
    return eng


def _drive(eng, reqs, preempt_step=0, victims=(), deadline_s=120.0):
    """``test_env_stage.py::_drive``: pump to completion, preempting
    `victims` after `preempt_step` productive steps; page invariants after
    every step of a paged engine."""
    pos_of = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, preempted, iters = {}, 0, 0
    deadline = time.monotonic() + deadline_s
    while not eng.idle() and time.monotonic() < deadline:
        progressed = eng.step()
        if eng.paged_kv:
            eng.check_page_invariants()
        if progressed:
            iters += 1
            if iters == preempt_step:
                for v in victims:
                    preempted += eng.preempt_tenant(v)
        for c in eng.drain_completions():
            assert pos_of[c.submit_index] not in comps
            comps[pos_of[c.submit_index]] = c
        if not progressed:
            time.sleep(0.0005)
    assert len(comps) == len(reqs), f"drained {len(comps)}/{len(reqs)}"
    return comps, preempted


def _matches(comps, ref, ctx=""):
    for i, r in enumerate(ref):
        c = comps[i]
        assert list(c.tokens) == r["tokens"], f"{ctx}: tokens of row {i}"
        assert list(c.gen_loss_mask) == r["gen_loss_mask"], ctx
        np.testing.assert_allclose(c.gen_logprobs, r["gen_logprobs"],
                                   atol=LP_TOL)


def _forced_resp(c):
    gen = list(c.tokens)[c.prompt_len:]
    return sum(1 for j, t in enumerate(gen)
               if t == tok.RESP and c.gen_loss_mask[j] == 0.0)


_ENV_COUNTS = ("parks", "resumes", "splices", "restores",
               "device_resident_resumes", "fused_forced_tokens", "replays",
               "snapshots", "tool_wait_slot_steps", "prefill_tokens",
               "tokens_generated", "sampled_tokens", "completions")
PAGED = dict(paged_kv=True, kv_page_size=16)
MODES = {"disagg": dict(disagg_prefill=True),
         "fused": dict(),
         "paged_disagg": dict(PAGED, disagg_prefill=True),
         "paged_disagg_replay": dict(PAGED, disagg_prefill=True,
                                     resume_restore=False)}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_env_stage_matches_frozen_baseline_token_for_token(weights, mode):
    """``test_env_stage_matches_frozen_baseline_token_for_token`` (attention)
    and ``test_env_stage_parity_fused_fill_path``: parked rows resume with
    the frozen path's tokens, through the workers or the fused refill, on
    the dense cache and the paged pool; every agentic row runs two tool
    turns (two forced RESP openers); the counters equal the JAX engine's
    in the same mode, and no tool-waiting row ever held a slot."""
    jreqs, preqs = _requests()
    ref = _oneshot(weights, jreqs, "main")
    kw = dict(env_stage=True, **MODES[mode])
    je, pe = _engine(weights, "jax", **kw), _engine(weights, **kw)
    cj, _ = _drive(je, jreqs)
    cp, _ = _drive(pe, preqs)
    _matches(cj, ref, f"jax {mode}")
    _matches(cp, ref, f"port {mode}")
    counts = {k: (getattr(je.stats, k), getattr(pe.stats, k))
              for k in _ENV_COUNTS}
    assert all(a == b for a, b in counts.values()), counts
    st_ = pe.stats
    assert st_.parks == st_.resumes == 6 and st_.tool_wait_slot_steps == 0
    assert all(_forced_resp(cp[i]) == 2 for i in range(0, len(preqs), 2))
    if mode == "paged_disagg":          # resumes re-attach pool pages
        assert st_.device_resident_resumes == st_.resumes
        assert st_.snapshots == 0 and st_.replays == 0
    if mode == "paged_disagg_replay":   # resumes replay, fused if they fit
        assert st_.fused_forced_tokens > 0 and st_.restores == 0
    if pe.paged_kv:
        assert pe._pages.used_pages == pe._prefix_idx.held_pages
    assert pe.env_depths() == (0, 0) and pe.idle()
    je.shutdown()
    pe.shutdown()
    assert pe._env._workers == [] and pe._workers == []


def test_frozen_baseline_unchanged_and_books_dead_weight(weights):
    """``test_frozen_baseline_unchanged_and_books_dead_weight``: with 50 ms
    of env latency the frozen engine's slots sit through decode steps on
    the tool (``tool_wait_slot_steps`` > 0); the env stage's parked rows
    never do, give the same tokens, and book the wait on the agentic
    tenant only."""
    jreqs, preqs = _requests()
    _matches(_drive(_engine(weights), preqs)[0], _oneshot(weights, jreqs,
                                                          "main"), "frozen")
    _, preqs2 = _requests(seed=3, latency=0.05, seed0=100)
    frozen = _engine(weights, scheduler="fifo")
    env = _engine(weights, scheduler="fifo", env_stage=True,
                  disagg_prefill=True)
    cf, _ = _drive(frozen, preqs2)
    ce, _ = _drive(env, preqs2)
    for i in range(len(preqs2)):
        assert list(cf[i].tokens) == list(ce[i].tokens)
    assert frozen.stats.tool_wait_slot_steps > 0
    assert env.stats.tool_wait_slot_steps == 0
    assert env.stats.env_wait_by_task.get("t0", 0.0) > 0.0
    assert "t1" not in env.stats.env_wait_by_task
    frozen.shutdown()
    env.shutdown()


@requires_hypothesis
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_preempt_at_any_turn_replay_parity(weights, paged):
    """``test_preempt_at_any_turn_replay_parity`` (attention): preempting
    tenants at ANY step (hypothesis, derandomised), before, between and
    after tool turns and while rows are parked, gives the frozen path's
    tokens; one engine serves every example."""
    jreqs, preqs = _requests()
    ref = _oneshot(weights, jreqs, "main")
    eng = _engine(weights, env_stage=True, disagg_prefill=True,
                  **(PAGED if paged else {}))
    seen = {"n": 0}

    @given(preempt_step=st.integers(1, 25),
           victims=st.sampled_from([("t0",), ("t1",), ("t0", "t1")]))
    @settings(max_examples=5, deadline=None, derandomize=True)
    def check(preempt_step, victims):
        comps, preempted = _drive(eng, preqs, preempt_step, victims)
        seen["n"] += preempted
        _matches(comps, ref, f"preempt {victims}@{preempt_step}")

    check()
    assert seen["n"] > 0 and eng.stats.tool_wait_slot_steps == 0
    assert eng.stats.replays > 0 or eng.stats.restores > 0
    eng.shutdown()


def test_turn_budget_enforced(weights):
    """``test_turn_budget_enforced``: with ``max_turns=1`` the second CALL
    ends the episode (``turn_limit``) instead of dispatching; the terminating
    CALL is recorded; the frozen path (JAX one-shot) agrees."""
    jreqs, preqs = _requests(n=1, seed=1, max_new=12)
    jreqs[0].max_turns = preqs[0].max_turns = 1
    ref = _oneshot(weights, jreqs, "turns")
    eng = _engine(weights, env_stage=True, disagg_prefill=True)
    c = _drive(eng, preqs)[0][0]
    assert c.finish_reason == ref[0]["finish_reason"] == "turn_limit"
    assert _forced_resp(c) == 1 and list(c.tokens)[-1] == tok.CALL
    assert list(c.tokens) == ref[0]["tokens"]
    eng.shutdown()


def test_forced_tokens_budget_exempt_across_turns(weights):
    """``test_forced_tokens_budget_exempt_across_turns``: an agentic row
    doing two tool turns still samples its full budget, every
    RESP…ENDRESP block carrying loss mask 0."""
    _, preqs = _requests()
    eng = _engine(weights, env_stage=True, disagg_prefill=True)
    comps, _ = _drive(eng, preqs)
    for i in range(0, len(preqs), 2):
        c = comps[i]
        assert c.finish_reason == "budget"
        assert c.sampled_tokens == preqs[i].max_new_tokens
        assert c.forced_tokens > 0
        toks = list(c.tokens)[c.prompt_len:]
        ends = sum(1 for j, t in enumerate(toks)
                   if t == tok.ENDRESP and c.gen_loss_mask[j] == 0.0)
        assert _forced_resp(c) == ends == 2
        assert sum(1 for m in c.gen_loss_mask if m == 1.0) \
            == preqs[i].max_new_tokens
    eng.shutdown()


def test_stateful_sessions_survive_preemption(weights):
    """``test_stateful_sessions_survive_preemption``: the REPL accumulator
    session lives on the row, so a preempted and replayed episode keeps
    its register (responses in the prefix never re-run): the frozen
    tokens, both tool turns ran."""
    out = []
    for mk, Req in ((make_env, RolloutRequest), (pt_make_env, PtRequest)):
        env = mk("calcrepl", n_terms=2)
        env.env_latency_mean = 0.0
        rng = random.Random(5)
        reqs = []
        for i in range(4):
            prompt, truth = env.sample_prompt(rng)
            reqs.append(Req("c", 0, list(prompt), truth, env,
                            max_new_tokens=8, seed=50 + i))
        out.append(reqs)
    jreqs, preqs = out
    ref = _oneshot(weights, jreqs, "repl")
    eng = _engine(weights, env_stage=True, disagg_prefill=True)
    comps, preempted = _drive(eng, preqs, preempt_step=4, victims=("c",))
    for i, r in enumerate(ref):
        assert list(comps[i].tokens) == r["tokens"]
        assert _forced_resp(comps[i]) == 2
    eng.shutdown()


# ===========================================================================
# the env stage's machinery, on both packages
# ===========================================================================

def _slow_env(P, latency=0.0, response=(10,), raises=None, query=None,
              calls=None):
    """A minimal agentic env of package P whose tool answers `response`
    (or raises `raises`) after `latency` seconds of env latency, counting
    its calls in `calls["n"]` when given."""
    class SlowEnv(P.base.Env):
        is_agentic = True
        env_latency_mean = latency
        env_latency_std = 0.0

        def sample_prompt(self, rng):
            return [tok.BOS] + tok.encode(query or "s?"), "7"

        def verify(self, truth, completion_ids):
            return 0.0

        def tool_call(self, query_ids, truth=None):
            if calls is not None:
                calls["n"] += 1
            if raises is not None:
                raise raises
            return list(response)
    return SlowEnv()


def _scenario_inflight_cap(P):
    """``test_env_worker_pool_per_tenant_inflight_cap``: with a cap of one
    call a tenant, tenant a's three calls run one at a time while b's runs
    beside them."""
    peak, cur, lock = {"a": 0, "b": 0}, {"a": 0, "b": 0}, threading.Lock()

    class CountingSession(P.base.ToolSession):
        def __init__(self, env, truth, tid):
            super().__init__(env, truth)
            self.tid = tid

        def call(self, query_ids):
            with lock:
                cur[self.tid] += 1
                peak[self.tid] = max(peak[self.tid], cur[self.tid])
            time.sleep(0.05)
            with lock:
                cur[self.tid] -= 1
            return [10]

    def row(tid):
        return SimpleNamespace(session=CountingSession(_slow_env(P), "x",
                                                       tid))
    stage = P.env.EnvStage(n_workers=3, max_inflight_per_tenant=1)
    try:
        for _ in range(3):
            stage.submit(row("a"), [1], "a", 0.0)
        stage.submit(row("b"), [1], "b", 0.0)
        done, deadline = [], time.monotonic() + 10
        while len(done) < 4 and time.monotonic() < deadline:
            done += stage.drain_resolved()
            time.sleep(0.005)
        return (len(done), peak["a"], peak["b"], stage.count(),
                sorted(j.response[0] for j in done), stage.calls)
    finally:
        stage.halt()


def _scenario_halt(P):
    """``test_halt_cancels_queued_backlog``: halt cancels the queued backlog
    instead of letting the worker drain it, latency sleeps included."""
    row = SimpleNamespace(session=SimpleNamespace(call=lambda q: [10]))
    stage = P.env.EnvStage(n_workers=1)
    jobs = [stage.submit(row, [1], "a", 0.5) for _ in range(10)]
    t0 = time.monotonic()
    stage.halt()
    return (time.monotonic() - t0 < 2.0,
            sum(1 for j in jobs if j.cancelled) >= 8, stage.depths(),
            stage._workers)


def _scenario_retries(P):
    """Typed tool errors (``EnvStage`` retry path): a session failing twice
    with a TransientToolError then answering succeeds after two queue-side
    retries; one raising a PermanentToolError, and one whose transient
    failures outlast the per-call retry budget, resolve with the error."""
    class Flaky:
        def __init__(self, fails, exc):
            self.fails, self.exc = fails, exc

        def call(self, query_ids, cancel=None):
            if self.fails:
                self.fails -= 1
                raise self.exc("flaky")
            return [11]

    def row(fails, exc):
        return SimpleNamespace(session=Flaky(fails, exc), tool_retries=0)
    stage = P.env.EnvStage(n_workers=2, retry_max=3, retry_base_s=0.01,
                           retry_max_s=0.02)
    try:
        jobs = [stage.submit(row(2, P.base.TransientToolError), [1], "a", 0.0),
                stage.submit(row(1, P.base.PermanentToolError), [1], "b", 0.0),
                stage.submit(row(9, P.base.TransientToolError), [1], "c", 0.0)]
        done, deadline = [], time.monotonic() + 10
        while len(done) < 3 and time.monotonic() < deadline:
            done += stage.drain_resolved()
            time.sleep(0.005)
        out = {j.task_id: (j.response, type(j.error).__name__
                           if j.error is not None else None, j.attempts,
                           j.row.tool_retries) for j in jobs}
        return out, stage.retries, stage.count()
    finally:
        stage.halt()


def _scenario_resume_first(P):
    """``test_resume_jobs_pop_before_fresh_rows``: a re-queued resume job
    (forced tokens pre-loaded) pops before a fresh row of the same
    priority."""
    def row(idx, forced):
        return SimpleNamespace(req=SimpleNamespace(task_id="t", priority=0,
                                                   max_new_tokens=8),
                               sampled=0, submit_index=idx,
                               forced_q=[tok.RESP] if forced else [])
    s = P.sched.SlotScheduler(policy="srpt")
    fresh, resume = row(0, False), row(1, True)
    s.push(fresh, 0)
    s.push(resume, 0)
    return [s.pop(0).submit_index, s.pop(0).submit_index]


def _scenario_expire_and_cancel(P):
    """``expire`` times out a queued job outright and flags an executing
    one (its late response is dropped); ``cancel_tenant`` and ``cancel_all``
    return the jobs they cancel."""
    gate = threading.Event()

    class Blocking:
        def call(self, query_ids, cancel=None):
            gate.wait(5)
            return [12]
    stage = P.env.EnvStage(n_workers=1)
    try:
        j1 = stage.submit(SimpleNamespace(session=Blocking()), [1], "a", 0.0)
        deadline = time.monotonic() + 5
        while j1.state != "executing" and time.monotonic() < deadline:
            time.sleep(0.005)
        j2 = stage.submit(SimpleNamespace(session=Blocking()), [1], "b", 0.0)
        j3 = stage.submit(SimpleNamespace(session=Blocking()), [1], "c", 0.0)
        expired = stage.expire(time.monotonic() + 10, 5.0)
        gate.set()
        time.sleep(0.1)
        late = stage.drain_resolved()
        j4 = stage.submit(SimpleNamespace(session=Blocking()), [1], "d", 0.0)
        j5 = stage.submit(SimpleNamespace(session=Blocking()), [1], "e", 0.0)
        tenant = stage.cancel_tenant("e")
        stage.cancel_all()
        return ([j.task_id for j in expired], stage.timeouts, late,
                [j.task_id for j in tenant],
                [j.cancelled for j in (j1, j2, j3, j4, j5)])
    finally:
        stage.halt()


@pytest.mark.parametrize("scenario", [
    _scenario_inflight_cap, _scenario_halt, _scenario_retries,
    _scenario_resume_first, _scenario_expire_and_cancel],
    ids=["inflight_cap", "halt", "retries", "resume_first",
         "expire_and_cancel"])
def test_env_stage_machinery_matches_jax(scenario):
    """Each scenario on both packages' classes: the same outcome, and the
    reference test's assertions on it."""
    got = {name: scenario(P) for name, P in PKGS.items()}
    assert got["port"] == got["jax"], got
    out = got["port"]
    if scenario is _scenario_inflight_cap:
        assert out[:4] == (4, 1, 1, 0)
    elif scenario is _scenario_halt:
        assert out == (True, True, (0, 0), [])
    elif scenario is _scenario_retries:
        res, retries, count = out
        assert res["a"] == ([11], None, 2, 2) and retries == 2 + 3
        assert res["b"][1] == "PermanentToolError"
        assert res["c"][1] == "TransientToolError" and res["c"][2] == 4
        assert count == 0
    elif scenario is _scenario_resume_first:
        assert out == [1, 0]
    else:
        assert out == (["b", "c", "a"], 3, [], ["e"], [True] * 5)


# ===========================================================================
# the engine's tool-call lifecycle (the port's engines)
# ===========================================================================

def test_timed_out_tool_futures_are_cancelled(weights):
    """``test_timed_out_tool_futures_are_cancelled``: with one shared tool
    thread, the queued futures of timed-out calls are cancelled at eviction
    and never run."""
    from concurrent.futures import ThreadPoolExecutor
    calls = {"n": 0}
    env = _slow_env(PORT, 0.5, response=tok.encode("42"), query="q?",
                    calls=calls)
    pool = ThreadPoolExecutor(max_workers=1)
    eng = _engine(weights, max_slots=3, max_adapters=1, tool_executor=pool,
                  tool_timeout_s=0.08)
    reqs = [PtRequest("x", 0, [tok.BOS] + tok.encode("q?"), "42", env,
                      max_new_tokens=6, seed=i) for i in range(3)]
    for r in reqs:
        eng.submit(r)
    comps = eng.drain(deadline_s=30.0)
    assert len(comps) == 3
    assert all(c.finish_reason == "tool_timeout" for c in comps)
    pool.shutdown(wait=True)
    assert calls["n"] <= 1, "cancelled tool futures still ran"
    eng.shutdown()


def test_late_response_never_reaches_next_occupant(weights):
    """``test_late_response_never_reaches_next_occupant``: after a frozen
    row times out and its slot refills, the late response is never fed to
    the next occupant, whose tokens equal its solo run."""
    jcfg, _, jparams, jtrees, _, _ = weights
    j_plain, p_plain = make_env("gsm8k"), pt_make_env("gsm8k")
    pp, pt = p_plain.sample_prompt(random.Random(2))
    jp, jt = j_plain.sample_prompt(random.Random(2))
    slow = _slow_env(PORT, 0.3, response=tok.encode("7777"))
    ref, _ = RolloutEngine(jcfg, jparams, max_len=96, seed=0).generate(
        [RolloutRequest("fast", 0, jp, jt, j_plain, max_new_tokens=24,
                        seed=1)], jtrees)
    eng = _engine(weights, max_slots=1, max_adapters=1, tool_timeout_s=0.06)
    pos = {eng.submit(PtRequest("slow", 0, [tok.BOS] + tok.encode("s?"), "7",
                                slow, max_new_tokens=6, seed=0)): 0,
           eng.submit(PtRequest("fast", 0, list(pp), pt, p_plain,
                                max_new_tokens=24, seed=1)): 1}
    comps = {pos[c.submit_index]: c for c in eng.drain(deadline_s=30.0)}
    assert comps[0].finish_reason == "tool_timeout"
    assert not eng._pending
    time.sleep(0.35)
    eng.step()
    fast = comps[1]
    assert all(m == 1.0 for m in fast.gen_loss_mask)
    assert list(fast.tokens) == ref[0]["tokens"]
    eng.shutdown()


def test_env_stage_timeout_discards_late_response(weights):
    """``test_env_stage_timeout_discards_late_response``: a parked row that
    times out completes with ``tool_timeout`` holding no slot; the worker's
    late result is dropped, never a resume."""
    eng = _engine(weights, max_slots=2, max_adapters=1, tool_timeout_s=0.05,
                  env_stage=True, env_workers=1)
    eng.submit(PtRequest("slow", 0, [tok.BOS] + tok.encode("s?"), "7",
                         _slow_env(PORT, 0.4, response=tok.encode("7777")),
                         max_new_tokens=6, seed=0))
    comps = eng.drain(deadline_s=30.0)
    assert len(comps) == 1 and comps[0].finish_reason == "tool_timeout"
    assert comps[0].slot == -1
    time.sleep(0.45)
    eng.step()
    assert eng.stats.resumes == 0 and eng.idle()
    eng.shutdown()


def test_timeout_then_drain_yields_exactly_one_completion(weights):
    """``test_timeout_then_drain_yields_exactly_one_completion``: a parked
    row whose executing call times out completes once, and the engine is
    idle at once, not after the tool's 1.5 s."""
    eng = _engine(weights, max_slots=2, max_adapters=1, tool_timeout_s=0.05,
                  env_stage=True, env_workers=1)
    p, t = pt_make_env("gsm8k").sample_prompt(random.Random(0))
    eng.submit(PtRequest("w", 0, list(p), t, pt_make_env("gsm8k"),
                         max_new_tokens=3, seed=77))
    assert len(eng.drain(60.0)) == 1
    eng.stats.completions = 0
    eng.submit(PtRequest("st", 0, [tok.BOS] + tok.encode("s?"), "7",
                         _slow_env(PORT, 1.5, response=tok.encode("7")),
                         max_new_tokens=6, seed=0))
    t0 = time.monotonic()
    comps = eng.drain(deadline_s=30.0)
    assert len(comps) == 1 and comps[0].finish_reason == "tool_timeout"
    assert eng.stats.completions == 1
    assert time.monotonic() - t0 < 1.0 and eng.idle()
    eng.shutdown()


def test_tool_error_does_not_strand_sibling_responses(weights):
    """``test_tool_error_does_not_strand_sibling_responses``: a session
    raising a plain error surfaces it on the engine thread after the rest
    of the resolved batch: the row ends with ``tool_error``, its sibling
    resumes and finishes."""
    good = pt_make_env("hopsearch", kb_size=8, hops=1, seed=0)
    good.env_latency_mean = 0.0
    g_prompt, g_truth = good.sample_prompt(random.Random(4))
    reqs = [PtRequest("bad", 0, [tok.BOS] + tok.encode("f?"), "1",
                      _slow_env(PORT, raises=RuntimeError("tool exploded")),
                      max_new_tokens=6, seed=0),
            PtRequest("ok", 0, list(g_prompt), g_truth, good,
                      max_new_tokens=6, seed=1)]
    eng = _engine(weights, max_slots=2, max_adapters=1, env_stage=True,
                  env_workers=2)
    pos = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, raised = {}, 0
    deadline = time.monotonic() + 60
    while len(comps) < 2 and time.monotonic() < deadline:
        try:
            eng.step()
        except RuntimeError as e:
            assert "tool exploded" in str(e)
            raised += 1
        for c in eng.drain_completions():
            comps[pos[c.submit_index]] = c
        time.sleep(0.001)
    assert raised >= 1 and eng.stats.tool_errors == 1
    assert comps[0].finish_reason == "tool_error"
    assert comps[1].finish_reason in ("budget", "turn_limit", "eos")
    assert _forced_resp(comps[1]) >= 1 and eng.idle()
    eng.shutdown()


# ===========================================================================
# accounting and metrics
# ===========================================================================

def test_engine_pipeline_accounting_with_env_stage(weights):
    """``test_engine_pipeline_accounting_with_env_stage``: a parked row keeps
    the engine busy and its tenant active; ``queued``, ``queued_progress``
    and ``env_depths`` see it; ``abort_tenant`` reaches the stage too."""
    out = {}
    for case in ("drain", "abort"):
        eng = _engine(weights, max_slots=1, max_adapters=1, env_stage=True,
                      env_workers=1)
        idx = eng.submit(PtRequest(
            "sl", 0, [tok.BOS] + tok.encode("s?"), "7",
            _slow_env(PORT, 0.2, response=tok.encode("7")),
            max_new_tokens=6, seed=0))
        deadline = time.monotonic() + 30
        while eng.stats.parks == 0 and time.monotonic() < deadline:
            eng.step()
        assert eng.stats.parks == 1 and not eng.idle()
        assert eng.queued() == 1 and "sl" in eng.active_tenants()
        rows, sampled = eng.queued_progress("sl")
        assert rows == 1 and sampled > 0
        assert sum(eng.env_depths()) == 1
        if case == "abort":
            assert eng.abort_tenant("sl") == 1
            comps = eng.drain_completions()
            assert comps[0].finish_reason == "quarantined"
        else:
            comps = eng.drain(30.0)
        assert len(comps) == 1 and comps[0].submit_index == idx
        assert eng.active_tenants() == frozenset()
        assert eng.env_depths() == (0, 0) and eng.idle()
        out[case] = comps[0].finish_reason
        eng.shutdown()
    assert out["drain"] == "budget"


@pytest.mark.parametrize("P", [REF, PORT], ids=["jax", "port"])
def test_metrics_env_intervals_and_summary(P):
    """``test_metrics_env_intervals_and_summary`` on both packages: env
    intervals and samples reach the recorder and ``summarize``; env time is
    not device-busy time."""
    rec = P.met.MetricsRecorder({"rollout": 1})
    rec.record("rollout", "decode", "a", 0.0, 1.0)
    rec.record("rollout", "env", "a", 0.0, 0.4)
    rec.record("rollout", "env", "a", 0.2, 0.6)
    rec.record("rollout", "env", "b", 1.0, 1.5)
    assert rec.env_wait_seconds() == pytest.approx(1.3)
    assert rec.env_wait_by_task() == pytest.approx({"a": 0.8, "b": 0.5})
    assert rec.env_busy_seconds() == pytest.approx(1.1)
    assert rec.busy_device_seconds(pool="rollout") == pytest.approx(1.0)
    rec.record_env_sample(0.0, 2, 1)
    rec.record_env_sample(1.0, 0, 0)
    out = P.met.summarize(P.Manager(), rec)
    assert out["env_wait_s"] == pytest.approx(1.3)
    assert out["env_busy_s"] == pytest.approx(1.1)
    assert out["env_q_mean"] == pytest.approx(2.0)
    assert out["env_exec_max"] == 1.0
    assert out["decode_busy_s"] == pytest.approx(1.0)


# ===========================================================================
# tests/test_prefix_cache.py: device-resident parking, response fusion
# ===========================================================================

def _agentic(n=6):
    """``test_prefix_cache.py::_agentic_reqs``: hopsearch rows (kb 8, 2
    hops, no latency) of two tenants, 10 new tokens."""
    out = []
    for mk, Req in ((make_env, RolloutRequest), (pt_make_env, PtRequest)):
        env = mk("hopsearch", kb_size=8, hops=2, seed=0)
        env.env_latency_mean = 0.0
        rng = random.Random(7)
        reqs = []
        for i in range(n):
            prompt, truth = env.sample_prompt(rng)
            reqs.append(Req(f"t{i % 2}", i % 2, list(prompt), truth, env,
                            max_new_tokens=10, seed=i))
        out.append(reqs)
    return out


@pytest.mark.parametrize("disagg", [False, True])
def test_device_resident_park_zero_host_bytes(weights, disagg):
    """``test_device_resident_park_zero_host_bytes``: with the prefix cache
    a parked or preempted row keeps its pages in the pool (no snapshot, no
    host byte), its resume re-attaches them; the tokens equal the host-
    snapshot run's and the JAX one-shot's; and the counters equal the JAX
    engine's in the same mode."""
    jreqs, preqs = _agentic()
    ref = _oneshot(weights, jreqs, "agentic")
    kw = dict(PAGED, env_stage=True, env_workers=2, disagg_prefill=disagg)
    base = _engine(weights, prefix_cache=False, **kw)
    cb, _ = _drive(base, preqs, preempt_step=6, victims=("t0",))
    assert base.stats.snapshots > 0
    base.shutdown()
    je, pe = _engine(weights, "jax", **kw), _engine(weights, **kw)
    cj, _ = _drive(je, jreqs)
    cp, _ = _drive(pe, preqs)
    for comps, ctx in ((cb, "host snapshots"), (cj, "jax"), (cp, "port")):
        _matches(comps, ref, ctx)
    keys = ("parks", "resumes", "device_resident_resumes", "snapshots",
            "snapshot_drops", "replay_tokens", "splices", "restores")
    assert {k: getattr(pe.stats, k) for k in keys} == \
        {k: getattr(je.stats, k) for k in keys}
    st_ = pe.stats
    assert st_.parks > 0 and st_.device_resident_resumes == st_.resumes > 0
    assert st_.snapshots == st_.snapshot_drops == st_.replay_tokens == 0
    assert pe._snap_store.bytes_used == 0
    je.shutdown()
    pe.shutdown()


@pytest.mark.parametrize("disagg", [False, True])
def test_response_prefill_fusion_parity(weights, disagg):
    """``test_response_prefill_fusion_parity``: ``resume_restore=False``
    sends every resume through a replay prefill, which folds the forced
    RESP…ENDRESP block into that call (fused refill or worker), with the
    tokens and logprobs of the step-wise force-feed (the JAX one-shot), on
    the engines with the prefix cache off and on; the fused tokens equal
    the JAX engine's.

    The JAX engine's fused refill allocates a fused row's pages for its
    unfused length (``_refill_free_slots``), so a forced block that crosses
    a page boundary (every second resume here: 15 + 4 tokens on pages of
    16) loses its K/V to the scratch page, and the row's later logprobs
    move by up to 0.15 while its tokens stay. ROADMAP §3 records this
    fault of the reference; the port allocates the fused length, and this
    test shows both sides."""
    jreqs, preqs = _agentic()
    ref = _oneshot(weights, jreqs, "agentic")
    kw = dict(PAGED, env_stage=True, env_workers=2, disagg_prefill=disagg,
              resume_restore=False)
    fused = {}
    for pc in (False, True):
        eng = _engine(weights, prefix_cache=pc, **kw)
        comps, _ = _drive(eng, preqs)
        _matches(comps, ref, f"fusion prefix_cache={pc}")
        fused[pc] = eng.stats.fused_forced_tokens
        eng.shutdown()
    je = _engine(weights, "jax", **kw)
    cj, _ = _drive(je, jreqs)
    assert [list(cj[i].tokens) for i in cj] == [r["tokens"] for r in ref]
    jax_err = max(np.abs(np.subtract(cj[i].gen_logprobs,
                                     ref[i]["gen_logprobs"])).max()
                  for i in cj)
    if disagg:      # the worker's splice allocates the fused length
        assert jax_err <= LP_TOL
    else:           # the reference's fault, above
        assert jax_err > 1e-3
    assert fused[False] == fused[True] == je.stats.fused_forced_tokens > 0
    je.shutdown()


# ===========================================================================
# the runtime against the JAX runtime
# ===========================================================================

def _runtime_pair(weights, specs, **kw):
    jcfg, pcfg, jparams, jtrees, pparams, ptrees = weights
    jrt = JRuntime(jcfg, jparams, JConfig(policy="marlaas", max_len=64,
                                          seed=3, max_slots=4,
                                          use_kernel=False, **kw))
    prt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy="marlaas", max_len=64, seed=3, max_slots=4, device="cpu",
        **kw))
    for i, s in enumerate(specs):
        jrt.submit_task(JSpec(**s), jtrees[i % 2])
        prt.submit_task(TaskSpec(**s), ptrees[i % 2])
        # prompt streams pinned: the runtimes seed them with the salted
        # str hash
        jrt.datagens[s["task_id"]] = random.Random(100 + i)
        prt.datagens[s["task_id"]] = random.Random(100 + i)
    jrt.run(timeout_s=300.0)
    prt.run(timeout_s=300.0)
    return jrt, prt


def test_runtime_env_stage_matches_jax(weights):
    """``test_runtime_env_stage_end_to_end`` against the JAX runtime, all
    three stages disaggregated (one prefill worker, two env workers,
    ``max_turns=2``): an agentic and a plain tenant reach their target;
    with one tenant the reward histories are the JAX runtime's too. No
    slot froze on a tool; env intervals land on the agentic tenant only;
    the env-depth timeline is sampled; the workers halt with the loop."""
    kw = dict(disagg_prefill=True, prefill_workers=1, env_stage=True,
              env_workers=2, max_turns=2)
    hop = dict(task_id="hop", env_name="hopsearch", group_size=2,
               num_groups=1, max_new_tokens=6, target_steps=2)
    gsm = dict(task_id="gsm", env_name="gsm8k", group_size=2, num_groups=1,
               max_new_tokens=4, target_steps=2)
    jrt, prt = _runtime_pair(weights, [hop], **kw)
    assert prt.mgr.state("hop").reward_history == \
        jrt.mgr.state("hop").reward_history
    assert prt.row_accounting() == jrt.row_accounting()
    assert prt.cengine.stats.parks == jrt.cengine.stats.parks > 0
    jrt, prt = _runtime_pair(weights, [hop, gsm], **kw)
    for rt in (jrt, prt):
        assert all(st.done for st in rt.mgr.tasks.values())
        assert rt.cengine.stats.parks > 0
        assert rt.cengine.stats.tool_wait_slot_steps == 0
        assert rt.cengine.stats.decode_stall_seconds == 0.0
        assert rt.rec.env_wait_by_task().get("hop", 0.0) > 0.0
        assert "gsm" not in rt.rec.env_wait_by_task()
        assert rt.rec.env_samples
    assert prt.row_accounting() == jrt.row_accounting()
    assert {t: st.version for t, st in prt.mgr.task_items()} == \
        {t: st.version for t, st in jrt.mgr.task_items()}
    assert p_met.summarize(prt.mgr, prt.rec)["env_wait_s"] > 0.0
    assert prt.cengine._env._workers == [] and prt.cengine._workers == []
