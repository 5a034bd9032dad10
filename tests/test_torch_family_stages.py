"""The env stage and the runtime on the ssm (mamba2) and hybrid (zamba2)
families, the port against the JAX package, on the CPU.

``tiny_lm()`` configs of both families, weights carried over with
``repro_torch.bridge``, adapters with b ~ N(0, 0.3^2) in both subtrees.
Agentic rows emit CALL deterministically: both packages' samplers are
biased alike at fixed token counters (EOS remapped), module-wide, as
``tests/test_env_stage.py`` biases the JAX one.

- ``test_env_stage.py::test_env_stage_matches_frozen_baseline_token_for_token``
  and ``::test_preempt_at_any_turn_replay_parity`` (``[ssm]``,
  ``[hybrid]``): parked rows resume with the freeze-in-slot tokens (loss
  masks equal, logprobs within 1e-5), on the dense cache and the paged
  pool. The oracle is the port's one-shot ``generate``. For the hybrid it
  cannot be the JAX one: the JAX hybrid ``decode_step`` advances a frozen
  row's recurrent state (ROADMAP §3), so the JAX freeze-in-slot oracle is
  wrong by as many decode steps as a row spends frozen on its tool, which
  depends on thread timing (the reference's intermittent failures of these
  two tests). The port's frozen rows keep their state, with or without
  tool latency. The parking engines of both packages never freeze a row,
  so the port's streams and counters are also held to the JAX engine's in
  the same mode.
- ``test_async_train.py::test_async_staleness0_bitwise_matches_sync_baseline``
  (``[ssm]``, ``[hybrid]``) on the port's runtime: at max_staleness 0 the
  event-driven trainer gives the round-synchronous run's adapters bit for
  bit; the JAX runtime's versions and reward histories."""
import dataclasses
import random
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

import repro.rollout.engine as j_eng_mod
import repro.rollout.prefill as j_pf_mod
import repro_torch.rollout.engine as p_eng_mod
import repro_torch.rollout.prefill as p_pf_mod
from conftest import tiny_lm
from repro.core.manager import TaskSpec as JSpec
from repro.core.runtime import MARLaaSRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.data import tokenizer as tok
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout.engine import ContinuousRolloutEngine, RolloutRequest
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core.manager import TaskSpec
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.models import tree_leaves
from repro_torch.rollout.engine import (
    ContinuousRolloutEngine as PtContinuous, RolloutEngine as PtEngine,
    RolloutRequest as PtRequest)

CALL_AT = (2, 9)          # sampled-token counters that emit CALL
LP_TOL = 1e-5             # the reference tests' logprob tolerance
FAMS = {"ssm": "mamba2-780m", "hybrid": "zamba2-1.2b"}
_COUNTS = ("parks", "resumes", "splices", "restores",
           "device_resident_resumes", "fused_forced_tokens", "replays",
           "snapshots", "tool_wait_slot_steps", "prefill_tokens",
           "tokens_generated", "sampled_tokens", "completions")


@pytest.fixture(scope="module", autouse=True)
def _biased_sampling():
    """Every engine's sampler, in both packages, returns CALL at the
    CALL_AT counters and never EOS; undone after the module."""
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


_WEIGHTS = {}


def _weights(fam):
    """(JAX cfg, port cfg, JAX params, JAX trees, port params, port trees,
    numpy params, numpy trees)."""
    if fam not in _WEIGHTS:
        name = FAMS[fam]
        jcfg = tiny_lm(name)
        pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY[name],
                                              dtype="float32"),
                                   vocab_size=tok.VOCAB_SIZE)
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
                         [bridge.lora_from_jax(t, "cpu") for t in trees],
                         params, trees)
    return _WEIGHTS[fam]


def _requests(n=6, latency=0.0):
    """Rows alternating a multi-turn agentic env (hopsearch, kb 8, 2 hops)
    and gsm8k, explicit seeds; the same for both packages."""
    out = []
    for mk, Req in ((make_env, RolloutRequest), (pt_make_env, PtRequest)):
        agentic = mk("hopsearch", kb_size=8, hops=2, seed=0)
        agentic.env_latency_mean, agentic.env_latency_std = latency, 0.0
        pick = [agentic, mk("gsm8k")]
        rng = random.Random(7)
        reqs = []
        for i in range(n):
            env = pick[i % 2]
            prompt, truth = env.sample_prompt(rng)
            reqs.append(Req(f"t{i % 2}", i % 2, list(prompt), truth, env,
                            max_new_tokens=6, seed=i))
        out.append(reqs)
    assert [r.prompt for r in out[0]] == [r.prompt for r in out[1]]
    return out


_REFS = {}


def _frozen_oracle(fam, preqs, key="main"):
    """The port's freeze-in-slot one-shot ``generate``."""
    if (fam, key) not in _REFS:
        _, pcfg, _, _, pparams, ptrees, _, _ = _weights(fam)
        _REFS[fam, key], _ = PtEngine(pcfg, pparams, max_len=96, seed=0,
                                      device="cpu").generate(preqs, ptrees)
    return _REFS[fam, key]


_ENGINES = {}


def _engine(fam, pkg, **kw):
    """A reusable engine per (family, package, mode): requests carry
    explicit seeds, so repeated drives give the same tokens."""
    key = (fam, pkg, tuple(sorted(kw.items())))
    if key not in _ENGINES:
        jcfg, pcfg, jparams, jtrees, pparams, ptrees, _, _ = _weights(fam)
        base = dict(max_slots=2, max_adapters=2, max_len=96, seed=0)
        if pkg == "port":
            eng = PtContinuous(pcfg, pparams, device="cpu", **base, **kw)
            trees = ptrees
        else:
            eng = ContinuousRolloutEngine(jcfg, jparams, **base, **kw)
            trees = jtrees
        for i in range(2):
            eng.set_adapters(i, trees[i])
        _ENGINES[key] = eng
    return _ENGINES[key]


def _drive(eng, reqs, preempt_step=0, victims=(), deadline_s=120.0):
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
                                   atol=LP_TOL, err_msg=ctx)


def _same(cp, cj, ctx=""):
    for i in cj:
        assert list(cp[i].tokens) == list(cj[i].tokens), f"{ctx} row {i}"
        assert list(cp[i].gen_loss_mask) == list(cj[i].gen_loss_mask), ctx
        np.testing.assert_allclose(cp[i].gen_logprobs, cj[i].gen_logprobs,
                                   atol=LP_TOL, err_msg=ctx)


def _counts(stats):
    return {k: getattr(stats, k) for k in _COUNTS}


PAGED = dict(paged_kv=True, kv_page_size=16)
MODES = {"disagg": dict(env_stage=True, disagg_prefill=True),
         "paged_disagg": dict(PAGED, env_stage=True, disagg_prefill=True),
         "paged_fused": dict(PAGED, env_stage=True)}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("fam", sorted(FAMS))
def test_env_stage_matches_frozen_baseline_token_for_token(fam, mode):
    """Parked rows resume (through the workers or the fused refill; on the
    paged pool a hybrid row's pages stay in the pool and its recurrent rows
    come back from a host snapshot, an ssm row's from a snapshot alone)
    with the freeze-in-slot tokens; every agentic row runs two tool turns;
    no tool-waiting row holds a slot; the counters equal the JAX engine's
    in the same mode."""
    jreqs, preqs = _requests()
    ref = _frozen_oracle(fam, preqs)
    cp, _ = _drive(_engine(fam, "port", **MODES[mode]), preqs)
    cj, _ = _drive(_engine(fam, "jax", **MODES[mode]), jreqs)
    _matches(cp, ref, f"{fam}/{mode}")
    _same(cp, cj, f"{fam}/{mode} vs JAX")
    pe = _engine(fam, "port", **MODES[mode])
    je = _engine(fam, "jax", **MODES[mode])
    assert pe.stats.parks > 0 and pe.stats.resumes > 0
    assert pe.stats.tool_wait_slot_steps == 0
    for i in range(0, len(preqs), 2):
        c = cp[i]
        gen = list(c.tokens)[c.prompt_len:]
        assert sum(1 for j, t in enumerate(gen)
                   if t == tok.RESP and c.gen_loss_mask[j] == 0.0) == 2
    assert _counts(pe.stats) == _counts(je.stats)
    if pe.paged_kv:
        assert pe._pages.used_pages == pe._prefix_idx.held_pages == 0
        assert pe._snap_store.bytes_used == 0


def test_hybrid_frozen_rows_with_tool_latency_keep_their_state():
    """The freeze-in-slot baseline with 50 ms tool calls (each agentic row
    spends decode steps frozen in its slot, advance 0): the port's hybrid
    one-shot ``generate`` and its frozen continuous engine give the
    latency-free oracle's tokens and logprobs (1e-5), so a frozen step
    leaves a row's recurrent state as it was."""
    _, preqs = _requests(latency=0.05)
    ref = _frozen_oracle("hybrid", _requests()[1])
    _, pcfg, _, _, pparams, ptrees, _, _ = _weights("hybrid")
    out, st = PtEngine(pcfg, pparams, max_len=96, seed=0,
                       device="cpu").generate(preqs, ptrees)
    for i, r in enumerate(ref):
        assert out[i]["tokens"] == r["tokens"], i
        np.testing.assert_allclose(out[i]["gen_logprobs"], r["gen_logprobs"],
                                   atol=LP_TOL)
    eng = _engine("hybrid", "port", scheduler="fifo")
    comps, _ = _drive(eng, preqs)
    _matches(comps, ref, "hybrid frozen continuous")
    assert eng.stats.tool_wait_slot_steps > 0      # rows sat frozen


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("fam", sorted(FAMS))
def test_preempt_at_any_turn_replay_parity(fam, paged):
    """Preempting tenants at engine iterations before, between and after
    tool turns (parked rows hold no slot, so preemption never touches
    them) gives the frozen oracle's tokens, and the JAX engine's; rows
    replay (dense) or restore (paged)."""
    jreqs, preqs = _requests()
    ref = _frozen_oracle(fam, preqs)
    kw = dict(PAGED, env_stage=True, disagg_prefill=True) if paged \
        else dict(env_stage=True, disagg_prefill=True)
    pe, je = _engine(fam, "port", **kw), _engine(fam, "jax", **kw)
    n = 0
    for step, victims in ((1, ("t0",)), (6, ("t1",)), (12, ("t0", "t1")),
                          (19, ("t0", "t1")), (25, ("t1",))):
        cp, k = _drive(pe, preqs, step, victims)
        cj, _ = _drive(je, jreqs, step, victims)
        n += k
        _matches(cp, ref, f"{fam} preempt@{step}")
        _same(cp, cj, f"{fam} preempt@{step} vs JAX")
    assert n > 0
    assert (pe.stats.restores if paged else pe.stats.replays) > 0
    assert pe.stats.tool_wait_slot_steps == 0


SPECS = [dict(task_id="t0", env_name="gsm8k", group_size=2, num_groups=1,
              max_new_tokens=4, target_steps=2),
         dict(task_id="t1", env_name="gsm8k", group_size=2, num_groups=1,
              max_new_tokens=5, target_steps=2)]


def _runtime(fam, pkg, async_train):
    jcfg, pcfg, jparams, _, pparams, _, _, trees = _weights(fam)
    kw = dict(policy="marlaas", max_len=48, max_slots=4, seed=5,
              async_train=async_train, max_staleness=0)
    if pkg == "port":
        rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(device="cpu", **kw))
    else:
        rt = JRuntime(jcfg, jparams, JConfig(use_kernel=False, **kw))
    for i, s in enumerate(SPECS):
        if pkg == "port":
            rt.submit_task(TaskSpec(**s), bridge.lora_from_jax(trees[i], "cpu"))
        else:
            rt.submit_task(JSpec(**s), jax.tree.map(jnp.asarray, trees[i]))
        rt.datagens[s["task_id"]] = random.Random(100 + i)
    rt.run(timeout_s=300)
    assert rt.mgr.all_done()
    return rt


@pytest.mark.parametrize("fam", sorted(FAMS))
def test_async_staleness0_bitwise_matches_sync_baseline(fam):
    """At max_staleness 0 the port's event-driven trainer gives the
    round-synchronous run's versions, reward histories and adapters bit for
    bit (the reference's own property, on the port), with no drop; the JAX
    runtime's sync run reaches the same versions and reward histories."""
    sync, asyn = (_runtime(fam, "port", a) for a in (False, True))
    jsync = _runtime(fam, "jax", False)
    assert all(v == 0 for v in asyn.mgr.drop_counters().values())
    for tid, st_sync in sync.mgr.task_items():
        st_async = asyn.mgr.state(tid)
        assert st_async.version == st_sync.version == 2
        assert st_async.reward_history == st_sync.reward_history
        assert jsync.mgr.state(tid).version == st_sync.version
        np.testing.assert_allclose(st_sync.reward_history,
                                   jsync.mgr.state(tid).reward_history,
                                   atol=1e-6)
        for a, b in zip(tree_leaves(st_sync.adapters),
                        tree_leaves(st_async.adapters)):
            assert torch.equal(a, b)
