"""The port's MARLaaSRuntime (``repro_torch.core.runtime``) on the CPU,
against the JAX package's runtime where the run is deterministic.

Both runtimes get ``tiny_lm("granite-3-2b")`` in fp32, the same bridged
weights and, per tenant, the same adapters (the JAX ``init_lora`` with
``b ~ N(0, 0.3²)``) and optimizer state passed to ``submit_task``. Rewards
come from a graded verifier (the share of even token ids in a completion)
so that GRPO advantages, gradients and updates are not zero. The JAX
runtime runs with ``use_kernel=False``: its Pallas ``token_logprob`` has no
VJP (ROADMAP §3), and the port's CPU trainer takes the same chunked plain
path.

- Deterministic schedules (``multilora_sync`` and ``single_disagg`` with two
  tenants; ``marlaas`` with one tenant, the async trainer off and on at
  ``max_staleness=0``; the same over the paged pool): equal versions,
  reward histories, ``row_accounting()``, recorder counters and drop
  counters, and adapters and optimizer state within the tolerances of
  ``tests/test_torch_train.py``: each tenant's first commit 1e-6 where the
  step is determined and one step (lr) elsewhere, as its ``_assert_step``;
  its second commit's update 5e-4 of itself where the moments determine it
  (``|m̂|/sqrt(v̂)`` above 0.3 and ``sqrt(v̂)`` above 1% of the leaf's
  largest) and one step elsewhere; after the run, the state holds the last
  commit's tree and the moments agree within 1e-4 of each leaf's largest
  element (as gradients through a model).
- ``marlaas`` with two tenants, where submit order crosses threads, on the
  port alone: Algorithm 1's invariants (``tests/test_system.py``), sync
  against async at ``max_staleness=0`` bit for bit, and an exact row
  account at ``max_staleness=1`` over the paged pool.
- ``abort_tenant`` on the port's engine against the JAX engine's, dense and
  paged: equal completions and finish reasons, and the other tenant's
  rows as in a run without the abort.
- A commit's adapter tree shares no storage with the tree the rollout
  thread holds; ``RuntimeConfig()`` raises without a card; each later
  stage's switch reaches the engine (the prefix cache, the prefill workers,
  the env stage) or runs (tracing, chaos, checkpoints, ``adopt_checkpoint``
  and ``run_with_recovery``: ``tests/test_torch_obs.py`` and
  ``tests/test_torch_faults.py`` hold them against the JAX package); the
  ``multi_tenant_train`` entry point runs on the CPU."""
import dataclasses
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

from conftest import tiny_lm
from repro.core.manager import TaskSpec as JSpec
from repro.core.runtime import (MARLaaSRuntime as JRuntime,
                                RuntimeConfig as JConfig)
from repro.data import tokenizer as tok
from repro.envs.tasks import REGISTRY as J_ENVS
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rollout.engine import (ContinuousRolloutEngine as JContinuous,
                                  RolloutRequest as JRequest)
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_opt_state as j_init_opt
from repro_torch import bridge
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.manager import TaskSpec
from repro_torch.core.runtime import (FailureInjector, MARLaaSRuntime,
                                      RuntimeConfig)
from repro_torch.envs.tasks import REGISTRY as P_ENVS
from repro_torch.models import tree_leaves
from repro_torch.rollout.engine import (ContinuousRolloutEngine as PContinuous,
                                        RolloutRequest as PRequest)

LR = 3e-3                # TaskSpec's default learning rate
STEP_TOL = 1e-6          # parameters after one step, where it is determined
MOMENT_TOL = 1e-4        # moments, of each leaf's largest element
UPDATE_RATIO = 0.3       # a later step's update is determined where
UPDATE_FLOOR = 0.01      # |m̂|/sqrt(v̂) and sqrt(v̂) (of the leaf's
UPDATE_RTOL = 5e-4       # largest) are above these; it agrees to this
B_SCALE = 0.3


def _graded(envs, name):
    """The named env with a graded verifier: the share of even token ids in
    the completion, so rewards differ within a GRPO group."""
    base = envs[name]

    class Graded(base):
        def verify(self, truth, completion_ids):
            comp = list(completion_ids)
            return sum(t % 2 == 0 for t in comp) / max(1, len(comp))

    return Graded()


@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, JAX params, port params, numpy adapter trees)."""
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
            leaf["b"] = (rs.randn(*leaf["b"].shape) * B_SCALE).astype(
                np.float32)
        trees.append(tree)
    return (jcfg, pcfg, jax.tree.map(jnp.asarray, params),
            bridge.params_from_jax(params, pcfg, "cpu"), trees)


SPECS = [dict(task_id="gsm-0", env_name="gsm8k", group_size=2, num_groups=1,
              max_new_tokens=5, target_steps=2),
         dict(task_id="amc-0", env_name="amc12", group_size=2, num_groups=1,
              max_new_tokens=6, target_steps=2)]


def _record_commits(rt, to_numpy):
    """{tenant: [(adapters before, adapters after, m, v), ...]}, one entry a
    commit, flattened to numpy, recorded as the manager commits them."""
    commits, commit = {}, rt.mgr.commit

    def record(tid, adapters, opt, version, **kw):
        trees = (rt.mgr.state(tid).adapters, adapters, opt["m"], opt["v"])
        commits.setdefault(tid, []).append(
            tuple(_flat(to_numpy(t)) for t in trees))
        return commit(tid, adapters, opt, version, **kw)
    rt.mgr.commit = record
    return commits


def _pair(weights, policy, n_tenants, **kw):
    """The JAX and the port runtime with the same configuration, tenants,
    adapters, optimizer state and graded envs, each run to the end; with
    each tenant's commits of either."""
    jcfg, pcfg, jparams, pparams, trees = weights
    jrt = JRuntime(jcfg, jparams, JConfig(policy=policy, max_len=48, seed=3,
                                          use_kernel=False, **kw))
    prt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy=policy, max_len=48, seed=3, device="cpu", **kw))
    for i, s in enumerate(SPECS[:n_tenants]):
        jspec, pspec = JSpec(**s), TaskSpec(**s)
        jad = jax.tree.map(jnp.asarray, trees[i])
        jopt = j_init_opt(jcfg, JTrainConfig(group_size=jspec.group_size),
                          jparams, jad)
        jrt.submit_task(jspec, jad, jopt)
        prt.submit_task(pspec, bridge.lora_from_jax(trees[i], "cpu"),
                        bridge.lora_from_jax(jax.tree.map(np.asarray, jopt),
                                             "cpu"))
        jrt.envs[s["task_id"]] = _graded(J_ENVS, s["env_name"])
        prt.envs[s["task_id"]] = _graded(P_ENVS, s["env_name"])
        # the runtimes seed a tenant's prompt stream with Python's salted
        # str hash; a fixed stream makes the run the same in every process
        jrt.datagens[s["task_id"]] = random.Random(100 + i)
        prt.datagens[s["task_id"]] = random.Random(100 + i)
    jcommits = _record_commits(jrt, lambda t: jax.tree.map(np.asarray, t))
    pcommits = _record_commits(prt, bridge.to_numpy)
    jrt.run(timeout_s=300)
    prt.run(timeout_s=300)
    return jrt, prt, jcommits, pcommits


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _assert_first_step(got, want, m):
    """``tests/test_torch_train.py::_assert_step``: after one AdamW step an
    element whose clipped gradient (10 m) is above 100 eps moves by about
    lr * sign(g) and must agree to STEP_TOL; any other within one step. A
    leaf with no gradient (a group whose rewards tie) does not move."""
    assert got.keys() == want.keys() == m.keys()
    for k in want:
        err = np.abs(got[k] - want[k])
        if not np.any(m[k]):
            assert err.max() <= STEP_TOL, k
            continue
        sure = np.abs(10 * m[k]) > 100 * 1e-8
        assert sure.mean() > 0.5, k
        assert err[sure].max(initial=0) <= STEP_TOL, (k, err[sure].max())
        assert err.max() <= LR, (k, err.max())


def _assert_later_step(got, want, t):
    """Commit ``t`` >= 2: its update ``u = (before - after) / lr`` against
    the JAX runtime's, element by element. Where the update is determined
    by the moments, its ratio ``|m̂| / sqrt(v̂)`` above UPDATE_RATIO and
    ``sqrt(v̂)`` above UPDATE_FLOOR of the leaf's largest (so that a
    gradient error of MOMENT_TOL of the leaf's scale moves it little), it
    agrees to UPDATE_RTOL of itself; elsewhere within one step."""
    (pb, pa), (jb, ja, m, v) = got[:2], want
    b1c, b2c = 1 - 0.9 ** t, 1 - 0.999 ** t        # AdamWConfig's b1, b2
    for k in ja:
        u_got, u_want = (pb[k] - pa[k]) / LR, (jb[k] - ja[k]) / LR
        root = np.sqrt(v[k] / b2c)
        sure = ((np.abs(m[k] / b1c) > UPDATE_RATIO * (root + 1e-8))
                & (root > UPDATE_FLOOR * root.max()))
        assert sure.mean() > 0.5, (k, sure.mean())
        err = np.abs(u_got - u_want)
        assert np.all(err[sure] <= UPDATE_RTOL * np.abs(u_want[sure])), \
            (k, (err[sure] / np.abs(u_want[sure])).max())
        assert err.max() <= 1.0, (k, err.max())


def _assert_final(pst, jst, pcommits, init):
    """The tenant's state holds its last commit's tree; moments within
    MOMENT_TOL of each leaf's largest element, equal step counters; and
    some leaf moved."""
    n = jst.steps_done
    got = _flat(bridge.to_numpy(pst.adapters))
    assert got.keys() == pcommits[-1][1].keys()
    for k in got:
        assert np.array_equal(got[k], pcommits[-1][1][k]), k
    assert any(np.any(got[k] != init[k]) for k in got), \
        "no adapter leaf moved: the parity would be vacuous"
    for part in ("m", "v"):
        g = _flat(bridge.to_numpy(pst.opt_state[part]))
        w = _flat(jst.opt_state[part])
        for k in w:
            scale = np.abs(w[k]).max()
            assert np.abs(g[k] - w[k]).max() <= MOMENT_TOL * scale, (part, k)
    assert int(pst.opt_state["step"]) == int(jst.opt_state["step"]) == n


PARITY = {
    "multilora_sync": ("multilora_sync", 2, {}),
    "single_disagg": ("single_disagg", 2, {}),
    "marlaas_sync_trainer": ("marlaas", 1, {}),
    "marlaas_async_staleness0": ("marlaas", 1, dict(async_train=True,
                                                    max_staleness=0)),
    "marlaas_paged": ("marlaas", 1, dict(paged_kv=True, prefix_cache=False,
                                         kv_page_size=16)),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_deterministic_runs_match_jax(weights, case):
    policy, n, kw = PARITY[case]
    jcfg, pcfg, jparams, pparams, trees = weights
    jrt, prt, jcommits, pcommits = _pair(weights, policy, n, **kw)
    assert prt.mgr.all_done() and jrt.mgr.all_done()
    for tid, jst in jrt.mgr.task_items():
        pst = prt.mgr.state(tid)
        assert (pst.version, pst.steps_done) == (jst.version, jst.steps_done) \
            == (2, 2)
        assert pst.reward_history == jst.reward_history
        assert len(set(jst.reward_history)) > 1 or any(jst.reward_history)
        pc, jc = pcommits[tid], jcommits[tid]
        assert len(pc) == len(jc) == 2
        _assert_first_step(pc[0][1], jc[0][1], jc[0][2])
        _assert_later_step(pc[1], jc[1], 2)
        init = trees[[s["task_id"] for s in SPECS].index(tid)]
        _assert_final(pst, jst, pc, _flat(init))
    assert prt.row_accounting() == jrt.row_accounting()
    assert prt.rec.counters_snapshot() == jrt.rec.counters_snapshot()
    assert prt.mgr.drop_counters() == jrt.mgr.drop_counters()
    ntrain = [len([iv for iv in rt.rec.intervals if iv.phase == "train"])
              for rt in (jrt, prt)]
    assert ntrain[0] == ntrain[1] == 2 * n


def _port_runtime(weights, tenants=2, seed=11, target_steps=3, **kw):
    _, pcfg, _, pparams, trees = weights
    rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy="marlaas", max_len=48, seed=seed, device="cpu", **kw))
    for i in range(tenants):
        rt.submit_task(TaskSpec(f"t{i}", "gsm8k", group_size=2, num_groups=1,
                                max_new_tokens=4 + i,
                                target_steps=target_steps),
                       bridge.lora_from_jax(trees[i % 2], "cpu"))
        rt.envs[f"t{i}"] = _graded(P_ENVS, "gsm8k")
    return rt


def test_marlaas_algorithm1_invariants(weights):
    """``tests/test_system.py``: two tenants, versions advance once a step,
    train intervals never overlap, some decode interval serves both
    tenants, and some decode interval overlaps some train interval."""
    rt = _port_runtime(weights)
    rt.run(timeout_s=300)
    assert rt.mgr.all_done()
    for st in rt.mgr.tasks.values():
        assert st.version == 3 and st.steps_done == 3
    ivs = rt.rec.intervals
    trains = sorted([iv for iv in ivs if iv.phase == "train"],
                    key=lambda iv: iv.start)
    rollouts = [iv for iv in ivs if iv.phase == "decode"]
    assert len(trains) == 6 and rollouts
    for a, b in zip(trains, trains[1:]):
        assert b.start >= a.end - 1e-6
    assert any("+" in iv.task_id for iv in rollouts)
    assert any(r.start < t.end and t.start < r.end
               for r in rollouts for t in trains)
    acc = rt.row_accounting()
    assert acc["completed"] == acc["trained"] == 12 and acc["orphaned"] == 0


def test_async_staleness0_bitwise_matches_sync(weights):
    """``test_async_staleness0_bitwise_matches_sync_baseline`` (attention):
    at ``max_staleness=0`` the event-driven trainer gives the round-
    synchronous trainer's adapters and reward histories bit for bit."""
    rts = {}
    for mode in (False, True):
        rt = _port_runtime(weights, seed=5, target_steps=2, max_slots=4,
                           async_train=mode, max_staleness=0)
        rt.run(timeout_s=300)
        assert rt.mgr.all_done()
        rts[mode] = rt
    sync, asyn = rts[False], rts[True]
    assert all(v == 0 for v in asyn.mgr.drop_counters().values())
    for tid, st_sync in sync.mgr.task_items():
        st_async = asyn.mgr.state(tid)
        assert st_async.version == st_sync.version
        assert st_async.reward_history == st_sync.reward_history
        for a, b in zip(tree_leaves(st_sync.adapters),
                        tree_leaves(st_async.adapters)):
            assert torch.equal(a, b)


def test_async_staleness1_paged_row_accounting_exact(weights):
    """A pipelined run (``max_staleness=1``, sub-round micro-batches, the
    importance weight on) over the paged pool: every completed row is
    trained, dropped stale or discarded as a finished task's tail; no row
    is orphaned and the pool is whole at the end."""
    rt = _port_runtime(weights, seed=23, target_steps=3, async_train=True,
                       max_staleness=1, min_train_rows=2, paged_kv=True,
                       prefix_cache=False, kv_page_size=16)
    assert rt._tc(rt.mgr.spec_for("t0")).is_cap > 0
    rt.run(timeout_s=300)
    assert rt.mgr.all_done()
    acc = rt.row_accounting()
    assert acc["orphaned"] == acc["failed"] == acc["quarantine_dropped"] == 0
    assert acc["completed"] == (acc["trained"] + acc["stale_dropped"]
                                + acc["discarded_tails"])
    assert rt.mgr.inflight_rows() == {} and not rt.mgr._inflight_train
    assert rt.cengine._pages.used_pages == 0


def test_commit_never_aliases_the_rollout_tree(weights):
    """Every committed adapter tree shares no storage with any tree the
    rollout thread was handed before it (kept alive here, so no address is
    reused), nor with the engine's stacked buffer the decode reads."""
    rt = _port_runtime(weights, target_steps=2)
    installed, commits = [], {}
    set_adapters, commit = rt.cengine.set_adapters, rt.mgr.commit

    def storages(tree):
        return {t.untyped_storage().data_ptr() for t in tree_leaves(tree)}

    def record_install(slot, tree):
        installed.append(tree)
        set_adapters(slot, tree)

    def checked_commit(tid, adapters, opt, version, **kw):
        new = storages(adapters)
        assert not new & storages(rt.mgr.state(tid).adapters)
        assert not new & storages(rt.cengine._stacked)
        assert not any(new & storages(t) for t in installed)
        commits[tid] = commits.get(tid, 0) + 1
        return commit(tid, adapters, opt, version, **kw)

    rt.cengine.set_adapters = record_install
    rt.mgr.commit = checked_commit
    rt.run(timeout_s=300)
    assert rt.mgr.all_done() and commits == {"t0": 2, "t1": 2}
    assert len(installed) == 4      # versions 0 and 1 of each tenant


# -- abort_tenant, engine against engine ----------------------------------

def _abort_requests(n):
    jenv, penv = J_ENVS["gsm8k"](), P_ENVS["gsm8k"]()
    rj, rp = random.Random(4), random.Random(4)
    jreqs, preqs = [], []
    for i in range(n):
        pj, tj = jenv.sample_prompt(rj)
        pp, tp = penv.sample_prompt(rp)
        args = (f"t{i % 2}", i % 2)
        kws = dict(max_new_tokens=6 + i, seed=i)
        jreqs.append(JRequest(*args, pj, tj, jenv, **kws))
        preqs.append(PRequest(*args, list(pp), tp, penv, **kws))
    return jreqs, preqs


def _run_abort(eng, reqs, abort_at):
    pos = {eng.submit(r): i for i, r in enumerate(reqs)}
    comps, it, aborted = {}, 0, None
    while not eng.idle() and it < 400:
        eng.step()
        it += 1
        if it == abort_at:
            aborted = eng.abort_tenant("t1")
            assert eng.queue_depths()[1] == 0
        for c in eng.drain_completions():
            assert pos[c.submit_index] not in comps
            comps[pos[c.submit_index]] = c
    assert len(comps) == len(reqs)
    return comps, aborted


@pytest.mark.parametrize("paged", [False, True])
def test_abort_tenant_matches_jax(weights, paged):
    """3 slots, 8 requests of two tenants; after 2 steps tenant t1 is
    aborted with rows resident and queued. Each of its rows yields one
    "quarantined" completion, as the JAX engine's; t0's rows are those of a
    run without the abort."""
    jcfg, pcfg, jparams, pparams, trees = weights
    kw = dict(max_slots=3, max_adapters=2, max_len=64, seed=0,
              prefix_cache=False, paged_kv=paged, kv_page_size=16)
    jreqs, preqs = _abort_requests(8)
    runs = []
    for abort_at in (2, None):
        je = JContinuous(jcfg, jparams, **kw)
        pe = PContinuous(pcfg, pparams, device="cpu", **kw)
        for i in range(2):
            je.set_adapters(i, jax.tree.map(jnp.asarray, trees[i]))
            pe.set_adapters(i, bridge.lora_from_jax(trees[i], "cpu"))
        cj, nj = _run_abort(je, jreqs, abort_at)
        cp, np_ = _run_abort(pe, preqs, abort_at)
        assert nj == np_
        for i in range(8):
            assert list(cp[i].tokens) == list(cj[i].tokens), i
            assert cp[i].finish_reason == cj[i].finish_reason, i
            np.testing.assert_allclose(cp[i].gen_logprobs, cj[i].gen_logprobs,
                                       rtol=1e-5, atol=1e-5)
        assert pe.supervisor.counters == {}
        assert pe.env_depths() == (0, 0)
        if paged:
            pe.check_page_invariants()
            assert pe._pages.used_pages == 0
        runs.append((cp, np_))
    (aborted, n), (clean, _) = runs
    t1 = [i for i in range(8) if i % 2]
    assert n == 4 and all(aborted[i].finish_reason == "quarantined"
                          for i in t1)
    for i in range(0, 8, 2):
        assert list(aborted[i].tokens) == list(clean[i].tokens), i
        assert aborted[i].finish_reason == clean[i].finish_reason


# -- construction ---------------------------------------------------------

def test_default_config_needs_a_card(weights):
    _, pcfg, _, pparams, _ = weights
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MARLaaSRuntime(pcfg, pparams, RuntimeConfig())


@pytest.mark.parametrize("flag,item", [
    (dict(disagg_prefill=True), "item 4"), (dict(env_stage=True), "item 5"),
    (dict(paged_kv=True), "item 3"), (dict(trace=True), "trace"),
    (dict(chaos=ChaosConfig(seed=1, torn_checkpoint=1.0,
                            max_faults_per_site=1),
          env_stage=True, supervisor_wedge_s=30.0), "chaos"),
    (dict(checkpoint_every=1, checkpoint_keep_last=1), "checkpoint")],
    ids=["disagg_prefill", "env_stage", "prefix_cache", "trace", "chaos",
         "checkpoint"])
def test_switches_not_ported_raise(weights, flag, item, tmp_path):
    """Each later stage's switch reaches the runtime's engine, or runs.
    ``paged_kv=True`` builds the engine with the prefix cache on and
    admission charges shared prompt pages once; the runtime hands the
    prefill workers' and the env stage's switches and knobs to its engine
    (``tests/test_torch_disagg.py`` and ``tests/test_torch_env_stage.py``
    run them against the JAX runtime). ``trace``: one tracer shared by the
    runtime, the manager, the engine and its supervisor, and a one-step run
    traces every episode to its commit. ``chaos``: one injector shared by
    the engine, its env stage and the checkpoint store, and a torn snapshot
    fails the run (the newest complete snapshot then is the one before).
    Checkpoints: one snapshot a commit, the older pruned."""
    _, pcfg, _, pparams, trees = weights
    if item == "item 4":
        rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
            device="cpu", prefill_workers=2, prefill_chunk=9, **flag))
        eng = rt.cengine
        assert eng.disagg_prefill and eng.prefill_workers == 2
        assert eng._prefill_chunk_eff == 16 and eng._env is None
        return
    if item == "item 5":
        rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
            device="cpu", env_workers=3, env_inflight_per_tenant=1,
            tool_retry_max=5, **flag))
        env = rt.cengine._env
        assert not rt.cengine.disagg_prefill and env is not None
        assert (env.n_workers, env.max_inflight_per_tenant,
                env.retry_max) == (3, 1, 5)
        return
    if item == "item 3":
        rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(device="cpu", **flag))
        assert rt.cengine.prefix_cache and rt.acfg.prefix_shared
        assert rt.cengine._prefix_idx is not None
        return
    ckpt = str(tmp_path / "ck")
    rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        device="cpu", max_len=48, seed=3, checkpoint_dir=ckpt, **flag))
    rt.submit_task(TaskSpec(task_id="gsm-0", env_name="gsm8k", group_size=2,
                            num_groups=1, max_new_tokens=4,
                            target_steps=2),
                   bridge.lora_from_jax(trees[0], "cpu"))
    if item == "trace":
        tr = rt.tracer
        assert tr is not None and rt.mgr.tracer is tr
        assert rt.cengine._tracer is tr and rt.cengine.supervisor.tracer is tr
        rt.run(timeout_s=300)
        seqs = [tr.state_sequence(t) for t in tr.components()]
        assert len(seqs) == 4
        assert all(q[0] == "submitted" and q[-1] == "committed"
                   for q in seqs)
        return
    if item == "chaos":
        assert rt.chaos is not None
        assert rt.cengine._chaos is rt.chaos
        assert rt.cengine._env.chaos is rt.chaos
        assert rt.cengine.supervise_wedge_s == 30.0
        rt.rcfg.checkpoint_every = 1
        with pytest.raises(Exception, match="torn checkpoint"):
            rt.run(timeout_s=300)
        assert rt.chaos.counts() == {"torn_checkpoint": 1}
        from repro_torch.checkpoint import latest_checkpoint
        assert latest_checkpoint(ckpt) is None   # the only one is torn
        return
    rt.run(timeout_s=300)
    snaps = sorted(os.listdir(ckpt))
    assert snaps == ["LATEST", "step_00000002"]


def test_checkpoint_entry_points_raise_and_disabled_chaos_runs(weights,
                                                               tmp_path):
    """A disabled ``ChaosConfig`` builds no injector; ``adopt_checkpoint``
    restores a snapshot into a fresh runtime (trees on its device, bit-equal
    to the snapshot's) and ``run_with_recovery`` restarts a crashed run from
    its newest snapshot and finishes it."""
    _, pcfg, _, pparams, trees = weights
    rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(device="cpu",
                                                     chaos=ChaosConfig()))
    assert rt.chaos is None and rt.tracer is None
    ckpt = str(tmp_path / "ck")
    rcfg = RuntimeConfig(device="cpu", max_len=48, seed=3,
                         checkpoint_dir=ckpt, checkpoint_every=1)
    rt = MARLaaSRuntime(pcfg, pparams, rcfg,
                        failure=FailureInjector(fail_after_commits=2))
    rt.submit_task(TaskSpec(task_id="gsm-0", env_name="gsm8k", group_size=2,
                            num_groups=1, max_new_tokens=4, target_steps=3),
                   bridge.lora_from_jax(trees[0], "cpu"))
    fin = rt.run_with_recovery(timeout_s=300)
    assert fin is not rt and fin.mgr.all_done()
    assert fin.mgr.state("gsm-0").version == 3
    assert fin.rec.counters_snapshot()["checkpoint_restarts"] == 1
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.manager import MultiTaskManager
    path = os.path.join(ckpt, "step_00000001")
    want = load_checkpoint(path, MultiTaskManager()).state("gsm-0")
    fresh = MARLaaSRuntime(pcfg, pparams, rcfg)
    fresh.adopt_checkpoint(path)
    got = fresh.mgr.state("gsm-0")
    assert got.version == 1 and got.status == "admitted"
    for a, b in zip(tree_leaves(got.adapters) + tree_leaves(got.opt_state),
                    tree_leaves(bridge.lora_from_jax(want.adapters, "cpu"))
                    + tree_leaves(bridge.lora_from_jax(want.opt_state, "cpu"))):
        assert a.device.type == "cpu" and a.dtype == b.dtype
        assert torch.equal(a, b)


def test_multi_tenant_train_entry_point(capsys):
    from repro_torch.launch.multi_tenant_train import main
    rt = main(["--preset", "tiny", "--device", "cpu", "--tasks", "2",
               "--steps", "1"])
    assert rt.mgr.all_done()
    assert all(st.version == 1 for _, st in rt.mgr.task_items())
    out = capsys.readouterr().out
    assert "total_steps" in out and "v1" in out
