"""The port's fault tolerance against the JAX package's, on the CPU: the
checkpoint store, chaos injection in the stages, restart from a checkpoint.

- The store (``tests/test_chaos.py``'s checkpoint scenarios), each written
  once and run on both packages: replace-aside, retention, the LATEST scan,
  a torn publish, the async episode round trip, orphaned rows.
- Snapshots across packages: a JAX-written snapshot (its ``episodes.pkl``
  included) loads in the port with bit-equal trees and the port's classes,
  and a JAX runtime's crash snapshot is adopted by the port's runtime,
  which trains every tenant to its target; a port-written snapshot loads in
  the JAX package with bit-equal trees (its ``episodes.pkl`` unpickles to
  the port's classes there: ROADMAP §3). The port's unpickler refuses other
  classes.
- The env stage's retries and injected faults (``tests/test_chaos.py``),
  on both packages' classes.
- The runtime under chaos (``tests/test_chaos.py``'s matrix: worker kills,
  transient tool errors bit-identical to a fault-free run, quarantine that
  recovers, abandonment), each with the exact row account; the worker-kill
  and transient runs against the JAX runtime's (equal chaos counts and the
  counters that do not depend on thread timing).
- ``tests/test_integration.py::test_failure_restart_resumes_exactly`` on the
  port, and ``run_with_recovery`` of the round-synchronous runtime against
  the JAX runtime's: equal versions and reward histories, adapters within
  ``tests/test_torch_runtime.py``'s tolerances, the adopted trees bit-equal
  to the snapshot."""
import dataclasses
import os
import pickle
import random
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)   # small shapes; leave the cores to the other workers

import jax
import jax.numpy as jnp

import repro.core.runtime as j_rt_mod
import repro.rollout.engine as j_eng_mod
import repro.rollout.prefill as j_pf_mod
import repro_torch.core.runtime as p_rt_mod
import repro_torch.rollout.engine as p_eng_mod
import repro_torch.rollout.prefill as p_pf_mod
from conftest import tiny_lm
from repro.checkpoint import store as j_store
from repro.core import chaos as j_chaos
from repro.core import manager as j_mgr
from repro.core.runtime import FailureInjector as JFailure
from repro.core.runtime import MARLaaSRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.data import tokenizer as tok
from repro.envs import base as j_base
from repro.envs.tasks import REGISTRY as J_ENVS
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.rl.types import RolloutCompletion as JCompletion
from repro.rollout import env_stage as j_env
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import init_opt_state as j_init_opt
from repro_torch import bridge
from repro_torch.checkpoint import store as p_store
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core import chaos as p_chaos
from repro_torch.core import manager as p_mgr
from repro_torch.core.runtime import FailureInjector
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.core.supervisor import ABANDONED, CLOSED, HALF_OPEN, OPEN
from repro_torch.envs import base as p_base
from repro_torch.envs.tasks import REGISTRY as P_ENVS
from repro_torch.models import tree_leaves
from repro_torch.rl.types import RolloutCompletion as PCompletion
from repro_torch.rollout import env_stage as p_env
from test_torch_runtime import (SPECS, _assert_final, _assert_first_step,
                                _assert_later_step, _flat, _graded)

REF = SimpleNamespace(store=j_store, mgr=j_mgr, chaos=j_chaos, env=j_env,
                      base=j_base)
PORT = SimpleNamespace(store=p_store, mgr=p_mgr, chaos=p_chaos, env=p_env,
                       base=p_base)
PKGS = {"jax": REF, "port": PORT}
B_SCALE = 0.3


def _assert_accounting(rt):
    """The extended conservation invariant, exactly."""
    acc = rt.row_accounting()
    assert acc["completed"] == (
        acc["trained"] + acc["stale_dropped"] + acc["discarded_tails"]
        + acc["failed"] + acc["quarantine_dropped"] + acc["orphaned"]), acc


# -- the store, both packages ---------------------------------------------

def _ck_mgr(P, **kw):
    m = P.mgr.MultiTaskManager(async_mode=True, max_staleness=1, **kw)
    m.submit(P.mgr.TaskSpec("t", "gsm8k", group_size=2, num_groups=2,
                            target_steps=100))
    m.admit("t")
    return m


def _ep(version, submit_index):
    return SimpleNamespace(version=version, submit_index=submit_index,
                           env=None, meta={})


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_replace_leaves_no_aside(pkg, tmp_path):
    P = PKGS[pkg]
    d = str(tmp_path)
    P.store.save_checkpoint(d, _ck_mgr(P), step_tag="s")
    p = P.store.save_checkpoint(d, _ck_mgr(P), step_tag="s")
    assert P.store.latest_checkpoint(d) == p
    assert not [n for n in os.listdir(d) if n.endswith(".replacing")]


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_keep_last_n_prunes_oldest(pkg, tmp_path):
    P = PKGS[pkg]
    d = str(tmp_path)
    for i in range(4):
        time.sleep(0.01)
        p = P.store.save_checkpoint(d, _ck_mgr(P), step_tag=f"s{i}",
                                    keep_last_n=2)
    snaps = sorted(n for n in os.listdir(d)
                   if os.path.isdir(os.path.join(d, n)))
    assert snaps == ["s2", "s3"]
    assert P.store.latest_checkpoint(d) == p


@pytest.mark.parametrize("pkg", PKGS)
def test_latest_checkpoint_scans_when_pointer_is_bad(pkg, tmp_path):
    P = PKGS[pkg]
    d = str(tmp_path)
    P.store.save_checkpoint(d, _ck_mgr(P), step_tag="old")
    time.sleep(0.01)
    newest = P.store.save_checkpoint(d, _ck_mgr(P), step_tag="new")
    os.remove(os.path.join(d, "LATEST"))
    assert P.store.latest_checkpoint(d) == newest
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("no_such_snapshot")
    assert P.store.latest_checkpoint(d) == newest


@pytest.mark.parametrize("pkg", PKGS)
def test_torn_checkpoint_falls_back_to_previous_snapshot(pkg, tmp_path):
    P = PKGS[pkg]
    d = str(tmp_path)
    good = P.store.save_checkpoint(d, _ck_mgr(P), step_tag="a")
    time.sleep(0.01)
    chaos = P.chaos.ChaosInjector(P.chaos.ChaosConfig(
        seed=0, torn_checkpoint=1.0, max_faults_per_site=1))
    with pytest.raises(P.chaos.ChaosError):
        P.store.save_checkpoint(d, _ck_mgr(P), step_tag="b", chaos=chaos)
    assert P.store.latest_checkpoint(d) == good
    fixed = P.store.save_checkpoint(d, _ck_mgr(P), step_tag="b", chaos=chaos)
    assert P.store.latest_checkpoint(d) == fixed


@pytest.mark.parametrize("pkg", PKGS)
def test_checkpoint_async_episode_roundtrip(pkg, tmp_path):
    P = PKGS[pkg]
    m = _ck_mgr(P, min_train_rows=1)
    for g in range(2):
        for i in range(2):
            m.enqueue_episode("t", 0, (0, g), _ep(0, g * 2 + i))
    popped_tid, popped = m.pop_episodes()
    m.enqueue_episode("t", 0, (0, 7), _ep(0, 8))
    m.enqueue_episode("t", 0, (0, 7), _ep(0, 9))
    m.tasks["t"].status = "quarantined"
    m.tasks["t"].failed_rows = 3
    m.failed_rows = 3
    m.quarantine_dropped_rows = 5
    path = P.store.save_checkpoint(str(tmp_path), m, step_tag="s")
    m2 = P.mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    P.store.load_checkpoint(path, m2)
    assert [g.seq for g in m2.episodes["t"]] \
        == [g.seq for g in popped] + [g.seq for g in m.episodes["t"]]
    assert m2.ready_rows("t") == 6
    assert not m2._inflight_train
    assert m2.failed_rows == 3 and m2.tasks["t"].failed_rows == 3
    assert m2.quarantine_dropped_rows == 5
    assert m2.tasks["t"].status == "admitted"
    assert all(c.env is None for g in m2.episodes["t"] for c in g.rows)
    env = object()
    assert m2.rebind_episode_envs({"t": env}) == 6
    assert all(c.env is env for g in m2.episodes["t"] for c in g.rows)


@pytest.mark.parametrize("pkg", PKGS)
def test_load_checkpoint_orphans_unserializable_completed_rows(pkg, tmp_path):
    P = PKGS[pkg]
    m = _ck_mgr(P, min_train_rows=1)
    m.enqueue_episode("t", 0, (0, 0), _ep(0, 0))
    m.enqueue_episode("t", 0, (0, 0), _ep(0, 1))
    m.rows_trained = 4
    m.tasks["t"].rollout_rows_total = 8
    path = P.store.save_checkpoint(str(tmp_path), m, step_tag="s")
    m2 = P.mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    P.store.load_checkpoint(path, m2)
    assert m2.rows_trained == 4
    assert m2.orphaned_rows == 2
    path2 = P.store.save_checkpoint(str(tmp_path), m2, step_tag="s2")
    m3 = P.mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    P.store.load_checkpoint(path2, m3)
    assert m3.orphaned_rows == 2


# -- snapshots across packages ----------------------------------------------

def _completion(Cls, i):
    return Cls(task_id="t", prompt_len=3, tokens=[5, 6, 7, 8 + i],
               gen_logprobs=[-0.5 - i], gen_loss_mask=[1.0], truth="42",
               env=None, finish_reason="eos", slot=i, version=0,
               sampled_tokens=1, submit_index=i, finished_at=1.5,
               meta={"task_id": "t", "version": 0, "group": (1, 0),
                     "trace_id": i})


def _trees(rs):
    ad = {"layers": {"attn_q": {"a": rs.randn(2, 4, 3).astype(np.float32),
                                "b": rs.randn(2, 3, 4).astype(np.float32)}}}
    opt = {"m": {"layers": {"attn_q": {k: rs.randn(*v.shape).astype(
               np.float32) for k, v in ad["layers"]["attn_q"].items()}}},
           "v": {"layers": {"attn_q": {k: np.abs(rs.randn(*v.shape)).astype(
               np.float32) for k, v in ad["layers"]["attn_q"].items()}}},
           "step": np.asarray(3, np.int32)}
    return ad, opt


def _leaves_equal(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert np.array_equal(fa[k], fb[k]), k


def test_jax_snapshot_loads_in_port(tmp_path):
    """The JAX store writes (trees, a FIFO batch, two episode groups of
    the JAX package's ``RolloutCompletion``); the port's loader gives
    bit-equal numpy trees (the int32 ``step`` included) and the port's
    classes with equal fields."""
    rs = np.random.RandomState(0)
    ad, opt = _trees(rs)
    m = j_mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    m.submit(j_mgr.TaskSpec("t", "gsm8k", group_size=2, num_groups=1),
             jax.tree.map(jnp.asarray, ad), jax.tree.map(jnp.asarray, opt))
    m.admit("t")
    for i in range(4):
        m.enqueue_episode("t", 0, (1, i // 2), _completion(JCompletion, i))
    path = j_store.save_checkpoint(str(tmp_path), m, step_tag="s")
    m2 = p_mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    p_store.load_checkpoint(path, m2)
    st = m2.state("t")
    _leaves_equal(st.adapters, ad)
    _leaves_equal(st.opt_state, opt)
    assert st.opt_state["step"].dtype == np.int32
    rows = [c for g in m2.episodes["t"] for c in g.rows]
    assert len(rows) == 4
    assert all(type(c) is PCompletion for c in rows)
    assert all(type(g) is p_mgr.EpisodeGroup for g in m2.episodes["t"])
    for i, c in enumerate(rows):
        want = dataclasses.asdict(_completion(JCompletion, i))
        assert dataclasses.asdict(c) == want


def test_port_snapshot_loads_in_jax(tmp_path):
    """The port writes its tensors' trees; the JAX loader reads bit-equal
    numpy trees from the manifest and the .npz files. Its plain
    ``pickle.load`` of the port's ``episodes.pkl`` imports the port's
    modules and gives the port's classes, with equal fields."""
    rs = np.random.RandomState(1)
    ad, opt = _trees(rs)
    m = p_mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    m.submit(p_mgr.TaskSpec("t", "gsm8k", group_size=2, num_groups=1),
             bridge.lora_from_jax(ad, "cpu"), bridge.lora_from_jax(opt, "cpu"))
    m.admit("t")
    for i in range(2):
        m.enqueue_episode("t", 0, (1, 0), _completion(PCompletion, i))
    path = p_store.save_checkpoint(str(tmp_path), m, step_tag="s")
    m2 = j_mgr.MultiTaskManager(async_mode=True, max_staleness=1)
    j_store.load_checkpoint(path, m2)
    st = m2.state("t")
    _leaves_equal(st.adapters, ad)
    _leaves_equal(st.opt_state, opt)
    (g,) = list(m2.episodes["t"])
    assert type(g) is p_mgr.EpisodeGroup
    assert [dataclasses.asdict(c) for c in g.rows] == [
        dataclasses.asdict(_completion(PCompletion, i)) for i in range(2)]
    assert m2.version_of("t") == 0 and m2.ready_rows("t") == 2


def test_jax_runtime_snapshot_adopted_by_port(weights, tmp_path):
    """The JAX runtime crashes after its second commit; a fresh port
    runtime adopts the newest snapshot (trees bit-equal to the JAX
    runtime's committed ones, on the port's device, AdamW's step int32)
    and trains every tenant to its target."""
    jcfg, pcfg, jparams, pparams, trees = weights
    ckpt = str(tmp_path / "ck")
    jrt = JRuntime(jcfg, jparams, JConfig(
        policy="multilora_sync", max_len=48, seed=3, use_kernel=False,
        checkpoint_dir=ckpt, checkpoint_every=1),
        failure=JFailure(fail_after_commits=2))
    for i, s in enumerate(SPECS):
        jrt.submit_task(j_mgr.TaskSpec(**s),
                        jax.tree.map(jnp.asarray, trees[i]))
    with pytest.raises(RuntimeError, match="injected node failure"):
        jrt.run(timeout_s=300)
    path = j_store.latest_checkpoint(ckpt)
    prt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy="multilora_sync", max_len=48, seed=3, device="cpu"))
    prt.adopt_checkpoint(path)
    saved = j_store.load_checkpoint(path, j_mgr.MultiTaskManager())
    for tid, st in prt.mgr.task_items():
        jst = saved.state(tid)
        assert isinstance(st.adapters["layers"]["attn_q"]["a"], torch.Tensor)
        assert st.opt_state["step"].dtype == torch.int32
        _leaves_equal(bridge.to_numpy(st.adapters),
                      jax.tree.map(np.asarray, jst.adapters))
        _leaves_equal(bridge.to_numpy(st.opt_state),
                      jax.tree.map(np.asarray, jst.opt_state))
    committed = jrt.mgr.state("gsm-0")
    assert committed.version == prt.mgr.state("gsm-0").version == 1
    _leaves_equal(bridge.to_numpy(prt.mgr.state("gsm-0").adapters),
                  jax.tree.map(np.asarray, committed.adapters))
    prt.run(timeout_s=300)
    assert prt.mgr.all_done()
    for _, st in prt.mgr.task_items():
        assert st.steps_done == st.version == st.spec.target_steps


def test_port_unpickler_refuses_other_classes():
    data = pickle.dumps({"t": [os.path.join]})
    with pytest.raises(pickle.UnpicklingError, match="not an episode"):
        p_store.load_episodes(data)
    ok = pickle.dumps({"t": [SimpleNamespace(a=np.arange(3), b=(1, 2))]})
    (row,) = p_store.load_episodes(ok)["t"]
    assert list(row.a) == [0, 1, 2] and row.b == (1, 2)


# -- env stage: retries and injected faults, both packages ------------------

class _FlakySession:
    """Session failing the first `fail` calls; optionally permanently."""

    def __init__(self, P, fail=0, permanent=False):
        self.P, self.fail, self.permanent = P, fail, permanent
        self.calls = 0

    def call(self, query_ids, cancel=None):
        self.calls += 1
        if self.permanent:
            raise self.P.base.PermanentToolError("endpoint down")
        if self.calls <= self.fail:
            raise self.P.base.TransientToolError("flaky")
        return [4, 2]


def _stage(P, **kw):
    kw.setdefault("retry_base_s", 0.001)
    kw.setdefault("retry_max_s", 0.01)
    return P.env.EnvStage(n_workers=1, **kw)


def _drain_one(stage, deadline_s=10.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < deadline_s:
        out = stage.drain_resolved()
        if out:
            return out[0]
        time.sleep(0.002)
    raise AssertionError("env stage never resolved the job")


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_retries_transient_then_succeeds(pkg):
    P = PKGS[pkg]
    stage = _stage(P, retry_max=3)
    sess = _FlakySession(P, fail=2)
    row = SimpleNamespace(session=sess, tool_retries=0)
    stage.submit(row, [1, 2], "t", latency=0.0)
    job = _drain_one(stage)
    assert job.error is None and job.response == [4, 2]
    assert sess.calls == 3 and stage.retries == 2
    assert row.tool_retries == 2
    stage.halt(timeout_s=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_fails_row_when_retry_budget_spent(pkg):
    P = PKGS[pkg]
    stage = _stage(P, retry_max=2)
    sess = _FlakySession(P, fail=99)
    stage.submit(SimpleNamespace(session=sess, tool_retries=0),
                 [1], "t", latency=0.0)
    job = _drain_one(stage)
    assert isinstance(job.error, P.base.TransientToolError)
    assert job.response == [] and sess.calls == 3
    stage.halt(timeout_s=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_permanent_error_fails_without_retry(pkg):
    P = PKGS[pkg]
    stage = _stage(P, retry_max=3)
    sess = _FlakySession(P, permanent=True)
    stage.submit(SimpleNamespace(session=sess, tool_retries=0),
                 [1], "t", latency=0.0)
    job = _drain_one(stage)
    assert isinstance(job.error, P.base.PermanentToolError)
    assert sess.calls == 1 and stage.retries == 0
    stage.halt(timeout_s=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_episode_retry_cap_bounds_flapping_rows(pkg):
    P = PKGS[pkg]
    stage = _stage(P, retry_max=5, retry_episode_cap=1)
    sess = _FlakySession(P, fail=99)
    row = SimpleNamespace(session=sess, tool_retries=0)
    stage.submit(row, [1], "t", latency=0.0)
    job = _drain_one(stage)
    assert isinstance(job.error, P.base.TransientToolError)
    assert row.tool_retries == 1
    stage.halt(timeout_s=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_injected_transient_fault_passes_through(pkg):
    P = PKGS[pkg]
    chaos = P.chaos.ChaosInjector(P.chaos.ChaosConfig(
        seed=0, tool_error_transient=1.0, transient_fail_count=2,
        max_faults_per_site=1))
    stage = _stage(P, retry_max=3, chaos=chaos)
    sess = _FlakySession(P)
    stage.submit(SimpleNamespace(session=sess, tool_retries=0),
                 [1], "t", latency=0.0)
    job = _drain_one(stage)
    assert job.error is None and job.response == [4, 2]
    assert sess.calls == 1 and stage.retries == 2
    assert chaos.counts() == {"tool_error_transient": 1}
    stage.halt(timeout_s=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_injected_permanent_fault_fails_the_job(pkg):
    """``tool_error_permanent`` beats the real call: the job fails at once,
    with no retry and no call reaching the session."""
    P = PKGS[pkg]
    chaos = P.chaos.ChaosInjector(P.chaos.ChaosConfig(
        seed=0, tool_error_permanent=1.0, max_faults_per_site=1))
    stage = _stage(P, retry_max=3, chaos=chaos)
    sess = _FlakySession(P)
    stage.submit(SimpleNamespace(session=sess, tool_retries=0),
                 [1], "t", latency=0.0)
    job = _drain_one(stage)
    assert isinstance(job.error, P.base.PermanentToolError)
    assert sess.calls == 0 and stage.retries == 0
    assert chaos.counts() == {"tool_error_permanent": 1}
    stage.halt(timeout_s=10.0)


@pytest.mark.parametrize("pkg", PKGS)
def test_env_stage_recovers_job_from_chaos_killed_worker(pkg):
    P = PKGS[pkg]
    chaos = P.chaos.ChaosInjector(P.chaos.ChaosConfig(
        seed=0, env_worker_kill=1.0, max_faults_per_site=1))
    stage = _stage(P, chaos=chaos)
    sess = _FlakySession(P)
    stage.submit(SimpleNamespace(session=sess, tool_retries=0),
                 [1], "t", latency=0.0)
    t0 = time.monotonic()
    while stage.healthy() and time.monotonic() - t0 < 10.0:
        time.sleep(0.002)
    assert not stage.healthy()
    assert stage.recover_dead() == 1
    stage._ensure_workers()
    job = _drain_one(stage)
    assert job.error is None and job.response == [4, 2]
    assert stage.recovered == 1 and sess.calls == 1
    stage.halt(timeout_s=10.0)


# -- the runtime under chaos --------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, JAX params, port params, numpy adapter trees),
    as ``tests/test_torch_runtime.py``'s."""
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


@pytest.fixture
def force_calls(monkeypatch):
    """``tests/test_chaos.py::_force_calls`` in both packages: every row
    samples CALL at token counter 2 (a plain token for tenants without
    tools) and never EOS."""
    j_orig, p_orig = j_pf_mod._sample_rows, p_pf_mod._sample_rows

    def j_biased(logits, keys, counters, temps):
        s = j_orig(logits, keys, counters, temps)
        s = jnp.where(s == tok.EOS, 10, s)
        return jnp.where(counters == 2, tok.CALL, s)

    def p_biased(logits, keys, counters, temps):
        s = p_orig(logits, keys, counters, temps)
        s = torch.where(s == tok.EOS, 10, s)
        return torch.where(counters == 2, tok.CALL, s)

    for mod in (j_pf_mod, j_eng_mod):
        monkeypatch.setattr(mod, "_sample_rows", j_biased)
    for mod in (p_pf_mod, p_eng_mod):
        monkeypatch.setattr(mod, "_sample_rows", p_biased)


def _chaos_runtime(weights, pkg="port", seed=3, chaos=None, **over):
    """``tests/test_chaos.py::_chaos_runtime``: a hopsearch and a gsm8k
    tenant, the prefill workers and the env stage on, a chaos script."""
    jcfg, pcfg, jparams, pparams, _ = weights
    kw = dict(policy="marlaas", max_len=64, seed=seed, max_slots=4,
              disagg_prefill=True, prefill_workers=1, env_stage=True,
              env_workers=2, max_turns=2, tool_retry_base_s=0.01,
              tool_retry_max_s=0.05, **over)
    if pkg == "port":
        rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
            device="cpu", chaos=None if chaos is None
            else p_chaos.ChaosConfig(**chaos), **kw))
        Spec = p_mgr.TaskSpec
    else:
        rt = JRuntime(jcfg, jparams, JConfig(
            use_kernel=False, chaos=None if chaos is None
            else j_chaos.ChaosConfig(**chaos), **kw))
        Spec = j_mgr.TaskSpec
    rt.submit_task(Spec("hop", "hopsearch", group_size=2, num_groups=1,
                        max_new_tokens=6, target_steps=2))
    rt.submit_task(Spec("gsm", "gsm8k", group_size=2, num_groups=1,
                        max_new_tokens=4, target_steps=2))
    for i, tid in enumerate(("hop", "gsm")):
        rt.datagens[tid] = random.Random(100 + i)
    return rt


_TIMING_FREE = ("chaos_", "supervisor_prefill_worker_jobs_recovered",
                "supervisor_env_worker_jobs_recovered", "env_recovered",
                "parks", "resumes", "completions", "tool_errors")


def _timing_free(counters):
    return {k: v for k, v in counters.items() if k.startswith(_TIMING_FREE)}


def test_runtime_survives_stage_worker_kills(weights, force_calls):
    """Prefill and env workers killed mid-job: the supervisor recovers the
    stranded work and restarts them; the run completes, every row is
    accounted for, and the JAX runtime counts the same faults."""
    kill = dict(seed=0, prefill_worker_kill=1.0, env_worker_kill=1.0,
                max_faults_per_site=1)
    rts = {}
    for pkg in ("port", "jax"):
        rt = _chaos_runtime(weights, pkg, chaos=kill)
        rt.run(timeout_s=300.0)
        assert rt.error is None
        assert all(st.done for st in rt.mgr.tasks.values())
        c = rt.rec.counters_snapshot()
        assert rt.chaos.counts().get("prefill_worker_kill") == 1
        assert rt.chaos.counts().get("env_worker_kill") == 1
        assert c.get("supervisor_prefill_worker_restarts", 0) >= 1
        assert c.get("supervisor_env_worker_restarts", 0) >= 1
        assert c.get("supervisor_env_worker_jobs_recovered", 0) >= 1
        _assert_accounting(rt)
        rts[pkg] = rt
    assert rts["port"].chaos.counts() == rts["jax"].chaos.counts()
    assert (_timing_free(rts["port"].rec.counters_snapshot())
            == _timing_free(rts["jax"].rec.counters_snapshot()))
    assert rts["port"].row_accounting() == rts["jax"].row_accounting()
    eng = rts["port"].cengine
    assert all(w.death_event is None and not w.stranded
               for w in eng._workers)


def test_runtime_transient_tool_errors_are_bit_identical(weights,
                                                         force_calls):
    """Transient tool faults that retry to success leave rewards and the
    trained adapters bit-identical to the fault-free run; the JAX runtime
    gives the same rewards and fault counts."""
    base = _chaos_runtime(weights, chaos=None)
    base.run(timeout_s=300.0)
    assert base.error is None and all(st.done
                                      for st in base.mgr.tasks.values())
    transient = dict(seed=0, tool_error_transient=1.0,
                     transient_fail_count=1, max_faults_per_site=2)
    faulty = _chaos_runtime(weights, chaos=transient)
    faulty.run(timeout_s=300.0)
    assert faulty.error is None
    assert all(st.done for st in faulty.mgr.tasks.values())
    assert faulty.chaos.counts().get("tool_error_transient") == 2
    assert faulty.rec.counters_snapshot().get("env_retries", 0) >= 1
    for tid in ("hop", "gsm"):
        a, b = base.mgr.state(tid), faulty.mgr.state(tid)
        assert a.reward_history == b.reward_history
        for x, y in zip(tree_leaves(a.adapters), tree_leaves(b.adapters)):
            assert torch.equal(x, y)
    _assert_accounting(base)
    _assert_accounting(faulty)
    jrt = _chaos_runtime(weights, "jax", chaos=transient)
    jrt.run(timeout_s=300.0)
    assert jrt.error is None
    assert jrt.chaos.counts() == faulty.chaos.counts()
    for tid in ("hop", "gsm"):
        assert (jrt.mgr.state(tid).reward_history
                == faulty.mgr.state(tid).reward_history)
    assert jrt.row_accounting() == faulty.row_accounting()


def test_runtime_quarantine_recovers_after_transient_outage(weights,
                                                            force_calls):
    rt = _chaos_runtime(weights, chaos=dict(
        seed=0, tool_error_permanent=1.0, max_faults_per_site=1),
        breaker_fail_threshold=1, breaker_cooldown_s=0.2,
        breaker_max_trips=3)
    rt.run(timeout_s=300.0)
    assert rt.error is None
    assert all(st.done for st in rt.mgr.tasks.values())
    assert not rt.mgr.tasks["hop"].abandoned
    assert rt.mgr.tasks["hop"].steps_done == 2
    assert rt.breaker.state("hop") == CLOSED
    c = rt.rec.counters_snapshot()
    assert c.get("quarantine_trips", 0) >= 1
    assert c.get("quarantine_recoveries", 0) >= 1
    states = [s for _, _, s in rt.rec.breaker_timeline("hop")]
    assert states[:3] == [OPEN, HALF_OPEN, CLOSED]
    assert rt.mgr.drop_counters()["failed_rows"] >= 1
    _assert_accounting(rt)


def test_runtime_abandons_tenant_with_persistent_tool_outage(weights,
                                                             force_calls):
    rt = _chaos_runtime(weights, chaos=dict(seed=0, tool_error_permanent=1.0),
                        breaker_fail_threshold=1, breaker_max_trips=0)
    rt.run(timeout_s=300.0)
    assert rt.error is None
    assert all(st.done for st in rt.mgr.tasks.values())
    assert rt.mgr.tasks["hop"].abandoned
    assert rt.mgr.tasks["hop"].steps_done < 2
    assert rt.mgr.tasks["gsm"].steps_done == 2
    assert not rt.mgr.tasks["gsm"].abandoned
    assert rt.breaker.state("hop") == ABANDONED
    assert rt.rec.counters_snapshot().get("quarantine_abandoned", 0) >= 1
    assert rt.mgr.drop_counters()["failed_rows"] >= 1
    _assert_accounting(rt)


# -- restart from a checkpoint ---------------------------------------------

def test_failure_restart_resumes_exactly(weights, tmp_path):
    """``tests/test_integration.py::test_failure_restart_resumes_exactly`` on
    the port: crash after two commits, restore the snapshot into a fresh
    runtime by hand, finish at the target."""
    _, pcfg, _, pparams, _ = weights
    ckpt = str(tmp_path / "ckpt")
    specs = [dict(task_id="gsm-0", env_name="gsm8k", group_size=2,
                  num_groups=1, max_new_tokens=4, target_steps=3),
             dict(task_id="amc-0", env_name="amc12", group_size=2,
                  num_groups=1, max_new_tokens=6, target_steps=3)]
    rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy="marlaas", max_len=48, seed=2, device="cpu",
        checkpoint_dir=ckpt, checkpoint_every=1),
        failure=FailureInjector(fail_after_commits=2))
    for s in specs:
        rt.submit_task(p_mgr.TaskSpec(**s))
    with pytest.raises(RuntimeError, match="injected node failure"):
        rt.run(timeout_s=300)
    assert p_store.latest_checkpoint(ckpt) is not None
    rt2 = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy="marlaas", max_len=48, seed=3, device="cpu"))
    p_store.load_checkpoint(p_store.latest_checkpoint(ckpt), rt2.mgr)
    pre_steps = sum(st.steps_done for st in rt2.mgr.tasks.values())
    assert pre_steps >= 1
    for tid, st in rt2.mgr.tasks.items():
        st.adapters = bridge.lora_from_jax(st.adapters, "cpu")
        st.opt_state = bridge.lora_from_jax(st.opt_state, "cpu")
        rt2.envs[tid] = P_ENVS[st.spec.env_name]()
        rt2.datagens[tid] = random.Random(7)
    rt2.run(timeout_s=300)
    assert rt2.mgr.all_done()
    for st in rt2.mgr.tasks.values():
        assert st.steps_done == st.spec.target_steps


def _record_all_commits(monkeypatch, mod, to_numpy, out):
    """Every commit of every manager of one package, in order:
    {tenant: [(step, (adapters before, adapters after, m, v)), ...]}, with
    AdamW's step counter after the commit."""
    orig = mod.MultiTaskManager.commit

    def record(self, tid, adapters, opt, version, **kw):
        trees = (self.state(tid).adapters, adapters, opt["m"], opt["v"])
        out.setdefault(tid, []).append(
            (int(np.asarray(to_numpy(opt["step"]))),
             tuple(_flat(to_numpy(t)) for t in trees)))
        return orig(self, tid, adapters, opt, version, **kw)

    monkeypatch.setattr(mod.MultiTaskManager, "commit", record)


def test_sync_restart_matches_reference(weights, tmp_path, monkeypatch):
    """``multilora_sync`` with two tenants crashes after its second commit
    and ``run_with_recovery`` restarts it from the newest snapshot, in both
    packages: one restart each, the port's adopted trees bit-equal to its
    snapshot, equal versions and reward histories, and every commit within
    ``tests/test_torch_runtime.py``'s tolerances of the JAX runtime's."""
    jcfg, pcfg, jparams, pparams, trees = weights
    # the restarted runtime builds its envs with make_env: graded alike
    monkeypatch.setattr(j_rt_mod, "make_env",
                        lambda name: _graded(J_ENVS, name))
    monkeypatch.setattr(p_rt_mod, "make_env",
                        lambda name: _graded(P_ENVS, name))
    commits = {"jax": {}, "port": {}}
    _record_all_commits(monkeypatch, j_mgr,
                        lambda t: jax.tree.map(np.asarray, t), commits["jax"])
    _record_all_commits(monkeypatch, p_mgr, bridge.to_numpy, commits["port"])
    adopted = []
    p_adopt = p_rt_mod.MARLaaSRuntime.adopt_checkpoint
    j_adopt = j_rt_mod.MARLaaSRuntime.adopt_checkpoint

    def pin(rt):
        # the runtimes reseed each prompt stream from the salted str hash:
        # pinned again, as before the crash
        for i, s in enumerate(SPECS):
            rt.datagens[s["task_id"]] = random.Random(200 + i)

    def adopt(self, path):
        p_adopt(self, path)
        for tid, st in self.mgr.task_items():
            for tree, name in ((st.adapters, "adapters"),
                               (st.opt_state, "opt")):
                _leaves_equal(bridge.to_numpy(tree), j_store.flat_to_tree(
                    dict(np.load(os.path.join(path, f"{tid}_{name}.npz")))))
        pin(self)
        adopted.append(path)

    def j_adopt_pinned(self, path):
        j_adopt(self, path)
        pin(self)

    monkeypatch.setattr(p_rt_mod.MARLaaSRuntime, "adopt_checkpoint", adopt)
    monkeypatch.setattr(j_rt_mod.MARLaaSRuntime, "adopt_checkpoint",
                        j_adopt_pinned)
    out = {}
    for pkg in ("jax", "port"):
        ckpt = str(tmp_path / pkg)
        kw = dict(policy="multilora_sync", max_len=48, seed=3,
                  checkpoint_dir=ckpt, checkpoint_every=1,
                  checkpoint_keep_last=2)
        if pkg == "jax":
            rt = JRuntime(jcfg, jparams, JConfig(use_kernel=False, **kw),
                          failure=JFailure(fail_after_commits=2))
        else:
            rt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
                device="cpu", **kw), failure=FailureInjector(
                    fail_after_commits=2))
        for i, s in enumerate(SPECS):
            if pkg == "jax":
                spec = j_mgr.TaskSpec(**s)
                jad = jax.tree.map(jnp.asarray, trees[i])
                rt.submit_task(spec, jad, j_init_opt(
                    jcfg, JTrainConfig(group_size=spec.group_size),
                    jparams, jad))
                rt.envs[s["task_id"]] = _graded(J_ENVS, s["env_name"])
            else:
                spec = p_mgr.TaskSpec(**s)
                jad = jax.tree.map(jnp.asarray, trees[i])
                jopt = j_init_opt(jcfg, JTrainConfig(
                    group_size=spec.group_size), jparams, jad)
                rt.submit_task(spec, bridge.lora_from_jax(trees[i], "cpu"),
                               bridge.lora_from_jax(
                                   jax.tree.map(np.asarray, jopt), "cpu"))
                rt.envs[s["task_id"]] = _graded(P_ENVS, s["env_name"])
            rt.datagens[s["task_id"]] = random.Random(100 + i)
        fin = rt.run_with_recovery(timeout_s=300)
        assert fin is not rt and fin.mgr.all_done()
        assert fin.rec.counters_snapshot().get("checkpoint_restarts") == 1
        out[pkg] = fin
        snaps = [n for n in os.listdir(ckpt)
                 if os.path.isdir(os.path.join(ckpt, n))]
        assert len(snaps) == 2           # checkpoint_keep_last
    assert len(adopted) == 1
    jfin, pfin = out["jax"], out["port"]
    for tid, jst in jfin.mgr.task_items():
        pst = pfin.mgr.state(tid)
        assert (pst.version, pst.steps_done) == (jst.version,
                                                 jst.steps_done) == (2, 2)
        assert pst.reward_history == jst.reward_history
        pc, jc = commits["port"][tid], commits["jax"][tid]
        # a commit lost to the crash is made again after the restart: a
        # first step (AdamW step 1) from the initial tree, or a later one
        # from the snapshot's, in both packages alike
        assert [t for t, _ in pc] == [t for t, _ in jc]
        assert len(pc) >= 2 and pc[-1][0] == 2
        for (t, got), (_, want) in zip(pc, jc):
            if t == 1:
                _assert_first_step(got[1], want[1], want[2])
            else:
                _assert_later_step(got, want, t)
        init = trees[[s["task_id"] for s in SPECS].index(tid)]
        _assert_final(pst, jst, [c for _, c in pc], _flat(init))
    assert pfin.row_accounting() == jfin.row_accounting()
