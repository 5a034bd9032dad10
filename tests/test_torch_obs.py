"""The port's episode tracing (``repro_torch.obs``) against the JAX
package's, on the CPU: ``tests/test_obs.py``'s scenarios on both packages.

1. The tracer and the report, each scenario written once and run on both
   packages' classes: components partition the end-to-end latency, the ring
   buffer counts drops, an untraced row costs nothing, the Chrome export's
   structure, the report's command line and its fault section. The scripted
   trace's exports are equal across the packages, key for key.
2. The traced engine (``tiny_lm()`` granite, bridged weights, env stage,
   agentic rows that CALL at token counter 2 through both packages'
   samplers, biased alike): every episode's state sequence and flow kinds,
   components within 1% of the end-to-end latency, and the sequences and
   flow kinds equal to the JAX engine's, episode by episode; the same
   canonical walk as the JAX package's virtual-time simulator; a traced
   engine runs the same forwards and gives the same tokens as an untraced
   one.
3. The traced runtime against the JAX runtime (one tenant, the
   round-synchronous trainer): each episode starts ``submitted`` and ends
   ``committed``, and the two runtimes' sequences are equal.
4. ``counters_snapshot`` and ``summarize`` of a zero-length run, on both
   packages."""
import dataclasses
import json
import random
import time
from types import SimpleNamespace

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
from repro import obs as j_obs
from repro.core import manager as j_mgr
from repro.core import metrics as j_met
from repro.core.runtime import MARLaaSRuntime as JRuntime
from repro.core.runtime import RuntimeConfig as JConfig
from repro.data import tokenizer as tok
from repro.envs.tasks import make_env
from repro.lora.adapters import init_lora
from repro.models import init_params
from repro.obs import report as j_report
from repro.rollout.engine import ContinuousRolloutEngine as JContinuous
from repro.rollout.engine import RolloutRequest as JRequest
from repro.rollout.engine import RolloutStats as JStats
from repro_torch import bridge
from repro_torch import obs as p_obs
from repro_torch.configs import REGISTRY as PT_REGISTRY, reduced as pt_reduced
from repro_torch.core import manager as p_mgr
from repro_torch.core import metrics as p_met
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.envs.tasks import make_env as pt_make_env
from repro_torch.obs import report as p_report
from repro_torch.rollout.engine import ContinuousRolloutEngine as PContinuous
from repro_torch.rollout.engine import RolloutRequest as PRequest
from repro_torch.rollout.engine import RolloutStats as PStats

CALL_AT = (2,)          # sampled-token counter that emits CALL (one park)
REF = SimpleNamespace(obs=j_obs, report=j_report, mgr=j_mgr, met=j_met,
                      Stats=JStats)
PORT = SimpleNamespace(obs=p_obs, report=p_report, mgr=p_mgr, met=p_met,
                       Stats=PStats)
PKGS = {"jax": REF, "port": PORT}


@pytest.fixture(scope="module", autouse=True)
def _biased_sampling():
    """Both packages' samplers return CALL at the CALL_AT counters and never
    EOS (remapped, so that rows run their full budget); undone after the
    module."""
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


# -- 1. tracer core, both packages -----------------------------------------

def _scripted_trace(tr):
    """One maximally-eventful episode: park/env/resume then train."""
    a = tr.new_trace("tenantA")
    tr.mark(a, "submitted", 0.0)
    tr.mark(a, "queued", 0.5)
    tr.mark(a, "prefill", 1.0)
    tr.mark(a, "decode", 2.0)
    fid = tr.next_flow("park")
    tr.span(("rollout", "slot-0"), "tenantA", 2.0, 3.0, trace=a,
            flow_out=fid)
    tr.mark(a, "parked", 3.0)
    tr.mark(a, "env", 3.25)
    rf = tr.next_flow("resume")
    tr.span(("env", "worker-0"), "tenantA", 3.25, 4.0, trace=a,
            flow_in=fid, flow_out=rf)
    tr.mark(a, "resume_queued", 4.0)
    tr.mark(a, "prefill", 4.25)
    tr.mark(a, "decode", 4.5)
    tr.span(("rollout", "slot-1"), "tenantA", 4.5, 5.0, trace=a,
            flow_in=rf)
    tr.mark(a, "completed", 5.0)
    tr.mark(a, "train", 5.5)
    tr.mark(a, "committed", 6.0)
    return a


@pytest.mark.parametrize("pkg", PKGS)
def test_components_partition_e2e(pkg):
    P = PKGS[pkg]
    tr = P.obs.Tracer()
    a = _scripted_trace(tr)
    info = tr.components()[a]
    assert info["terminal"] == "committed"
    assert info["task"] == "tenantA"
    assert sum(info["components"].values()) == pytest.approx(
        info["t1"] - info["t0"], abs=1e-12)
    assert info["components"]["prefill"] == pytest.approx(1.25)
    assert info["components"]["decode"] == pytest.approx(1.5)
    assert info["components"]["env"] == pytest.approx(0.75)
    assert set(info["components"]) <= set(P.obs.COMPONENT_OF.values())
    assert tr.state_sequence(a)[0] == "submitted"
    assert tr.state_sequence(a)[-1] in P.obs.TERMINAL_STATES
    assert tr.flow_kinds_of(a) == ["park", "resume"]


@pytest.mark.parametrize("pkg", PKGS)
def test_ring_buffer_overflow_counts_drops(pkg):
    tr = PKGS[pkg].obs.Tracer(capacity=4)
    a = tr.new_trace("t")
    for i in range(10):
        tr.mark(a, "queued", float(i))
    assert tr.dropped_events == 6
    assert len(tr.marks()[a]) == 4


@pytest.mark.parametrize("pkg", PKGS)
def test_mark_none_trace_is_noop(pkg):
    tr = PKGS[pkg].obs.Tracer()
    tr.mark(None, "decode", 1.0)
    assert tr.marks() == {}


@pytest.mark.parametrize("pkg", PKGS)
def test_export_chrome_structure(pkg):
    tr = PKGS[pkg].obs.Tracer()
    _scripted_trace(tr)
    tr.instant(("manager", "queue"), "stale_drop", 5.9)
    doc = tr.export_chrome()
    evs = doc["traceEvents"]
    procs = {e["args"]["name"] for e in evs
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert {"rollout", "env", "episodes", "manager"} <= procs
    threads = {e["args"]["name"] for e in evs
               if e["ph"] == "M" and e["name"] == "thread_name"}
    assert {"slot-0", "slot-1", "worker-0", "tenantA#0"} <= threads
    starts = {e["id"] for e in evs if e["ph"] == "s"}
    finishes = {e["id"] for e in evs if e["ph"] == "f"}
    assert starts and starts == finishes
    assert all(e["bp"] == "e" for e in evs if e["ph"] == "f")
    comp = [e for e in evs if e.get("cat") == "episode"]
    assert {e["name"] for e in comp} == {
        "admission_wait", "queue_wait", "prefill", "decode",
        "env_queue_wait", "env", "resume_wait", "completed_wait", "train"}
    assert all(e["args"]["terminal"] == "committed" for e in comp)
    assert any(e["ph"] == "i" for e in evs)
    assert doc["otherData"]["dropped_events"] == 0


def test_scripted_export_matches_reference():
    """The same calls give the same Chrome document in both packages."""
    docs = []
    for P in (PORT, REF):
        tr = P.obs.Tracer()
        _scripted_trace(tr)
        tr.instant(("manager", "queue"), "stale_drop", 5.9)
        docs.append(tr.export_chrome())
    assert docs[0] == docs[1]
    assert p_obs.COMPONENT_OF == j_obs.COMPONENT_OF
    assert p_obs.TERMINAL_STATES == j_obs.TERMINAL_STATES


@pytest.mark.parametrize("pkg", PKGS)
def test_report_cli(pkg, tmp_path):
    P = PKGS[pkg]
    tr = P.obs.Tracer()
    _scripted_trace(tr)
    p = tmp_path / "trace.json"
    out_json = tmp_path / "report.json"
    tr.dump_json(str(p))
    assert P.report.main([str(p), "--json", str(out_json)]) == 0
    rep = json.loads(out_json.read_text())
    assert rep["episodes"] == 1
    assert rep["max_relative_residual"] <= 1e-9
    ten = rep["tenants"]["tenantA"]
    assert ten["bottleneck"] == "decode"
    assert ten["e2e_p50"] == pytest.approx(6.0)


def test_report_load_faults_matches_reference():
    """``tests/test_chaos.py::test_report_load_faults_from_trace`` on both
    packages' reports."""
    trace = {"traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": 1, "tid": 5,
         "args": {"name": "supervisor:env_worker"}},
        {"ph": "i", "cat": "supervisor", "pid": 1, "tid": 5,
         "name": "restart", "ts": 0},
        {"ph": "i", "cat": "supervisor", "pid": 1, "tid": 5,
         "name": "restart", "ts": 1},
        {"ph": "i", "cat": "supervisor", "pid": 1, "tid": 9,
         "name": "hop:open", "ts": 2},
        {"ph": "i", "cat": "supervisor", "pid": 1, "tid": 9,
         "name": "hop:half_open", "ts": 3},
        {"ph": "i", "cat": "other", "pid": 1, "tid": 9,
         "name": "ignored", "ts": 4},
    ]}
    out = p_report.load_faults(trace)
    assert out["stage_restarts"] == {"supervisor:env_worker": 2}
    assert out["breaker_transitions"] == {"hop": ["open", "half_open"]}
    assert out == j_report.load_faults(trace)


def test_tracer_lock_is_named_apart_from_the_reference():
    """The lock analyzer names locks by class and attribute."""
    port, ref = p_obs.Tracer(), j_obs.Tracer()
    assert hasattr(port, "_trace_lock") and not hasattr(port, "_lock")
    assert hasattr(ref, "_lock") and not hasattr(ref, "_trace_lock")


# -- 2. the traced engine --------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """(JAX cfg, port cfg, JAX params, port params, JAX tree, port tree)."""
    jcfg = tiny_lm("granite-3-2b")
    pcfg = dataclasses.replace(pt_reduced(PT_REGISTRY["granite-3-2b"],
                                          dtype="float32"),
                               vocab_size=tok.VOCAB_SIZE)
    params = jax.tree.map(np.asarray, init_params(jax.random.PRNGKey(0), jcfg))
    tree = jax.tree.map(np.asarray, init_lora(jax.random.PRNGKey(1), jcfg))
    return (jcfg, pcfg, jax.tree.map(jnp.asarray, params),
            bridge.params_from_jax(params, pcfg, "cpu"),
            jax.tree.map(jnp.asarray, tree), bridge.lora_from_jax(tree, "cpu"))


def _agentic_requests(mk, Req):
    agentic = mk("hopsearch", kb_size=8, hops=2, seed=0)
    agentic.env_latency_mean = 0.0
    rng = random.Random(7)
    reqs = []
    for i in range(4):
        prompt, truth = agentic.sample_prompt(rng)
        reqs.append(Req("hop", 0, prompt, truth, agentic,
                        max_new_tokens=6, seed=i, max_turns=2))
    return reqs


_CACHE = {}


def _traced_engine_run(weights, pkg="port", traced=True):
    """``tests/test_obs.py::_traced_engine_run`` (engine-direct, env stage,
    2 slots, 4 agentic rows) on one package; (tracer, completions by submit
    index, engine)."""
    key = (pkg, traced)
    if key in _CACHE:
        return _CACHE[key]
    jcfg, pcfg, jparams, pparams, jtree, ptree = weights
    P = PKGS[pkg]
    tr = P.obs.Tracer() if traced else None
    kw = dict(max_slots=2, max_adapters=1, max_len=96, seed=0,
              env_stage=True, env_workers=2, tracer=tr)
    if pkg == "port":
        eng = PContinuous(pcfg, pparams, device="cpu", **kw)
        eng.set_adapters(0, ptree)
        reqs = _agentic_requests(pt_make_env, PRequest)
    else:
        eng = JContinuous(jcfg, jparams, **kw)
        eng.set_adapters(0, jtree)
        reqs = _agentic_requests(make_env, JRequest)
    for r in reqs:
        eng.submit(r)
    comps = {}
    deadline = time.monotonic() + 120
    while not eng.idle() and time.monotonic() < deadline:
        progressed = eng.step()
        for c in eng.drain_completions():
            comps[c.submit_index] = c
        if not progressed:
            time.sleep(0.0005)
    assert len(comps) == len(reqs)
    eng._env.halt()
    _CACHE[key] = (tr, comps, eng)
    return _CACHE[key]


def test_threaded_engine_traces_every_episode(weights):
    """``tests/test_obs.py``'s assertions on the port's engine."""
    tr, comps, _ = _traced_engine_run(weights)
    infos = tr.components()
    assert len(infos) == len(comps)
    for trace, info in infos.items():
        seq = tr.state_sequence(trace)
        assert seq[0] == "queued"
        assert seq[-1] == "completed"
        assert "decode" in seq
        n_parks = seq.count("parked")
        assert n_parks >= 1
        for i, s in enumerate(seq):
            if s == "parked":
                assert seq[i + 1] == "env"
                assert seq[i + 2] == "resume_queued"
        assert tr.flow_kinds_of(trace) == ["park", "resume"] * n_parks
        e2e = info["t1"] - info["t0"]
        assert e2e > 0
        assert sum(info["components"].values()) == pytest.approx(
            e2e, rel=0.01)
        assert info["components"]["env"] > 0.0


def test_engine_traces_match_reference(weights):
    """Episode by episode (trace ids follow submission order in both
    engines): the same state sequences and flow kinds as the JAX engine,
    and the same tokens."""
    ptr, pcomps, _ = _traced_engine_run(weights, "port")
    jtr, jcomps, _ = _traced_engine_run(weights, "jax")
    assert sorted(ptr.components()) == sorted(jtr.components())
    for trace in ptr.components():
        assert ptr.state_sequence(trace) == jtr.state_sequence(trace)
        assert ptr.flow_kinds_of(trace) == jtr.flow_kinds_of(trace)
        assert ptr.task_of(trace) == jtr.task_of(trace)
    for i in pcomps:
        assert list(pcomps[i].tokens) == list(jcomps[i].tokens)


def _canon(seq):
    return [s for s in seq if s not in ("submitted", "ready", "train",
                                       "committed", "completed_wait")]


def test_trace_parity_threaded_vs_sim(weights):
    """The port's threaded traces have the span structure of the JAX
    package's virtual-time simulator (plain Python): the same canonical
    state sequence and flow-kind chain for an episode with the same number
    of tool calls."""
    from repro.configs import get_config
    from repro.core.simulator import (HardwareModel, Simulator,
                                      WorkloadModel)
    tr, _, _ = _traced_engine_run(weights)
    trace = min(tr.components())
    thr_seq = _canon(tr.state_sequence(trace))
    n_calls = thr_seq.count("parked")
    sim = Simulator(get_config("qwen3-0.6b"), HardwareModel(), trace=True)
    wl = WorkloadModel(prompt_len=64, gen_len=128, rows=4,
                       n_tool_calls=n_calls, env_latency_mean=3.0)
    done = []
    sim.submit_rollout(j_mgr.TaskSpec("hop", "search"), wl, 0,
                       on_done=lambda: done.append(1))
    sim.run()
    assert done
    sim_trace = min(sim.tracer.components())
    assert _canon(sim.tracer.state_sequence(sim_trace)) == thr_seq
    assert (sim.tracer.flow_kinds_of(sim_trace)
            == tr.flow_kinds_of(trace))


def test_threaded_chrome_export_loads_in_report(weights):
    tr, _, _ = _traced_engine_run(weights)
    doc = tr.export_chrome()
    res = p_report.analyze(p_report.load_episodes(doc))
    assert res["episodes"] == len(tr.components())
    assert res["max_relative_residual"] <= 0.01
    assert res["tenants"]["hop"]["bottleneck"]
    # the JAX report reads the port's export alike
    assert j_report.analyze(j_report.load_episodes(doc))["episodes"] \
        == res["episodes"]


def test_tracing_changes_no_forward_and_no_token(weights):
    """A traced engine runs the forwards an untraced one runs (on the card,
    each forward's launches are fixed: ``chip_smoke.py`` phase 13 counts
    them) and samples the same tokens."""
    _, traced, teng = _traced_engine_run(weights, traced=True)
    _, plain, peng = _traced_engine_run(weights, traced=False)
    assert ({k: c.n for k, c in teng.forward_counts.items()}
            == {k: c.n for k, c in peng.forward_counts.items()})
    assert teng.stats.decode_steps == peng.stats.decode_steps
    for i in traced:
        assert list(traced[i].tokens) == list(plain[i].tokens)
        assert traced[i].gen_logprobs == plain[i].gen_logprobs


# -- 3. the traced runtime -------------------------------------------------

def _graded(mk, name):
    base = type(mk(name))

    class Graded(base):
        def verify(self, truth, completion_ids):
            comp = list(completion_ids)
            return sum(t % 2 == 0 for t in comp) / max(1, len(comp))

    return Graded()


def test_traced_runtime_matches_reference(weights):
    """One gsm8k tenant, two round-synchronous commits, traced in both
    runtimes: every episode starts ``submitted``, ends ``committed``, its
    components sum to its latency within 1%, and the sequences equal the
    JAX runtime's."""
    jcfg, pcfg, jparams, pparams, jtree, ptree = weights
    spec = dict(task_id="gsm-0", env_name="gsm8k", group_size=2,
                num_groups=1, max_new_tokens=5, target_steps=2)
    jrt = JRuntime(jcfg, jparams, JConfig(policy="marlaas", max_len=48,
                                          seed=3, use_kernel=False,
                                          trace=True))
    prt = MARLaaSRuntime(pcfg, pparams, RuntimeConfig(
        policy="marlaas", max_len=48, seed=3, device="cpu", trace=True))
    jrt.submit_task(j_mgr.TaskSpec(**spec), jtree)
    prt.submit_task(p_mgr.TaskSpec(**spec), ptree)
    for rt, mk in ((jrt, make_env), (prt, pt_make_env)):
        rt.envs["gsm-0"] = _graded(mk, "gsm8k")
        rt.datagens["gsm-0"] = random.Random(100)
        rt.run(timeout_s=300)
    assert prt.tracer is not None and prt.cengine._tracer is prt.tracer
    assert prt.mgr.tracer is prt.tracer
    pinfo, jinfo = prt.tracer.components(), jrt.tracer.components()
    assert len(pinfo) == len(jinfo) == 4
    for trace, info in pinfo.items():
        seq = prt.tracer.state_sequence(trace)
        assert seq[0] == "submitted" and seq[-1] == "committed"
        assert seq == jrt.tracer.state_sequence(trace)
        assert sum(info["components"].values()) == pytest.approx(
            info["t1"] - info["t0"], rel=0.01)
    assert prt.mgr.state("gsm-0").reward_history \
        == jrt.mgr.state("gsm-0").reward_history


# -- 4. satellites, both packages -------------------------------------------

@pytest.mark.parametrize("pkg", PKGS)
def test_counters_snapshot_merges_rollout_stats(pkg):
    P = PKGS[pkg]
    rec = P.met.MetricsRecorder({"rollout": 1})
    stats = P.Stats()
    stats.parks = 3
    stats.preemptions = 7
    stats.decode_seconds = 4.2
    rec.attach_rollout_stats(stats)
    rec.incr("preemptions")
    snap = rec.counters_snapshot()
    assert snap["parks"] == 3
    assert snap["preemptions"] == 1
    assert "decode_seconds" not in snap
    assert "completions" not in snap
    stats.parks = 5
    assert rec.counters_snapshot()["parks"] == 5
    out = P.met.summarize(P.mgr.MultiTaskManager(), rec)
    assert out["n_parks"] == 5.0
    assert out["n_preemptions"] == 1.0


@pytest.mark.parametrize("pkg", PKGS)
def test_summarize_zero_length_run(pkg):
    P = PKGS[pkg]
    rec = P.met.MetricsRecorder({"rollout": 2, "train": 1})
    assert rec.utilization_pct() == 0.0
    assert rec.idle_pct() == 0.0
    assert rec.slot_utilization_pct() == 0.0
    assert rec._depth_stats([], ("a", "b")) == {}
    assert rec.counters_snapshot() == {}
    out = P.met.summarize(P.mgr.MultiTaskManager(), rec)
    assert out["span_s"] == 0.0
    assert out["utilization_pct"] == 0.0
    assert out["idle_pct"] == 0.0
    assert out["steps_per_hr"] == 0.0
    assert out["slot_util_pct"] == 0.0


def test_purged_tail_rows_end_dropped_in_the_port_only():
    """A fault of the JAX manager (ROADMAP §3): a commit that finishes a
    task purges its queued GRPO groups and partial rows and counts them as
    discarded tails, but the JAX manager leaves their traces at
    `completed`, so they never reach a terminal state. The port's manager
    marks them `dropped`, as its other drop paths do."""
    out = {}
    for pkg, P in PKGS.items():
        tr = P.obs.Tracer()
        m = P.mgr.MultiTaskManager(async_mode=True, max_staleness=1)
        m.tracer = tr
        m.submit(P.mgr.TaskSpec("t", "gsm8k", group_size=2, num_groups=1,
                                target_steps=1))
        m.admit("t")
        rows = []
        for i in range(3):          # a complete group, then one partial row
            trace = tr.new_trace("t")
            tr.mark(trace, "completed", float(i))
            rows.append(SimpleNamespace(version=0, submit_index=i,
                                        meta={"trace_id": trace}))
            m.enqueue_episode("t", 0, (1, i // 2), rows[-1])
        assert m.ready_rows("t") == 2 and m.partial_rows("t") == 1
        m.commit("t", None, None, 0)
        assert m.drop_counters()["discarded_tail_rows"] == 3
        out[pkg] = [tr.state_sequence(r.meta["trace_id"])[-1] for r in rows]
    assert out["port"] == ["dropped"] * 3
    assert out["jax"] == ["completed"] * 3
