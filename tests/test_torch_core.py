"""The port's copies of the runtime's plain-Python core (``repro_torch.core``
and ``lora.multilora.AdapterResidency``) against the JAX package's classes.

Each scenario below is one call sequence, written once and run on both
packages: the multi-task manager (``tests/test_core.py`` and the
manager-level cases of ``tests/test_async_train.py``: versioning, the FIFO
buffer, GRPO-group assembly, threshold rounding, staleness drops at enqueue
and at pop, the issue budget, the pop deadline under an unrelated wake-up,
``recover_inflight``), admission (decisions and byte charges, dense and
paged), the tenant circuit breaker under a fake clock
(``tests/test_chaos.py:80-137``), the adapter residency's slots and
evictions, the chaos dice, and ``summarize`` over the same recorded
intervals. A scenario asserts what the reference test asserts and returns
every value it saw (return values, counters, ``drop_counters()``); the two
packages' lists must be equal, exactly (plain Python, no tolerance)."""
import dataclasses
import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as r_get_config
from repro.core import admission as r_adm
from repro.core import chaos as r_chaos
from repro.core import manager as r_mgr
from repro.core import metrics as r_met
from repro.core import supervisor as r_sup
from repro.lora.multilora import AdapterResidency as r_Residency
from repro.rl.types import TrajectoryBatch as r_TB
from repro_torch.configs import get_config as p_get_config
from repro_torch.core import admission as p_adm
from repro_torch.core import chaos as p_chaos
from repro_torch.core import manager as p_mgr
from repro_torch.core import metrics as p_met
from repro_torch.core import supervisor as p_sup
from repro_torch.lora.multilora import AdapterResidency as p_Residency
from repro_torch.rl.types import TrajectoryBatch as p_TB

REF = SimpleNamespace(mgr=r_mgr, adm=r_adm, met=r_met, sup=r_sup,
                      chaos=r_chaos, Residency=r_Residency, TB=r_TB,
                      get_config=r_get_config, cv=lambda m: m._cv)
PORT = SimpleNamespace(mgr=p_mgr, adm=p_adm, met=p_met, sup=p_sup,
                       chaos=p_chaos, Residency=p_Residency, TB=p_TB,
                       get_config=p_get_config, cv=lambda m: m._mgr_cv)


def _tb(P, tid, v, rows=2):
    z = np.zeros((rows, 4), np.float32)
    return P.TB(task_id=tid, version=v, tokens=z.astype(np.int32),
                prompt_lens=np.ones(rows, np.int32),
                total_lens=np.full(rows, 3, np.int32),
                rewards=np.zeros(rows, np.float32), group_size=2)


def _ep(version, submit_index):
    return SimpleNamespace(version=version, submit_index=submit_index)


def _amgr(P, **kw):
    m = P.mgr.MultiTaskManager(async_mode=True, **kw)
    m.submit(P.mgr.TaskSpec("t", "gsm8k", group_size=2, num_groups=2,
                            target_steps=100))
    m.admit("t")
    return m


def _groups(item):
    if item is None:
        return None
    tid, groups = item
    return tid, [(g.version, g.seq, [r.submit_index for r in g.rows])
                 for g in groups]


# -- manager: tests/test_core.py ------------------------------------------

def sc_next_policy_issued_once_per_version(P):
    m = P.mgr.MultiTaskManager()
    m.submit(P.mgr.TaskSpec("t", "gsm8k", target_steps=2))
    m.admit("t")
    out = [m.next_policy("t"), m.next_policy("t")]
    assert out == [(0, None), None]
    m.enqueue(_tb(P, "t", 0))
    b = m.pop_batch()
    m.commit("t", None, None, b.version)
    out.append(m.next_policy("t"))
    assert out[-1] == (1, None)
    return out + [m.drop_counters()]


def sc_stale_trajectory_dropped_and_counted(P):
    m = P.mgr.MultiTaskManager()
    m.submit(P.mgr.TaskSpec("t", "gsm8k"))
    m.admit("t")
    m.next_policy("t")
    m.enqueue(_tb(P, "t", 0))
    m.pop_batch()
    m.commit("t", None, None, 0)
    out = [m.enqueue(_tb(P, "t", 0)), m.pop_batch(), m.drop_counters()]
    assert out[:2] == [False, None]
    assert out[2]["stale_batches_dropped"] == 1
    assert out[2]["stale_rows_dropped"] == 2
    return out


def sc_stale_batch_within_window_admitted(P):
    m = P.mgr.MultiTaskManager(max_staleness=1, async_mode=True)
    m.submit(P.mgr.TaskSpec("t", "gsm8k"))
    m.admit("t")
    m.next_policy("t")
    m.enqueue(_tb(P, "t", 0))
    m.commit("t", None, None, 0)
    out = [m.enqueue(_tb(P, "t", 0))]
    b = m.pop_batch()
    m.commit("t", None, None, b.version)
    out += [b.version, m.tasks["t"].version, m.drop_counters()]
    assert out[0] is True and out[2] == 2
    return out


def sc_commit_wrong_version_rejected(P):
    m = P.mgr.MultiTaskManager()
    m.submit(P.mgr.TaskSpec("t", "gsm8k"))
    m.admit("t")
    with pytest.raises(AssertionError):
        m.commit("t", None, None, 3)
    return [m.tasks["t"].version, m.tasks["t"].steps_done]


def sc_buffer_fifo_across_tasks(P):
    m = P.mgr.MultiTaskManager()
    for tid in ("a", "b", "c"):
        m.submit(P.mgr.TaskSpec(tid, "gsm8k"))
        m.admit(tid)
        m.next_policy(tid)
    for tid in ("b", "a", "c"):
        m.enqueue(_tb(P, tid, 0))
    order = [m.pop_batch().task_id for _ in range(3)]
    assert order == ["b", "a", "c"]
    return order + [m.dispatchable_rows()]


def sc_task_finishes_at_target_steps(P):
    m = P.mgr.MultiTaskManager()
    m.submit(P.mgr.TaskSpec("t", "gsm8k", target_steps=2))
    m.admit("t")
    for v in range(2):
        m.next_policy("t")
        m.enqueue(_tb(P, "t", v))
        m.commit("t", None, None, v, reward_mean=0.25 * v)
    st = m.tasks["t"]
    out = [st.status, m.next_policy("t"), m.all_done(), st.reward_history,
           st.steps_done]
    assert out[:3] == ["finished", None, True]
    return out


def sc_preempt_readmit_and_quarantine(P):
    m = P.mgr.MultiTaskManager()
    for tid in ("a", "b"):
        m.submit(P.mgr.TaskSpec(tid, "gsm8k", target_steps=3))
        m.admit(tid)
    out = [m.rollout_ready_tasks()]
    m.preempt("a")
    out += [m.state("a").status, m.rollout_ready_tasks()]
    m.readmit("a")
    out += [m.state("a").status, m.rollout_ready_tasks()]
    m.quarantine("b")
    out += [m.state("b").status, m.rollout_ready_tasks()]
    m.next_policy("a")
    m.enqueue(_tb(P, "b", 0))          # a quarantined tenant's work drains
    out += [m.drain_tenant("b"), m.drop_counters()]
    m.unquarantine("b")
    out += [m.state("b").status, m.rollout_ready_tasks()]
    m.abandon("b")
    out += [m.state("b").status, m.state("b").done, m.all_done()]
    return out


# -- manager: tests/test_async_train.py:51-234 -----------------------------

def sc_episode_groups_assemble_in_submit_order(P):
    m = _amgr(P, max_staleness=1)
    out = [m.enqueue_episode("t", 0, (1, 0), _ep(0, 7)),
           m.partial_rows("t"), m.ready_rows("t"),
           m.enqueue_episode("t", 0, (1, 0), _ep(0, 3)),
           m.partial_rows("t"), m.ready_rows("t"), m.pop_episodes()]
    assert out == [True, 1, 0, True, 0, 2, None]
    m.enqueue_episode("t", 0, (1, 1), _ep(0, 4))
    m.enqueue_episode("t", 0, (1, 1), _ep(0, 9))
    got = _groups(m.pop_episodes())
    assert got[0] == "t" and [g[2] for g in got[1]] == [[3, 7], [4, 9]]
    return out + [got]


def sc_train_threshold_rounds_up_to_complete_groups(P):
    spec = P.mgr.TaskSpec("t", "gsm8k", group_size=4, num_groups=3)
    out = [P.mgr.MultiTaskManager(min_train_rows=n).train_threshold(spec)
           for n in (0, 1, 4, 5, 12, 13)]
    assert out[:4] == [12, 4, 4, 8]
    return out


def sc_stale_episode_dropped_at_enqueue(P):
    m = _amgr(P, max_staleness=0)
    m.enqueue_episode("t", 0, (1, 0), _ep(0, 0))
    m.tasks["t"].version = 1
    out = [m.enqueue_episode("t", 0, (1, 0), _ep(0, 1)), m.partial_rows("t"),
           m.ready_rows("t"), m.drop_counters(), m.pop_episodes()]
    assert out[0] is False and out[3]["stale_rows_dropped"] == 2
    assert out[3]["stale_groups_dropped"] == 1
    return out


def sc_stale_ready_group_pruned_at_pop(P):
    m = _amgr(P, max_staleness=0, min_train_rows=1)
    for i in range(2):
        m.enqueue_episode("t", 0, (1, 0), _ep(0, i))
    out = [m.ready_rows("t")]
    m.tasks["t"].version = 1
    out += [m.pop_episodes(), m.ready_rows("t"), m.drop_counters()]
    assert out[:3] == [2, None, 0] and out[3]["stale_rows_dropped"] == 2
    return out


def sc_within_window_episodes_train_and_commit(P):
    m = _amgr(P, max_staleness=1, min_train_rows=1)
    for i in range(2):
        m.enqueue_episode("t", 0, (1, 0), _ep(0, i))
    m.tasks["t"].version = 1
    out = [_groups(m.pop_episodes())]
    m.commit("t", None, None, trained_version=0)
    out += [m.version_of("t"), m.drop_counters()]
    assert out[1] == 2 and out[2]["stale_rows_dropped"] == 0
    return out


def sc_finished_task_purges_queues_and_counts_tail(P):
    m = P.mgr.MultiTaskManager(async_mode=True, max_staleness=2,
                               min_train_rows=1)
    m.submit(P.mgr.TaskSpec("t", "gsm8k", group_size=2, num_groups=2,
                            target_steps=1))
    m.admit("t")
    for i in range(2):
        m.enqueue_episode("t", 0, (1, 0), _ep(0, i))
    m.enqueue_episode("t", 0, (1, 1), _ep(0, 2))
    out = [_groups(m.pop_episodes())]
    m.commit("t", None, None, 0)
    out += [m.tasks["t"].status, m.ready_rows("t"), m.partial_rows("t"),
            m.drop_counters()["discarded_tail_rows"],
            m.enqueue_episode("t", 0, (1, 1), _ep(0, 3)),
            m.drop_counters()]
    assert out[1:6] == ["finished", 0, 0, 1, False]
    assert out[6]["discarded_tail_rows"] == 2
    return out


def sc_async_issue_budget_bounded_by_staleness_window(P):
    m = _amgr(P, max_staleness=1)
    out = [m.next_policy("t") is not None, m.next_policy("t") is not None,
           m.next_policy("t")]
    for g in range(2):
        for i in range(2):
            m.enqueue_episode("t", 0, (1, g), _ep(0, g * 2 + i))
    out.append(_groups(m.pop_episodes()))
    m.commit("t", None, None, 0)
    out.append(m.next_policy("t") is not None)
    assert out[:3] == [True, True, None] and out[-1] is True
    return out


def sc_fail_episode_and_round_failed(P):
    m = _amgr(P, max_staleness=1)
    m.next_policy("t")
    m.rollout_started("t", 4)
    m.enqueue_episode("t", 0, (1, 0), _ep(0, 0))
    m.fail_episode("t", (1, 0), _ep(0, 1))     # poisons its group
    for i in (2, 3):
        m.rollout_row_done("t")
    out = [m.partial_rows("t"), m.ready_rows("t"), m.drop_counters()]
    s = P.mgr.MultiTaskManager()
    s.submit(P.mgr.TaskSpec("u", "gsm8k"))
    s.admit("u")
    out.append(s.next_policy("u"))
    s.note_failed("u", 2)
    s.round_failed("u")
    out += [s.next_policy("u"), s.drop_counters()]
    return out


def sc_pop_batch_deadline_survives_unrelated_notify(P):
    m = P.mgr.MultiTaskManager()
    m.submit(P.mgr.TaskSpec("t", "gsm8k"))
    m.admit("t")
    m.next_policy("t")
    cv = P.cv(m)

    def wake_then_feed():
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        time.sleep(0.15)
        m.enqueue(_tb(P, "t", 0))

    t = threading.Thread(target=wake_then_feed)
    t.start()
    t0 = time.monotonic()
    tb = m.pop_batch(timeout=5.0)
    t.join()
    assert tb is not None, "spurious wake truncated the pop deadline"
    assert time.monotonic() - t0 < 4.0
    return [tb.task_id, tb.version]


def sc_pop_episodes_deadline_survives_unrelated_notify(P):
    m = _amgr(P, max_staleness=1, min_train_rows=1)
    cv = P.cv(m)

    def wake_then_feed():
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        time.sleep(0.15)
        for i in range(2):
            m.enqueue_episode("t", 0, (1, 0), _ep(0, i))

    t = threading.Thread(target=wake_then_feed)
    t.start()
    item = m.pop_episodes(timeout=5.0)
    t.join()
    assert item is not None, "spurious wake truncated the pop deadline"
    return [_groups(item)]


def sc_recover_inflight_restores_popped_batch(P):
    m = P.mgr.MultiTaskManager()
    m.submit(P.mgr.TaskSpec("t", "gsm8k"))
    m.admit("t")
    m.next_policy("t")
    m.enqueue(_tb(P, "t", 0))
    first = m.pop_batch()
    out = [m.pop_batch(), m.recover_inflight()]
    again = m.pop_batch()
    assert again is first
    m.commit("t", None, None, 0)
    out.append(m.recover_inflight())
    assert out == [None, 1, 0]
    return out


def sc_recover_inflight_restores_popped_episode_groups(P):
    m = _amgr(P, max_staleness=1, min_train_rows=1)
    for g in range(2):
        for i in range(2):
            m.enqueue_episode("t", 0, (1, g), _ep(0, g * 2 + i))
    first = _groups(m.pop_episodes())
    out = [first, m.ready_rows("t"), m.recover_inflight(), m.ready_rows("t")]
    again = _groups(m.pop_episodes())
    assert out[1:] == [2, 1, 4] and again[1][0][1] == first[1][0][1]
    return out + [again]


# -- admission ------------------------------------------------------------

def sc_admission_budget(P):
    cfg = P.get_config("granite-3-2b")
    spec = lambda tid: P.mgr.TaskSpec(tid, "gsm8k", group_size=4,  # noqa: E731
                                      num_groups=2, max_new_tokens=64)
    need = P.adm.task_state_bytes(cfg, spec("t0"), prompt_len=64)
    assert need > 0
    ac = P.adm.AdmissionController(cfg, P.adm.AdmissionConfig(
        memory_budget_bytes=2.5 * need, strict=True))
    out = [need, ac.try_admit(spec("a")), ac.try_admit(spec("b")),
           ac.try_admit(spec("c"))]
    ac.release("a")
    out += [ac.try_admit(spec("c")), ac.used_bytes, sorted(ac.admitted())]
    assert out[1:5] == [True, True, False, True]
    return out


def sc_admission_ssm_is_length_independent(P):
    ssm, att = P.get_config("mamba2-780m"), P.get_config("granite-3-2b")
    short = P.mgr.TaskSpec("s", "gsm8k", max_new_tokens=8)
    long = P.mgr.TaskSpec("l", "gsm8k", max_new_tokens=2048)
    out = [P.adm.task_state_bytes(c, s, 64) for c in (ssm, att)
           for s in (short, long)]
    assert out[0] == out[1] and out[3] > out[2]
    return out


@pytest.mark.parametrize("paged", [False, True])
def test_admission_sequence_matches_reference(paged):
    """Decisions and byte charges of one admit / preempt / re-estimate /
    readmit / quarantine sequence, dense and page-granular."""
    def run(P):
        cfg = P.get_config("qwen3-0.6b")
        specs = [P.mgr.TaskSpec(f"t{i}", "gsm8k", group_size=4,
                                num_groups=2, max_new_tokens=32 * (i + 1),
                                priority=i % 2) for i in range(4)]
        one = P.adm.task_state_bytes(cfg, specs[1], 32)
        ac = P.adm.AdmissionController(cfg, P.adm.AdmissionConfig(
            memory_budget_bytes=3 * one, strict=True, paged=paged,
            page_size=16))
        out = [ac.try_admit(s, 32, 20.0 if paged else None) for s in specs]
        out += [ac.used_bytes, ac.admitted_bytes("t0"), ac.preempt("t0"),
                ac.used_bytes, sorted(ac.preempted())]
        ac.reestimate_preempted("t0", specs[0], 12.0, 32)
        out += [ac.try_readmit("t0"), ac.used_bytes, ac.quarantine("t1"),
                ac.try_unquarantine("t1"), ac.used_bytes]
        ac.reestimate_preempted_bytes("t0", 4096)
        ac.release("t2")
        out += [ac.try_readmit("t0"), ac.used_bytes, sorted(ac.admitted()),
                ac.workload_bytes(8, 64)]
        out += [P.adm.task_state_bytes_paged(cfg, s, 32, 2, 16, 10.0)
                for s in specs]
        out += [P.adm.task_state_bytes_shared(cfg, s, 32, 2, 16)
                for s in specs]
        out += [P.adm.task_state_bytes_remaining(cfg, s, 32, 2, 5.0)
                for s in specs]
        return out
    assert run(PORT) == run(REF)


# -- circuit breaker: tests/test_chaos.py:80-137 ---------------------------

def sc_breaker_trips_cools_down_and_recovers(P):
    S = P.sup
    now = [0.0]
    b = S.TenantBreaker(fail_threshold=2, cooldown_s=1.0, max_trips=3,
                        clock=lambda: now[0])
    b.record_failure("t")
    out = [b.poll(), b.state("t")]
    b.record_success("t")
    b.record_failure("t")
    b.record_failure("t")
    out += [b.poll(), b.state("t"), b.poll()]
    now[0] = 1.5
    out.append(b.poll())
    b.record_success("t")
    out += [b.poll(), b.snapshot()]
    assert out == [[], S.CLOSED, [("t", S.OPEN)], S.OPEN, [],
                   [("t", S.HALF_OPEN)], [("t", S.CLOSED)], {}]
    return out


def sc_breaker_retrip_abandon_and_straggler_noop(P):
    S = P.sup
    now = [0.0]
    b = S.TenantBreaker(fail_threshold=1, cooldown_s=1.0, max_trips=1,
                        clock=lambda: now[0])
    b.record_failure("t")
    out = [b.poll()]
    b.record_failure("t")
    b.record_failure("t")
    out.append(b.poll())
    now[0] = 2.0
    out.append(b.poll())
    b.record_failure("t")
    out.append(b.poll())
    b.record_failure("t")
    b.record_success("t")
    out += [b.poll(), b.state("t"), b.snapshot()]
    assert out == [[("t", S.OPEN)], [], [("t", S.HALF_OPEN)],
                   [("t", S.ABANDONED)], [], S.ABANDONED,
                   {"t": S.ABANDONED}]
    return out


def sc_breaker_abandons_immediately_with_zero_trip_budget(P):
    b = P.sup.TenantBreaker(fail_threshold=1, cooldown_s=1.0, max_trips=0)
    b.record_failure("t")
    out = [b.poll()]
    assert out == [[("t", P.sup.ABANDONED)]]
    return out


def sc_stage_supervisor_restarts_then_escalates(P):
    now = [0.0]
    alive = [False]
    sv = P.sup.StageSupervisor(clock=lambda: now[0])
    sv.register("w", healthy=lambda: alive[0], restart=lambda: None,
                recover=lambda: 2,
                policy=P.sup.StagePolicy(max_restarts=2, backoff_base_s=1.0,
                                         backoff_max_s=4.0))
    out = []
    for t in (0.0, 0.5, 1.0, 3.5):
        now[0] = t
        try:
            out.append(sv.tick())
        except RuntimeError as e:
            out.append(str(e))
    out.append(dict(sv.counters))
    assert "escalating" in out[-2]
    return out


def sc_chaos_dice(P):
    C = P.chaos
    inj = C.ChaosInjector(C.ChaosConfig(seed=3, tool_error_transient=0.5,
                                        snapshot_drop=1.0,
                                        max_faults_per_site=2))
    out = [[inj.fire(s) for _ in range(6)] for s in C.SITES]
    out += [inj.counts(), C.ChaosConfig().enabled,
            C.ChaosConfig(torn_checkpoint=0.1).enabled]
    with pytest.raises(ValueError):
        inj.fire("not_a_site")
    return out


# -- adapter residency ----------------------------------------------------

def sc_adapter_residency_lru(P):
    installs, evicts = [], []
    res = P.Residency(3, lambda slot, tree: installs.append((slot, tree)),
                      on_evict=lambda t, s: evicts.append((t, s)))
    pinned = {"b"}
    out = []
    for t in ("a", "b", "c", "a", "d", "e", "b", "f", "c"):
        out.append(res.acquire(t, f"tree-{t}", in_use=lambda x: x in pinned))
        out.append(res.resident())
    pinned = {"a", "b", "c", "d", "e", "f"}
    out.append(res.acquire("g", "tree-g", in_use=lambda x: x in pinned))
    out += [res.evict("b"), res.evict("zz"), res.slot_of("c"), "c" in res,
            res.installs, res.evictions, res.hits, installs, evicts]
    with pytest.raises(ValueError):
        P.Residency(0, lambda s, t: None)
    return out


# -- metrics --------------------------------------------------------------

def sc_metrics_util_and_idle(P):
    rec = P.met.MetricsRecorder({"rollout": 4, "train": 1})
    rec.record("rollout", "decode", "t", 0.0, 10.0, 4)
    rec.record("train", "train", "t", 10.0, 20.0, 1)
    out = [rec.span(), rec.utilization_pct(), rec.idle_pct()]
    assert out[0] == 20.0 and 0 < out[1] < 100
    assert abs(out[2] - 50.0) < 1e-6
    return out


@dataclasses.dataclass
class _Stats:
    """Engine counters as ``attach_rollout_stats`` reads them."""
    decode_steps: int = 0
    refills: int = 0
    decode_seconds: float = 0.0


def sc_summarize_recorded_run(P):
    """A manager and a recorder fed the same timeline: decode, prefill and
    splice intervals of fused tenants, train intervals, slot, queue, page
    and breaker samples, trainer waits and backlog, counters."""
    m = P.mgr.MultiTaskManager(clock=lambda: 0.0)
    rec = P.met.MetricsRecorder({"rollout": 1, "train": 1})
    for i, tid in enumerate(("a", "b")):
        m.submit(P.mgr.TaskSpec(tid, "gsm8k", target_steps=2))
        m.admit(tid)
    t = 0.0
    for step in range(2):
        for tid in ("a", "b"):
            rec.record("rollout", "prefill", tid, t, t + 0.1)
            rec.record("rollout", "decode", "a+b", t + 0.1, t + 1.3)
            rec.record_slot_sample(t, 3 + step, 8)
            rec.record_queue_sample(t, 2, 0)
            rec.record_page_sample(t, 10 + step, 64, 0.25)
            rec.record_trainer_wait(t, t + 0.4)
            rec.record_train_backlog(t + 0.5, 4)
            rec.record("train", "train", tid, t + 0.9, t + 1.7)
            m.next_policy(tid)
            m.enqueue(_tb(P, tid, step))
            m.pop_batch()
            m.tasks[tid].submitted_at = 0.0
            m.clock = (lambda v: (lambda: v))(t + 1.7)
            m.commit(tid, None, None, step, reward_mean=0.1 * step)
            rec.record_train_backlog(t + 1.7, 0)
            t += 1.0
    rec.record("rollout", "splice", "b", 0.2, 0.25)
    rec.record("rollout", "env", "a", 0.3, 0.9)
    rec.record_breaker_sample(1.0, "b", "open")
    rec.incr("preemptions", 2)
    rec.incr("kv_shared_pages", 5)
    rec.attach_rollout_stats(_Stats(decode_steps=17, refills=3,
                                    decode_seconds=1.5))
    s = P.met.summarize(m, rec)
    return [s, rec.trainer_idle_stats(), rec.page_pool_stats(),
            rec.queue_depth_stats(), rec.breaker_timeline("b"),
            rec.env_wait_seconds(), rec.env_busy_seconds(),
            rec.counters_snapshot(), sorted(P.met.PHASE_INTENSITY.items())]


SCENARIOS = [v for k, v in sorted(globals().items()) if k.startswith("sc_")]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[3:] for f in SCENARIOS])
def test_scenario_matches_reference(scenario):
    assert scenario(PORT) == scenario(REF)


def test_port_locks_are_named_apart_from_the_reference():
    """The lock analyzer names locks by class and attribute: each copied
    class's lock has an attribute name the reference's class does not."""
    pairs = [(p_mgr.MultiTaskManager(), r_mgr.MultiTaskManager(),
              "_mgr_lock"),
             (p_met.MetricsRecorder({}), r_met.MetricsRecorder({}),
              "_rec_lock"),
             (p_sup.TenantBreaker(), r_sup.TenantBreaker(), "_breaker_lock"),
             (p_chaos.ChaosInjector(p_chaos.ChaosConfig()),
              r_chaos.ChaosInjector(r_chaos.ChaosConfig()), "_chaos_lock")]
    for port, ref, name in pairs:
        assert hasattr(port, name) and not hasattr(port, "_lock")
        assert hasattr(ref, "_lock") and not hasattr(ref, name)
