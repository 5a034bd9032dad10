"""The four scheduling regimes evaluated in the paper (§5 Baselines), driving
the shared MultiTaskManager + Simulator:

  single_disagg   — tasks one at a time, exclusive disaggregated pools
  single_colloc   — tasks one at a time, idealized shared pool (instant
                    switching — paper's optimistic upper bound)
  multilora_sync  — concurrent multi-LoRA rollout, global barrier, then
                    sequential training, per round
  marlaas         — full MARLaaS: async, event-driven, admission-controlled
                    (Algorithm 1)

Each run returns (manager, recorder) for metrics.summarize().

A copy of ``repro.core.policies`` with its imports pointed at the port.
"""
from __future__ import annotations

import numpy as np
from typing import Dict, List, Optional

from repro_torch.configs import ModelConfig
from repro_torch.rl.types import TrajectoryBatch
from .admission import AdmissionConfig, AdmissionController
from .manager import MultiTaskManager, TaskSpec
from .metrics import MetricsRecorder
from .simulator import HardwareModel, Simulator, WorkloadModel

POLICIES = ("single_disagg", "single_colloc", "multilora_sync", "marlaas")
# ablation variant (paper Table 4): async scheduling WITHOUT fused
# multi-LoRA decode — every tenant pays its own weight reads
ABLATIONS = ("marlaas_nomlora",)


def _fake_batch(task_id: str, version: int) -> TrajectoryBatch:
    z = np.zeros((1, 2), np.float32)
    return TrajectoryBatch(task_id=task_id, version=version,
                           tokens=z.astype(np.int32),
                           prompt_lens=np.ones(1, np.int32),
                           total_lens=np.full(1, 2, np.int32),
                           rewards=np.zeros(1, np.float32), group_size=1)


def run_sim(policy: str, cfg: ModelConfig, hw: HardwareModel,
            specs: List[TaskSpec], workloads: Dict[str, WorkloadModel],
            admission: Optional[AdmissionConfig] = None, seed: int = 0):
    sim = Simulator(cfg, hw, seed=seed)
    mgr = MultiTaskManager(clock=sim.clock)
    for s in specs:
        mgr.submit(s)

    if policy == "marlaas":
        _drive_marlaas(sim, mgr, specs, workloads, admission
                       or AdmissionConfig())
    elif policy == "marlaas_nomlora":
        _drive_marlaas(sim, mgr, specs, workloads, admission
                       or AdmissionConfig(), multi_lora=False)
    elif policy == "multilora_sync":
        _drive_sync(sim, mgr, specs, workloads)
    elif policy in ("single_disagg", "single_colloc"):
        _drive_single(sim, mgr, specs, workloads,
                      collocated=(policy == "single_colloc"))
    else:
        raise ValueError(policy)

    sim.run(stop=mgr.all_done)
    return mgr, sim.rec


# ---------------------------------------------------------------------------
# MARLaaS (Algorithm 1): fully event-driven
# ---------------------------------------------------------------------------

def _drive_marlaas(sim: Simulator, mgr: MultiTaskManager,
                   specs: List[TaskSpec], workloads, acfg: AdmissionConfig,
                   multi_lora: bool = True):
    adm = AdmissionController(sim.cfg, acfg)

    def try_admit():
        # highest-priority pending tenants claim freed budget first (ties
        # keep submission order — pending_tasks preserves it)
        pending = sorted(mgr.pending_tasks(),
                         key=lambda t: -mgr.spec_for(t).priority)
        for tid in pending:
            wl = workloads[tid]
            need = adm.workload_bytes(wl.rows, wl.prompt_len + wl.gen_len)
            if adm.try_admit_bytes(tid, need):
                mgr.admit(tid)
                issue_rollout(tid)

    def issue_rollout(tid):
        np_ = mgr.next_policy(tid)
        if np_ is None:
            return
        version, _ = np_
        spec = mgr.spec_for(tid)

        def on_rollout_done(tid=tid, version=version):
            mgr.enqueue(_fake_batch(tid, version))
            drain_buffer()

        sim.submit_rollout(spec, workloads[tid], version, on_rollout_done,
                           multi_lora=multi_lora)

    def drain_buffer():
        # single-task serialized training engine (paper §4.5): the sim's
        # train server FIFO-orders submissions, so drain eagerly.
        while True:
            b = mgr.pop_batch()
            if b is None:
                return

            def on_train_done(b=b):
                mgr.commit(b.task_id, None, None, b.version)
                if mgr.state(b.task_id).done:
                    adm.release(b.task_id)
                    try_admit()
                else:
                    issue_rollout(b.task_id)

            sim.submit_train(mgr.spec_for(b.task_id),
                             workloads[b.task_id], b.version, on_train_done)

    sim.schedule(0.0, try_admit)


# ---------------------------------------------------------------------------
# Multi-LoRA synchronous: barrier rounds
# ---------------------------------------------------------------------------

def _drive_sync(sim: Simulator, mgr: MultiTaskManager, specs, workloads):
    for s in specs:
        mgr.admit(s.task_id)

    state = {"outstanding": 0}

    def start_round():
        active = mgr.active_tasks()
        if not active:
            return
        state["outstanding"] = len(active)
        for tid in active:
            np_ = mgr.next_policy(tid)
            if np_ is None:
                state["outstanding"] -= 1
                continue
            v, _ = np_

            def on_done(tid=tid, v=v):
                mgr.enqueue(_fake_batch(tid, v))
                state["outstanding"] -= 1
                if state["outstanding"] == 0:
                    train_all()          # global barrier reached

            sim.submit_rollout(mgr.spec_for(tid), workloads[tid], v, on_done)

    def train_all():
        batches = []
        while True:
            b = mgr.pop_batch()
            if b is None:
                break
            batches.append(b)
        remaining = {"n": len(batches)}
        for b in batches:
            def on_train_done(b=b):
                mgr.commit(b.task_id, None, None, b.version)
                remaining["n"] -= 1
                if remaining["n"] == 0:
                    start_round()

            sim.submit_train(mgr.spec_for(b.task_id), workloads[b.task_id],
                             b.version, on_train_done)
        if not batches:
            start_round()

    sim.schedule(0.0, start_round)


# ---------------------------------------------------------------------------
# Single-task regimes (disaggregated / collocated)
# ---------------------------------------------------------------------------

def _drive_single(sim: Simulator, mgr: MultiTaskManager, specs, workloads,
                  *, collocated: bool):
    order = [s.task_id for s in specs]
    hw = sim.hw
    if collocated:
        # idealized shared pool: all devices serve whichever phase is active
        sim.rec = MetricsRecorder({"all": hw.n_devices})
        _alias_pools(sim)
        rollout_devs = hw.n_devices
        train_devs = hw.n_devices
    else:
        rollout_devs = hw.rollout_devices
        train_devs = hw.train_devices

    idx = {"i": 0}

    def start_next_task():
        if idx["i"] >= len(order):
            return
        tid = order[idx["i"]]
        mgr.admit(tid)
        step(tid)

    def step(tid):
        np_ = mgr.next_policy(tid)
        if np_ is None:  # task finished
            idx["i"] += 1
            start_next_task()
            return
        v, _ = np_

        def on_rollout_done(tid=tid, v=v):
            mgr.enqueue(_fake_batch(tid, v))
            b = mgr.pop_batch()

            def on_train_done(b=b):
                mgr.commit(b.task_id, None, None, b.version)
                step(b.task_id)

            sim.submit_train(mgr.spec_for(b.task_id), workloads[b.task_id],
                             b.version, on_train_done,
                             pool_devices=train_devs)

        sim.submit_rollout(mgr.spec_for(tid), workloads[tid], v,
                           on_rollout_done, multi_lora=False,
                           pool_devices=rollout_devs)

    sim.schedule(0.0, start_next_task)


def _alias_pools(sim: Simulator):
    """Collocated mode: record every phase against the single shared pool,
    and let decode use the full machine's bandwidth."""
    rec = sim.rec
    orig = rec.record

    def record(pool, phase, task_id, start, end, devices=None):
        orig("all", phase, task_id, start, end, devices)

    rec.record = record
    full_bw = sim.hw.n_devices * sim.hw.hbm_bw_per_dev * sim.hw.mem_eff
    sim._pool_bw = lambda: full_bw
