"""Fault tolerance: survive worker kills in place, then crash mid-run and
restart from the newest atomic snapshot (the port's counterpart of
``examples/failover_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.failover_demo             # cuda
    PYTHONPATH=src python -m repro_torch.launch.failover_demo --device cpu

Two layers of defence, in escalation order:

  1. restart in place — seeded chaos kills a prefill worker mid-job; the
     stage supervisor recovers the stranded prompt and respawns the worker;
  2. checkpoint restart — an injected crash after 3 train commits stops
     the whole runtime; ``run_with_recovery`` finds the newest valid
     snapshot, builds a fresh runtime, re-adopts the tasks (adapters,
     optimizer state, episode queues, counters) and finishes the job.

It runs the JAX example's model, the reduced fp32 ``granite-3-2b`` with
the tokenizer's vocabulary (random weights from seed 0), two gsm8k
tenants of 4 steps; at full width learning from random weights proves
nothing in a demo's time. It ends with the row account (every issued row
trained, dropped as stale, discarded, failed, quarantined or orphaned) and,
on a line of its own, the kernels' launches; it exits non-zero when the
account does not balance or a task is unfinished.
"""
from __future__ import annotations

import argparse
import json
import tempfile

import torch

from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.manager import TaskSpec
from repro_torch.core.runtime import (FailureInjector, MARLaaSRuntime,
                                      RuntimeConfig)
from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import serve_config
from repro_torch.models import init_params
from repro_torch.models.common import resolve_device


def run(cfg, params, *, device="cuda", checkpoint_dir=None, log=print):
    """The example's run on given weights; returns the runtime that
    finished and its row account (raises when it does not balance)."""
    ckpt = checkpoint_dir or tempfile.mkdtemp(prefix="marlaas_ckpt_")
    rt = MARLaaSRuntime(cfg, params,
                        RuntimeConfig(policy="marlaas", max_len=48,
                                      checkpoint_dir=ckpt,
                                      checkpoint_every=1,
                                      checkpoint_keep_last=3,
                                      disagg_prefill=True,
                                      prefill_workers=1,
                                      chaos=ChaosConfig(
                                          seed=0,
                                          prefill_worker_kill=1.0,
                                          max_faults_per_site=1),
                                      device=str(resolve_device(device))),
                        failure=FailureInjector(fail_after_commits=3))
    for i in range(2):
        rt.submit_task(TaskSpec(f"gsm-{i}", "gsm8k", group_size=2,
                                num_groups=1, max_new_tokens=4,
                                target_steps=4))
    # the injected crash escalates past the supervisor; run_with_recovery
    # restores the newest snapshot into a fresh runtime and returns the
    # runtime that finished
    done = rt.run_with_recovery(timeout_s=600, max_restarts=2)
    c = done.rec.counters_snapshot()
    log(f"chaos fired: {dict(done.chaos.counts()) if done.chaos else {}}")
    log(f"supervisor worker restarts: "
        f"{c.get('supervisor_prefill_worker_restarts', 0)} "
        f"(jobs recovered: "
        f"{c.get('supervisor_prefill_worker_jobs_recovered', 0)})")
    log(f"checkpoint restarts: {c.get('checkpoint_restarts', 0)}")
    for tid, st in done.mgr.task_items():
        log(f"  {tid}: v{st.version} "
            f"({st.steps_done}/{st.spec.target_steps} steps)")
    acc = done.row_accounting()
    if acc["completed"] != (acc["trained"] + acc["stale_dropped"]
                            + acc["discarded_tails"] + acc["failed"]
                            + acc["quarantine_dropped"] + acc["orphaned"]):
        raise AssertionError(f"row account does not balance: {acc}")
    if not done.mgr.all_done():
        raise AssertionError("a task did not finish")
    log(f"finished: every issued row accounted for {acc}")
    return done, acc


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = serve_config("granite-3-2b", reduce=True)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    run(cfg, params, device=dev)
    print("launches " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
