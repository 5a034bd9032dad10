"""Multi-tenant training service CLI (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-3-2b --tasks 4 --steps 5 --policy marlaas \\
        [--checkpoint-dir /tmp/ck] [--resume] [--device cpu]

The JAX CLI's flags, with ``--device`` added: it runs on the card unless
``--device cpu`` is given. As in the JAX CLI, ``--reduced`` is always on
(``action="store_true", default=True``: the flag cannot turn it off), so
every run is the arch's family-faithful tiny config in fp32 with the
tokenizer's vocabulary, a 64-token cache and 6 new tokens a row (12 for
search); a full-size run is ``launch.multi_tenant_train``'s job.
``--use-kernel`` is accepted and changes nothing: the port's kernels run
whenever the tensors lie on the card. ``--resume`` adopts the newest valid
snapshot in ``--checkpoint-dir`` (either package's) and carries on from its
versions. The encdec family raises (the engines refuse it, see
``rollout.engine.refuse_encdec``).
"""
from __future__ import annotations

import argparse
import dataclasses
import random

import torch

from repro_torch.checkpoint.store import latest_checkpoint
from repro_torch.configs import get_config, reduced
from repro_torch.core.manager import TaskSpec
from repro_torch.core.metrics import summarize
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.data import tokenizer as tok
from repro_torch.models import init_params
from repro_torch.models.common import resolve_device

ENVS = ["gsm8k", "amc12", "search"]


def main(argv=None) -> MARLaaSRuntime:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--tasks", type=int, default=2)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--policy", default="marlaas")
    ap.add_argument("--use-kernel", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=5)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--timeout", type=float, default=1800.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(reduced(cfg, dtype="float32"),
                                  vocab_size=tok.VOCAB_SIZE)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(args.seed),
                         dev)
    rt = MARLaaSRuntime(cfg, params, RuntimeConfig(
        policy=args.policy, max_len=64, seed=args.seed, device=str(dev),
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=(args.checkpoint_every
                          if args.checkpoint_dir else 0)))

    if args.resume and args.checkpoint_dir:
        snap = latest_checkpoint(args.checkpoint_dir)
        if snap:
            print(f"resuming from {snap}")
            rt.adopt_checkpoint(snap)
            for tid, _ in rt.mgr.task_items():
                rt.datagens[tid] = random.Random(args.seed + hash(tid) % 97)
    if not rt.mgr.task_items():
        for i in range(args.tasks):
            env = ENVS[i % len(ENVS)]
            rt.submit_task(TaskSpec(
                f"{env}-{i}", env, group_size=4, num_groups=1,
                max_new_tokens=6 if env != "search" else 12,
                target_steps=args.steps))

    rt.run(timeout_s=args.timeout)
    print("tasks:", {t: f"v{s.version} r={s.reward_history[-1:]}"
                     for t, s in rt.mgr.task_items()})
    print("metrics:", {k: round(v, 3)
                       for k, v in summarize(rt.mgr, rt.rec).items()})
    return rt


if __name__ == "__main__":
    main()
