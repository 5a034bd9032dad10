"""Multi-tenant asynchronous RL training: Algorithm 1 on two threads with
real GRPO updates (the port's counterpart of ``examples/multi_tenant_train.py``).

    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train            # qwen3-0.6b, cuda
    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train \\
        --preset tiny --device cpu --tasks 2 --steps 1

Tenants (gsm8k / amc12 / agentic search, round-robin) share one frozen base
model; each owns LoRA adapters and optimizer state in the multi-task
manager. The rollout thread decodes every tenant's rows together in the
continuous engine, each row under its own adapter; the trainer thread runs
one LoRA-only GRPO update per finished round and commits a new version.
Prints per-task reward curves and the paper's system metrics
(utilisation, idle share, TTFS, TPTS).

``--preset qwen3-0.6b`` (the default) runs the published configuration at
full width and depth in bf16 with random weights from seed 0 and adapters
whose ``b`` is drawn from N(0, 0.02²), 16 slots and a 256-token cache;
``--preset tiny`` the reduced fp32 granite of the tests with the
tokenizer's vocabulary and the adapters ``init_lora`` gives.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import REGISTRY, reduced
from repro_torch.core.manager import TaskSpec
from repro_torch.core.metrics import summarize
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.data import tokenizer as tok
from repro_torch.launch.serve import make_adapters
from repro_torch.models import init_params, tree_leaves
from repro_torch.models.common import resolve_device

ENVS = ["gsm8k", "amc12", "search"]
PRESETS = {   # max_new_tokens, max_len, slots, group_size, num_groups
    "tiny": (6, 64, 8, 4, 1),
    "qwen3-0.6b": (32, 256, 16, 4, 2),
}


def base_config(preset: str):
    if preset == "tiny":
        return dataclasses.replace(
            reduced(REGISTRY["granite-3-2b"], dtype="float32"),
            vocab_size=tok.VOCAB_SIZE)
    return REGISTRY[preset]


def main(argv=None) -> MARLaaSRuntime:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tasks", type=int, default=3)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--policy", default="marlaas",
                    choices=["marlaas", "multilora_sync", "single_disagg"])
    ap.add_argument("--preset", default="qwen3-0.6b", choices=sorted(PRESETS))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--paged-kv", action="store_true",
                    help="paged KV-cache block pool (16-token pages) instead "
                         "of a dense [slots, max_len] cache, with the "
                         "copy-on-write prefix cache")
    ap.add_argument("--async-train", action="store_true",
                    help="event-driven off-policy trainer: train "
                         "micro-batches of complete GRPO groups as they "
                         "arrive instead of waiting for full rounds")
    ap.add_argument("--max-staleness", type=int, default=1,
                    help="bounded staleness window in versions (async "
                         "only); 0 = on-policy, identical to the "
                         "synchronous trainer")
    ap.add_argument("--min-train-rows", type=int, default=0,
                    help="micro-batch threshold in rows, rounded up to "
                         "complete GRPO groups (0 = a full round)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = base_config(args.preset)
    max_new, max_len, slots, group, groups = PRESETS[args.preset]
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_par = sum(t.numel() for t in tree_leaves(params))
    print(f"base model: {cfg.name} ({args.preset}, {n_par / 1e6:.1f}M params, "
          f"{cfg.dtype}) on {dev}, policy={args.policy}")
    rt = MARLaaSRuntime(cfg, params, RuntimeConfig(
        policy=args.policy, max_len=max_len, max_slots=slots,
        max_adapter_slots=max(args.tasks, 1), seed=0, device=str(dev),
        paged_kv=args.paged_kv,
        async_train=args.async_train, max_staleness=args.max_staleness,
        min_train_rows=args.min_train_rows))
    adapters = (make_adapters(cfg, args.tasks, seed=0, device=dev,
                              b_scale=0.02)
                if args.preset != "tiny" else [None] * args.tasks)
    for i in range(args.tasks):
        env = ENVS[i % len(ENVS)]
        rt.submit_task(TaskSpec(f"{env}-{i}", env, group_size=group,
                                num_groups=groups, max_new_tokens=max_new,
                                target_steps=args.steps), adapters[i])
    rt.run(timeout_s=args.timeout)

    print("\nper-task reward curves (graded verifier reward in [0, 1]):")
    for tid, st in rt.mgr.task_items():
        curve = " ".join(f"{r:.2f}" for r in st.reward_history)
        print(f"  {tid:12s} v{st.version}: {curve}")
    print("\nsystem metrics:")
    print(json.dumps({k: round(v, 3) for k, v in
                      summarize(rt.mgr, rt.rec).items()}, indent=2))
    print(f"row accounting: {json.dumps(rt.row_accounting())}")
    if args.paged_kv:
        st = rt.cengine.stats
        print(f"paged KV: restores={st.restores} replays={st.replays} "
              f"prefix_hits={st.prefix_hits} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"cow_forks={st.cow_forks} "
              f"device_resident_resumes={st.device_resident_resumes} "
              f"pool={rt.cengine.page_stats()}")
    return rt


if __name__ == "__main__":
    main()
