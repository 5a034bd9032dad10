"""Multi-tenant asynchronous RL training: Algorithm 1 on two threads with
real GRPO updates (the port's counterpart of ``examples/multi_tenant_train.py``).

    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train            # qwen3-0.6b, cuda
    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train \\
        --preset tiny --device cpu --tasks 2 --steps 1
    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train \\
        --mix agentic --disagg-prefill --env-stage --paged-kv
    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train \\
        --paged-kv --kv-page-size 32 --kv-pool-pages 128 --no-prefix-cache \\
        --no-resume-restore --snapshot-budget-bytes 0 --tasks 2 --steps 1
    PYTHONPATH=src python -m repro_torch.launch.multi_tenant_train \\
        --mix agentic --disagg-prefill --env-stage --paged-kv \\
        --checkpoint-dir ck --trace-out trace.json \\
        --chaos-prefill-kill 1 --chaos-env-kill 1 --chaos-max-faults 1

Tenants (``--mix classic``: gsm8k / amc12 / agentic search; ``--mix
agentic``: the multi-turn tool-heavy mix, gsm8k / hopsearch / calcrepl /
guess; round-robin) share one frozen base model; each owns LoRA adapters
and optimizer state in the multi-task manager. The rollout thread decodes
every tenant's rows together in the continuous engine, each row under its
own adapter; the trainer thread runs one LoRA-only GRPO update per finished
round and commits a new version. ``--disagg-prefill`` moves the prefills to
worker threads (each on a CUDA stream of its own on the card);
``--env-stage`` parks tool-calling rows in an env stage of worker threads
instead of freezing them in their slots. Prints per-task reward curves and
the paper's system metrics (utilisation, idle share, TTFS, TPTS).
``--paged-kv`` serves from the paged KV pool; ``--kv-page-size``,
``--kv-pool-pages``, ``--no-prefix-cache``, ``--no-resume-restore`` and
``--snapshot-budget-bytes`` shape it, and the entry point prints the pool
the engine built. ``--checkpoint-dir`` snapshots the manager every 5
commits; the ``--chaos-*`` flags inject faults (worker kills, tool errors,
dropped snapshots, torn checkpoints) from one seeded script; ``--trace-out``
writes a Perfetto-loadable trace and prints the critical-path latency
report.

``--preset qwen3-0.6b`` (the default) runs the published configuration at
full width and depth in bf16 with random weights from seed 0 and adapters
whose ``b`` is drawn from N(0, 0.02²), 16 slots and a 256-token cache;
``--preset zamba2-1.2b`` (hybrid), ``mamba2-780m`` (ssm) and
``deepseek-moe-16b`` (moe) run those published configurations the same way;
``--preset tiny`` the reduced fp32 granite of the tests with the
tokenizer's vocabulary and the adapters ``init_lora`` gives.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import torch

from repro_torch.configs import REGISTRY, reduced
from repro_torch.core.chaos import ChaosConfig
from repro_torch.core.manager import TaskSpec
from repro_torch.core.metrics import summarize
from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
from repro_torch.data import tokenizer as tok
from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import make_adapters
from repro_torch.models import init_params, tree_leaves
from repro_torch.models.common import resolve_device

# tenant env rotations: classic = the paper's three archetypes; agentic =
# multi-turn tool-heavy tenants mixed with plain math (the env stage's
# workload: pair with --env-stage)
MIXES = {
    "classic": ["gsm8k", "amc12", "search"],
    "agentic": ["gsm8k", "hopsearch", "calcrepl", "guess"],
}
AGENTIC_ENVS = {"search", "hopsearch", "calcrepl", "guess"}
PRESETS = {   # max_new_tokens, max_len, slots, group_size, num_groups
    "tiny": (6, 64, 8, 4, 1),
    "qwen3-0.6b": (32, 256, 16, 4, 2),
    # the other families at full width, with qwen3-0.6b's settings: each
    # fits one 80 GB card with them (deepseek-moe-16b's bf16 weights are
    # 33.8 GB, its 16 x 256-token dense cache 0.9 GB)
    "zamba2-1.2b": (32, 256, 16, 4, 2),
    "mamba2-780m": (32, 256, 16, 4, 2),
    "deepseek-moe-16b": (32, 256, 16, 4, 2),
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
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--paged-kv", action="store_true",
                    help="paged KV-cache block pool: shared fixed-size "
                         "pages + block tables instead of a dense "
                         "[slots, max_len] cache; park/preempt resume "
                         "restores saved pages instead of replaying")
    ap.add_argument("--kv-page-size", type=int, default=16,
                    help="tokens per KV page (max_len must divide)")
    ap.add_argument("--kv-pool-pages", type=int, default=0,
                    help="page-pool size (0 = dense-equivalent auto)")
    ap.add_argument("--no-resume-restore", action="store_true",
                    help="paged mode: disable snapshot/restore resume "
                         "(always token-replay — the parity baseline)")
    ap.add_argument("--snapshot-budget-bytes", type=int, default=0,
                    help="host arena for parked KV snapshots (0 = "
                         "unlimited; overflow falls back to replay)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="paged mode: disable the copy-on-write prefix "
                         "cache and allocate every row's pages "
                         "privately. When enabled (the default with "
                         "--paged-kv), sharing happens at three levels: "
                         "(1) GRPO-group sharing — same-prompt group "
                         "siblings map their block tables onto one "
                         "prefilled page set and fork pages copy-on-write "
                         "on first divergent decode write; (2) device-"
                         "resident snapshots — park/preempt of a row "
                         "whose pages are in-pool retains them on device "
                         "and resume is a block-table splice (host "
                         "snapshots demoted to a spill tier); (3) radix "
                         "prefix reuse — new requests and tool-turn "
                         "resumes match their longest cached page-aligned "
                         "prefix and prefill only the suffix")
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
    ap.add_argument("--disagg-prefill", action="store_true",
                    help="async prefill stage (Fig 5): prefills run on "
                         "worker threads, decode only splices")
    ap.add_argument("--prefill-workers", type=int, default=1)
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill size (0 = whole prompt)")
    ap.add_argument("--env-stage", action="store_true",
                    help="disaggregated env-interaction stage: rows park "
                         "on tool calls instead of freezing in their slot")
    ap.add_argument("--env-workers", type=int, default=2)
    ap.add_argument("--env-inflight-per-tenant", type=int, default=0,
                    help="max concurrent tool calls per tenant in the env "
                         "stage (0 = uncapped)")
    ap.add_argument("--max-turns", type=int, default=0,
                    help="per-episode tool-turn budget (0 = env default)")
    ap.add_argument("--mix", default="classic", choices=sorted(MIXES),
                    help="tenant env rotation; 'agentic' is the multi-turn "
                         "tool-heavy mix the env stage targets")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="deterministic fault-injection seed; each site "
                         "gets an independent RNG stream, so the same seed "
                         "replays the same fault script")
    ap.add_argument("--chaos-prefill-kill", type=float, default=0.0,
                    metavar="P", help="P(kill a prefill worker per job "
                                      "pickup); the supervisor recovers "
                                      "the job and respawns with backoff")
    ap.add_argument("--chaos-env-kill", type=float, default=0.0,
                    metavar="P", help="P(kill an env-stage worker per "
                                      "tool-call pickup)")
    ap.add_argument("--chaos-tool-transient", type=float, default=0.0,
                    metavar="P", help="P(transient tool error per call); "
                                      "retried with exponential backoff")
    ap.add_argument("--chaos-tool-permanent", type=float, default=0.0,
                    metavar="P", help="P(permanent tool error per call); "
                                      "fails the episode and counts "
                                      "toward the tenant's circuit "
                                      "breaker")
    ap.add_argument("--chaos-snapshot-drop", type=float, default=0.0,
                    metavar="P", help="P(drop a parked-row KV snapshot); "
                                      "resume falls back to token replay")
    ap.add_argument("--chaos-torn-checkpoint", type=float, default=0.0,
                    metavar="P", help="P(tear a checkpoint mid-publish); "
                                      "restart must fall back to the "
                                      "previous valid snapshot")
    ap.add_argument("--chaos-max-faults", type=int, default=0,
                    metavar="N", help="cap each site at N faults total "
                                      "(0 = uncapped)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="end-to-end episode tracing: write a Perfetto-"
                         "loadable Chrome trace JSON here and print the "
                         "critical-path latency report (per-tenant "
                         "p50/p95/p99 and the dominant bottleneck stage)")
    args = ap.parse_args(argv)
    chaos = ChaosConfig(
        seed=args.chaos_seed,
        prefill_worker_kill=args.chaos_prefill_kill,
        env_worker_kill=args.chaos_env_kill,
        tool_error_transient=args.chaos_tool_transient,
        tool_error_permanent=args.chaos_tool_permanent,
        snapshot_drop=args.chaos_snapshot_drop,
        torn_checkpoint=args.chaos_torn_checkpoint,
        max_faults_per_site=args.chaos_max_faults)

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
        paged_kv=args.paged_kv, kv_page_size=args.kv_page_size,
        kv_pool_pages=args.kv_pool_pages,
        resume_restore=not args.no_resume_restore,
        snapshot_budget_bytes=args.snapshot_budget_bytes,
        prefix_cache=not args.no_prefix_cache,
        async_train=args.async_train, max_staleness=args.max_staleness,
        min_train_rows=args.min_train_rows,
        disagg_prefill=args.disagg_prefill,
        prefill_workers=args.prefill_workers,
        prefill_chunk=args.prefill_chunk, env_stage=args.env_stage,
        env_workers=args.env_workers,
        env_inflight_per_tenant=args.env_inflight_per_tenant,
        max_turns=args.max_turns, checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=5 if args.checkpoint_dir else 0,
        chaos=chaos if chaos.enabled else None,
        trace=bool(args.trace_out)))
    if args.paged_kv:
        eng = rt.cengine
        budget = eng._snap_store.budget_bytes
        print(f"pool: page_size={eng.kv_page_size} pages={eng.kv_pool_pages} "
              f"prefix_cache={'on' if eng.prefix_cache else 'off'} "
              f"resume_restore={'on' if eng.resume_restore else 'off'} "
              f"snapshot_budget_bytes={budget or 'unlimited'}")
    adapters = (make_adapters(cfg, args.tasks, seed=0, device=dev,
                              b_scale=0.02)
                if args.preset != "tiny" else [None] * args.tasks)
    envs = MIXES[args.mix]
    for i in range(args.tasks):
        env = envs[i % len(envs)]
        # agentic tenants get twice the budget: their tool turns sample too
        rt.submit_task(TaskSpec(f"{env}-{i}", env, group_size=group,
                                num_groups=groups,
                                max_new_tokens=max_new * (2 if env in
                                                          AGENTIC_ENVS
                                                          else 1),
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
    if rt.chaos is not None:
        c = rt.rec.counters_snapshot()
        fault = {k: v for k, v in sorted(c.items())
                 if k.startswith(("chaos_", "supervisor_", "quarantine_"))
                 or k in ("env_retries", "env_recovered", "env_wedged")}
        print(f"chaos: injected={dict(rt.chaos.counts())}")
        print(f"fault handling: {json.dumps(fault)}")
    st = rt.cengine.stats
    if args.disagg_prefill or args.env_stage:
        print(f"stages: splices={st.splices} prefill_chunks="
              f"{st.prefill_chunks} decode_stall_s="
              f"{st.decode_stall_seconds:.3f} parks={st.parks} "
              f"resumes={st.resumes} tool_errors={st.tool_errors} "
              f"tool_wait_slot_steps={st.tool_wait_slot_steps} "
              f"fused_forced_tokens={st.fused_forced_tokens}")
    if args.paged_kv:
        print(f"paged KV: restores={st.restores} replays={st.replays} "
              f"prefix_hits={st.prefix_hits} "
              f"prefix_hit_tokens={st.prefix_hit_tokens} "
              f"cow_forks={st.cow_forks} "
              f"device_resident_resumes={st.device_resident_resumes} "
              f"pool={rt.cengine.page_stats()}")
    if args.trace_out:
        from repro_torch.obs.report import (analyze, format_report,
                                            load_episodes)
        trace = rt.tracer.dump_json(args.trace_out)
        print(f"\ntrace written to {args.trace_out} "
              f"(open at ui.perfetto.dev; "
              f"{rt.tracer.dropped_events} events dropped)")
        print(format_report(analyze(load_episodes(trace))))
    print("launches " + json.dumps(launch_counts()))
    return rt


if __name__ == "__main__":
    main()
