#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA H100.

    python3 chip_smoke.py                 # every phase; needs one CUDA card
    python3 chip_smoke.py --profile DIR   # also profile one served round, one
                                          # train step and a continuous run
    python3 chip_smoke.py --launches-of DIR/serve_profile.txt
                                          # device launches a forward in such a
                                          # profile (no card needed)

Phases (any failure raises and exits non-zero; nothing is caught):
 1. device: requires a CUDA card and prints nvidia-smi's name and power limit;
 2. build: compiles every kernel of the serving and training paths from
    csrc/ (sm_90a) and prints registers and spills (token_logprob's and
    sgmv's kernels, and the decode kernels' main-path variants: bf16 and
    fp32, hd 128, rep 2, 4 and 8 warps, with any variant that spills);
 3. kernels: holds each hand-written kernel against its plain PyTorch version
    at the serving and training paths' shapes, and times kernel, plain
    version, one library call, and the card's bound for the same work; the
    decode kernels also at long caches (gqa_decode S=1000 and 4096, paged
    4096 tokens a row) and at their chunks' edges, with their plans, two
    calls' bits and, at long caches, the plan's chunk beside half and twice;
    sgmv's two epilogues (the fp32 product, and the delta added into y in
    place as the serving path runs it) at every projection's shape in decode
    and prefill, one row a slot and 2048 rows, each with its plan, its CUDA
    launches a call (must be 1), two calls' bits and the in-place epilogue
    bit-equal to the product followed by torch's scale, cast and add;
 4. serve: RolloutEngine.generate at qwen3-0.6b's full size in bf16 (28
    layers, d=1024, V=151936) for 4 tenants x 4 gsm8k requests with
    random-b adapters; the kernels' launch counts must match the steps run
    (sgmv: 168 calls and 168 CUDA launches a forward);
 5. check: teacher-forces 4 served rows through forward_seq in fp32 on the
    card (kernels) and on the CPU (plain versions) and compares the logprobs;
 6. train: three GRPO iterations at the same full size — generate 4 groups x
    4 gsm8k samples under one tenant's adapter, pack them
    (to_trajectory_batch), one make_train_step update (LoRA-only, KL and
    entropy terms on, token_logprob kernels: 2 forwards + 1 backward a step);
 7. train check: one group of phase 6's batch in fp32, the step's loss,
    metrics, adapter gradient and updated adapters on the card (kernels)
    against the CPU (plain versions); then the same group in bf16 on the
    card with the token_logprob kernels, against the same step with the
    plain backward in the backward kernel's place (adapter gradient) and
    with the plain forward in the forward kernel's place (loss, metrics and
    gradient): fp32 takes the FMA kernels, bf16 the tensor-core ones;
 8. continuous serve: ContinuousRolloutEngine over the paged KV pool
    (16 slots, max_len 512, a pool of 128 pages of 16 tokens, a quarter of
    the dense-equivalent 512) at the same full size for 4 tenants x 8 gsm8k
    requests of 64 new tokens (SRPT); after decode step 10 the last tenant's
    8 requests arrive with a higher priority and tenant-1 is preempted for
    them: its rows snapshot to host and restore when slots free, and the
    fresh rows prefill while others decode.
    Page invariants after every step; 32 completions, restores > 0, no
    replay; paged_gqa_decode launches 28 per decode step, gqa_decode none,
    sgmv 168 per forward;
 9. paged check: 4 of phase 8's rows in fp32, 16 teacher-forced decode
    steps over shuffled pages on the card (paged_gqa_decode) against a dense
    cache on the CPU (plain versions), logprobs within TF_TOL;
10. runtime: MARLaaSRuntime at the same full size, 4 tenants (2 gsm8k, 2
    amc12; groups of 4, 2 groups a round, 32 new tokens, 3 steps each; run
    A 2 steps, runs B, C and D0 16 new tokens: P10_CUT) with
    random-b adapters and a graded verifier (the share of even token ids,
    so that rewards differ within a group and every update is nonzero), the
    continuous engine on the rollout thread and the GRPO trainer on the
    trainer thread. In both runs every commit's grad_norm is above 0, every
    adapter install is a tree the manager committed and equals the engine's
    stacked slot after it, and each tenant's trained trees reach the
    engine. Run A, the runtime's defaults (16
    slots, dense cache, round-synchronous trainer): every tenant at version
    3, 12 commits, 96 rows trained and none orphaned, train intervals
    serialised, a decode interval serving several tenants and one
    overlapping a train interval; gqa_decode 28 launches a decode step,
    sgmv 168 a forward, token_logprob 1 forward and 1 backward a commit.
    Run B, the asynchronous trainer (max_staleness 1, micro-batches of one
    group, the importance weight on) over the paged pool: every tenant
    done, an exact row account, paged_gqa_decode 28 launches a decode step
    and gqa_decode none, the pool whole at the end. Run C, run B with the
    prefix cache on (the JAX runtime's default with the paged pool; pages of
    8 tokens, which the runtime's 5-11-token prompts fill): run B's checks,
    prefix hits > 0 (GRPO siblings share their leader's prompt pages) and at
    the end only the index's pages held. Runs D0 and D: run C's settings
    over two gsm8k and two hopsearch tenants whose rows call their tools
    (a biased sampler returns tok.CALL at token counters 2 and 9); D0 with
    the stages off, D with one prefill worker and two env workers: run B's
    checks, and for D parks > 0, no slot frozen on a tool, env wait on the
    hopsearch tenants only, splices > 0 and no decode stall. Every run pins
    each tenant's prompt stream. Each run prints its
    wall time to the last commit, the runtime's summary, decode ms/step
    inside and outside train intervals, train ms/step and the launches
    (sgmv 168 a forward, every forward the engine counts: decode steps,
    refills, radix installs, the prefill workers' calls), D beside D0.
11. prefix cache: ContinuousRolloutEngine over the paged pool with its
    default copy-on-write prefix cache at the same full size (16 slots,
    pages of 16, max_len 512): each tenant's two gsm8k prompts behind one
    128-token header (8 whole pages), each a GRPO group of 4, 64 new tokens;
    the first groups first, then after decode step 4 the second groups
    (priority 1) while tenant-1 is preempted mid-fork (its rows park in the
    pool). Page invariants after every step; prefix hits and hit tokens
    equal to what the prompts give (28 and 3584, as the CPU run of the same
    schedule in tests/test_torch_prefix.py), COW forks and device-resident
    resumes, no snapshot and no spill, prefill tokens at most half those of
    the same requests with private pages, only the index's pages at the
    end, paged_gqa_decode 28 launches a decode step and sgmv 168 a forward
    (suffix prefills included); with a pool of 48 pages, index evictions
    and a spill, every row finished; both modes again in fp32 (TF32 off,
    32 new tokens): rows with equal streams counted, and where two part the
    logprobs of their shared tokens and the sampler's scores at the parting
    token within TF_TOL. Prints decode ms/step, prefill time, peak pages,
    HBM bytes a row and the admission charge of private over shared pages.
12. stages: the continuous engine at the same full size (16 slots, max_len
    512, pages of 16) for 4 tenants x 8 requests of 64 new tokens, tenants
    0 and 2 on hopsearch (2 tool turns a row, the env's 0.08 s latency a
    call; the biased sampler), in five modes: F (fused refill, calls
    frozen in the slot), D (two prefill workers on their own streams,
    16-token chunks), DE (D with the env stage: rows park, resumes restore
    their pages kept in the pool), DER (DE replaying every resume through a
    worker, with response-prefill fusion) and DED (DE on the dense cache,
    8-token chunks). Checks: 32 completions; slots frozen on tools in F
    and D only; parks and resumes; device-resident resumes (DE); fused
    tokens (DER); splices and no decode stall (D modes), stall = prefill
    time (F); page invariants after every step; exact launches (decode
    attention 28 a decode step, sgmv 168 a forward, worker calls included);
    then F, DE, DER and DED in fp32 at 16 new tokens: streams equal, or
    parting at near-ties. Prints decode ms/step (median, p90), prefill
    time and where it ran, splice time and wait, stall, occupancy, parks,
    wall and peak memory.
13. fault tolerance and tracing: phase 10 run D's settings (2 gsm8k and 2
    hopsearch tenants, the biased sampler, paged pool with the prefix cache,
    the asynchronous trainer at max_staleness 1, one prefill worker and two
    env workers, prompt streams pinned). Run T is run D traced: run D's
    checks and exact launches, every episode from `submitted` to
    `committed` or `dropped`, the trace exported and read back by
    `python -m repro_torch.obs.report`, its components summing to each
    episode's latency within 1%; prints decode ms/step (median, p90) beside
    run D's, the per-tenant end-to-end p50/p95 and the bottleneck
    component. Run R is run T under chaos (a prefill worker and an env
    worker killed, a transient tool error, snapshot drops where a snapshot
    is taken), a snapshot after every commit (the newest 2 kept) and a
    crash after the sixth commit, driven through `run_with_recovery`: every
    tenant at its target, one restart, the chaos sites fired, supervisor
    restarts, an exact row account across the restart (orphans counted),
    page invariants after every step of both incarnations, the newest
    snapshot's adapters and AdamW state bit-equal to the crashed runtime's
    committed trees and the adopted ones bit-equal to the snapshot, exact
    launches over both incarnations; prints the bytes of a snapshot, the
    seconds of a save and of its hold of the manager lock, decode ms/step
    inside and outside saves, and the last commit beside run D's.
14. families: the moe, ssm and hybrid families at full published width in
    bf16 (random weights from seed 0, drawn on the card layer by layer;
    adapters with b ~ N(0, 0.02^2) in every subtree). First each kernel at
    their shapes against its plain version: both decode kernels at rep 1
    (deepseek-moe 16/16 heads of 128, zamba2 32/32 heads of 64; bf16 and
    fp32, timed in bf16), sgmv at the SSD projections (zamba2 2048->8384
    and 4096->2048, mamba2 1536->6448 and 3072->1536), zamba2's shared MLP
    and deepseek-moe's shared experts, token_logprob forward and backward
    at V=32000 (d 2048), 50280 (d 1536, a ragged last tile) and 102400
    (d 2048, the untied head). (a) zamba2-1.2b through the runtime at run
    D's settings (run Z: paged pool, asynchronous trainer, one prefill
    worker, the env stage, 2 gsm8k and 2 hopsearch tenants): run D's
    checks, page invariants after every step, no prefix hit (the cache
    holds recurrent state), paged_gqa_decode 6 launches a decode step (one
    a shared-block invocation), sgmv 112 a forward (ssm_in and ssm_out on
    38 layers, q/k/v/o/mlp on 6 invocations), token_logprob 1 + 1 a commit;
    then a served round and 4 of its rows teacher-forced in fp32 on the card
    against the CPU. (b) mamba2-780m at phase 8's settings (tenant-1
    preempted: its rows' ssm/conv state snapshots to host and restores; no
    decode-attention launch; the largest snapshot of a row printed), one
    GRPO step, the fp32 check on 4 of its rows. (c) deepseek-moe-16b:
    phase 4's served round (gqa_decode 28 launches a step), phase 8's run
    (paged_gqa_decode 28) on two engines (equal streams, logprob bits and
    drops), one GRPO step, the assignments dropped at the config's capacity
    factor 1.25 in each (live tokens only in decode), the peak memory, and
    the fp32 check on its first P14_MOE_TF_LAYERS layers.
15. encdec: seamless-m4t-large-v2 at its full published size in bf16 (24
    encoder and 24 decoder layers, d=1024, 16/16 heads of 64, a gelu MLP of
    8192, V=256206 untied; random weights from seed 0, drawn on the card;
    NUM_TENANTS adapters with b ~ N(0, 0.02^2)), through launch.specs' step
    builders, since the engines refuse the family. (a) The kernels at its
    shapes against their plain versions, timed: gqa_decode (16/16 heads of
    64, a 512-token cache, bf16 and fp32), sgmv at 1024->1024, 1024->8192
    and 8192->1024 in decode and prefill, token_logprob forward and
    backward at V=256206 (R 624 and 4096) on the untied head and on a view
    of a head whose rows are padded to a multiple of 8, with the route
    each W took, as w_feed picks it and the launchers report it (the padded
    head's forward and every backward chunk must take W by TMA). (b) A
    served round: 16 gsm8k prompts on 4 of the
    stacked adapters, 128 seeded N(0, 1) frames a row for the stub audio
    frontend, build_prefill_step (the cross-attention memory into the
    cache) and 32 build_decode_step steps sampled by the port's sampler;
    gqa_decode 24 launches a decode step (the cross-attention is plain, as
    in the JAX package), sgmv 144 a forward (none in the encoder); decode
    ms/step, prefill ms and launch.analytic's FLOPs of the round over its
    wall time as a share of the card's peak. (c) 4 of its rows teacher-forced
    in fp32 with their frames, card against CPU, within TF_TOL. (d) One
    LoRA GRPO step through build_train_step (32 rows x 512 tokens, 128
    frames; token_logprob 1 forward and 1 backward launch): every adapter
    leaf moves, its time and analytic share of peak; then the same step on
    a contiguous copy of the head and again on the padded one, timed
    alone: the same bits, and W by TMA in every backward chunk on the
    padded head and in none on the contiguous one. (e) The same step at
    remat_block 4 (6 blocks of 4): loss and gradient against (d) within
    phase 7's bf16 tolerances, and both peaks of memory.
16. sharding (launch.mesh, launch.shardings, train.sharding). (a) The dry
    run (launch.dryrun, torch's fake process group on the meta device, no
    card work) of P16_CELLS at published size, started as subprocesses
    after the build in two lanes of one host core each (at the lowest
    priority) and read here:
    qwen3-0.6b train_4k on the multi-pod mesh twice, on a "cuda" and a
    "cpu" mesh (records equal but for timings, the card and the device
    type: the collective count does not depend on the mesh's device),
    qwen3-32b and zamba2-1.2b decode_32k, zamba2-1.2b and deepseek-moe-16b
    train_4k; each ok, with bytes per device under 80 GB, collectives and
    the dominant roofline term. (b) qwen3-0.6b's LoRA GRPO step and one multi-LoRA
    decode step through launch.specs on the host mesh (a (1, 1) mesh over
    NCCL, world size 1; everything placed by the specs as DTensors; the
    kernels take them through their wrappers' boundary), against the same
    steps without a mesh: the same bits (loss and metrics, new adapters,
    AdamW's first moment; logits and cache) and the same kernel launches,
    each step timed with and without the mesh.
17. entry points and steady state. (a) The four entry points of
    repro_torch.launch that stand for examples/ (quickstart --steps 2 and
    serve_multi_lora --tenants 4 at qwen3-0.6b full width in bf16;
    failover_demo and rl_learning_demo at their examples' reduced fp32
    granite) as subprocesses on the card, all at once: each exits 0, and
    each kernel on its path launched (its own "launches" line); the
    failover demo's row account balances (it raises otherwise); the
    learning demo's SFT loss and reward first5/last5 are recorded, not
    asserted. (b) analysis.RecompileSentinel over steady-state continuous
    decode (phase 8's engine: paged pool, 16 slots, 16 rows decoding):
    after P17_WARM decode steps, P17_STEPS steps with no new launch plan,
    library load or step signature, and the same synchronizing calls in
    every step (set_sync_debug_mode), plus the block table's upload in the
    steps whose table changed; the number and where each comes from.
18. the port's last gaps against the JAX package. (a) The sampler in both
    threefry layouts (rollout/prng.py's threefry_partitionable): 16 rows of
    random logits at qwen3-0.6b's V=151936, the random bits and uniforms
    drawn on the card bit-equal to the CPU's, _sample_rows' tokens equal,
    the layouts' tokens different. (b) launch.multi_tenant_train at
    qwen3-0.6b with the paged pool's flags (pages of 32, 128 pages, no
    prefix cache, no restores, no snapshot budget; 2 tenants, 1 step) as a
    fifth subprocess beside phase 17 (a)'s four: exit 0, the pool it asked
    for printed, every tenant at v1, no prefix hit, paged_gqa_decode, sgmv
    and both token_logprob directions launched and gqa_decode not. (c)
    forward_seq(inputs_embeds=params["embed"][tokens]) at qwen3-0.6b's full
    width in bf16 under 4 tenants' adapters: bit-equal to forward_seq(tokens),
    sgmv 168 launches. Prints each part's seconds beside the card's line.
It prints the kernels' JSON line and the card's line before the last, and as
the last line {"ok": true, "device": {...}}.
"""
import gc
import json
import random
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

PEAKS = None            # the card's data-sheet peaks (launch.roofline), set in main
ARCH = "qwen3-0.6b"
TENANTS, PER_TENANT, MAX_NEW, MAX_LEN = 4, 4, 32, 256
B_SCALE = 0.02          # adapter b ~ N(0, B_SCALE^2): a delta of ~10% of a projection
TF_ROWS = 4             # rows teacher-forced in phase 5
TF_TOL = 1e-3           # fp32 logprobs, card (kernels) vs CPU (plain versions)
GROUPS, GROUP_SIZE, TRAIN_ITERS = 4, 4, 3      # phase 6: GRPO groups per batch
LR = 3e-3               # the JAX package's TaskSpec default
METRIC_TOL = 1e-4       # phase 7: fp32 loss and metrics, card vs CPU (absolute)
GRAD_TOL = 1e-3         # phase 7: gradient max abs diff / gradient norm
BF16_GRAD_TOL = 1e-2    # phase 7, bf16: the same ratio at phase 3's bf16 dh factor
BF16_METRIC_TOL = 1e-3  # phase 7, bf16: loss and metrics, forward kernel vs plain
                        # forward (absolute; phase 3's bf16 logprob tolerance)
PROD_ROWS = 4096        # a production micro-batch of token rows (phase 3)
CONT_PER_TENANT, CONT_MAX_NEW, CONT_SLOTS = 8, 64, 16    # phase 8
CONT_MAX_LEN, PAGE, POOL_PAGES = 512, 16, 128            # paged pool
PREEMPT_AT = 10         # phase 8: preempt tenant-1 after this decode step
PAGED_TF_ROWS, PAGED_TF_STEPS = 4, 16                    # phase 9
RT_ENVS = ("gsm8k", "gsm8k", "amc12", "amc12")           # phase 10: tenants
RT_SPEC = dict(group_size=4, num_groups=2, max_new_tokens=32, target_steps=3)
# phase 10's cut runs: A takes 2 steps a tenant (it trains round-synchronously,
# so a commit is installed before the next round); B, C and D0 (asynchronous at
# staleness 1: a commit is installed only in a third round) take 16 new tokens
# a row; run D, which phase 13 compares with, keeps RT_SPEC
P10_CUT = {"A": dict(target_steps=2), "B": dict(max_new_tokens=16),
           "C": dict(max_new_tokens=16), "D0": dict(max_new_tokens=16)}
RT_SLOTS = 16
RT_RUNS = {"A": {},                                      # the defaults
           "B": dict(async_train=True, max_staleness=1, min_train_rows=4,
                     paged_kv=True, prefix_cache=False, kv_page_size=PAGE)}
# run C: run B with the prefix cache on (the JAX default with the paged pool);
# 8-token pages, since no gsm8k or amc12 prompt (5 to 11 tokens) fills one of 16
RT_RUNS["C"] = dict(RT_RUNS["B"], prefix_cache=True, kv_page_size=8)
# runs D0 and D: run C's settings over two gsm8k and two agentic tenants whose
# rows call tools (the biased sampler below); D0 with the stages off (frozen
# tool calls, fused refill), D with the prefill workers and the env stage on
RT_RUNS["D0"] = dict(RT_RUNS["C"])
RT_RUNS["D"] = dict(RT_RUNS["C"], disagg_prefill=True, prefill_workers=1,
                    env_stage=True, env_workers=2, max_turns=2)
RT_RUN_ENVS = {"D0": ("gsm8k", "gsm8k", "hopsearch", "hopsearch"),
               "D": ("gsm8k", "gsm8k", "hopsearch", "hopsearch")}
CALL_AT = (2, 9)        # phases 10 (D0, D) and 12: sampled-token counters at
                        # which the biased sampler emits tok.CALL
P12_ENVS = ("hopsearch", "gsm8k", "hopsearch", "gsm8k")  # phase 12: tenants
P12_MODES = {"F": {},                                   # fused, frozen calls
             "D": dict(disagg_prefill=True, prefill_workers=2,
                       prefill_chunk=16)}
P12_MODES["DE"] = dict(P12_MODES["D"], env_stage=True, env_workers=2)
P12_MODES["DER"] = dict(P12_MODES["DE"], resume_restore=False)
# DED: DE on the dense cache, with 8-token chunks so that the replays of the
# second tool turn (15 tokens) prefill in two chunks on the workers
P12_MODES["DED"] = dict(P12_MODES["DE"], paged_kv=False, prefill_chunk=8)
P12_FP32_MODES = ("F", "DE", "DER", "DED")
P12_FP32_NEW = 16       # new tokens a row in phase 12's fp32 card check
P12_MAX_NEW = 32        # new tokens a row in phase 12's bf16 modes (phase 8: 64)
# phase 13: run T is run D traced; run R is run T with chaos, a snapshot after
# every commit and a crash after P13_FAIL_AFTER commits, through
# run_with_recovery
P13_RUNS = {"T": dict(RT_RUNS["D"], trace=True)}
RT_RUN_ENVS["T"] = RT_RUN_ENVS["D"]
# phase 14 (a): run D's settings on zamba2-1.2b
P14_RUNS = {"Z": dict(RT_RUNS["D"])}
RT_RUN_ENVS["Z"] = RT_RUN_ENVS["D"]
ALL_RUNS = dict(RT_RUNS, **P13_RUNS, **P14_RUNS)
P13_CHAOS = dict(seed=0, prefill_worker_kill=1.0, env_worker_kill=1.0,
                 tool_error_transient=1.0, snapshot_drop=1.0,
                 max_faults_per_site=1)
P13_FAIL_AFTER, P13_KEEP = 6, 2   # crash after the 6th commit; snapshots kept
# snapshot_drop fires only where a row's pages go to a host snapshot
# (engine._snapshot_row): the prefix cache parks rows in the pool, and run D's
# dense-equivalent pool never spills one, so the site is never reached (the
# CPU run of the same schedule gives 0)
P13_SNAPSHOT_DROPS = 0
P11_PROMPTS, P11_GROUP, P11_HEADER = 2, 4, 128   # phase 11: 4 tenants x 2 prompts
P11_MAX_NEW, P11_LATE_AT = 64, 4                 # x groups of 4 = 32 rows
P11_SMALL_POOL = 48     # pages: less than the resident set plus the index
P11_FP32_NEW = 32       # new tokens a row in phase 11's fp32 card check
P14_HYBRID, P14_SSM, P14_MOE = "zamba2-1.2b", "mamba2-780m", "deepseek-moe-16b"
P14_MOE_TF_LAYERS = 4   # phase 14 (c): depth of the fp32 card-vs-CPU check (the
                        # full 28 layers hold 67.6 GB in fp32, too much for the
                        # host's memory beside the card's copy)


def log(msg):
    print(msg, flush=True)


def bench_ms(fn, arg_sets, iters=40, warmup=3):
    """Mean milliseconds per eager call of fn(*args), host included, cycling
    through arg_sets (several copies of the inputs, so that their total
    exceeds the 50 MB L2 and each call finds its inputs cold, as each layer
    does in decode). Small kernels are host-bound here: this is what the
    eager main path pays per call."""
    import torch
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, arg_sets, iters=40):
    """Mean device milliseconds of fn(*args): `iters` calls, cycling through
    arg_sets, captured in one CUDA graph and timed by replaying it, so that
    no host (Python wrapper) time sits between the launches."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:3]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def copies_for(nbytes, floor=2):
    """How many input copies exceed the 50 MB L2 twice over."""
    return max(floor, int(100e6 // max(nbytes, 1)) + 1)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / PEAKS.hbm_bytes_per_s
    t_ops = flops / PEAKS.flops[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


_TEMPLATE_ARG = re.compile(r"f|13__nv_bfloat16|Lb([01])E|Li(\d+)E")


def demangled(mangled):
    """A kernel's name and its template arguments (float, bf16, bool and int
    ones) out of its mangled form: _Z<n><name>I...E..., or
    _ZN<n><namespace><n><name>I...E...; as it is otherwise."""
    m = re.match(r"_ZN?(\d+)", mangled)
    if not m:
        return mangled
    i, n = m.end(), int(m.group(1))
    name, tail = mangled[i:i + n], mangled[i + n:]
    if name.startswith("_GLOBAL__N") and mangled.startswith("_ZN"):
        k = re.match(r"(\d+)", tail)
        if k:
            name, tail = tail[k.end():k.end() + int(k.group(1))], \
                tail[k.end() + int(k.group(1)):]
    if tail.startswith("I"):
        args, at = [], 1
        while (a := _TEMPLATE_ARG.match(tail, at)) and not tail.startswith("E", at):
            text = a.group(0)
            args.append("float" if text == "f" else "bf16" if "bfloat16" in text
                        else ("true" if a.group(1) == "1" else "false")
                        if a.group(1) is not None else a.group(2))
            at = a.end()
        if args and tail.startswith("E", at):
            name += "<" + ", ".join(args) + ">"
    return name


def ptxas_kernels(text):
    """[(kernel, registers, spill-store bytes)] from nvcc's -Xptxas -v
    output; kernel names read out of their mangled form."""
    out = []
    for line in text.splitlines():
        if "Compiling entry function '" in line:
            mangled = line.split("'")[1]
            out.append([demangled(mangled), 0, 0])
        elif out and "bytes spill stores" in line:
            out[-1][2] = int(line.split("bytes spill stores")[0].split(",")[-1])
        elif out and "Used " in line:
            out[-1][1] = int(line.split("Used ")[1].split()[0])
    return [tuple(k) for k in out]


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def same_bits(torch, a, b):
    bits = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    return torch.equal(a.view(bits), b.view(bits))


def plan_record(plan):
    return dict(chunk=plan.chunk, splits=plan.splits,
                blocks=plan.splits * plan.grid[1] * plan.grid[2], warps=plan.warps)


def decode_call(mod, fn, *args, **kw):
    """fn(*args, **kw) twice: (output, CUDA kernels the first call launched,
    whether the two calls gave the same bits)."""
    import torch
    n = mod.CUDA_LAUNCHES.n
    out = fn(*args, **kw)
    n = mod.CUDA_LAUNCHES.n - n
    again = fn(*args, **kw)
    torch.cuda.synchronize()
    return out, n, same_bits(torch, out, again)


def decode_rates(rec, nbytes, flops, dtype):
    """The case's bound, achieved GB/s and share of the bound (from its
    measured kernel ms)."""
    rec["bound_ms"], rec["bound_by"] = bound_ms(nbytes, flops, dtype)
    rec["gb_s"] = nbytes / (rec["ms"] * 1e-3) / 1e9
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]


def chunk_sweep(gqa, mod, plan, capacity, page, B, H, hd, kern, sets):
    """Device ms of a decode kernel at its plan's chunk and at half and twice
    it, each patched in for the wrapper module's decode_plan in turn."""
    plan_fn = mod.decode_plan
    half = max(page, plan.chunk // 2 // page * page)
    out = []
    for chunk in sorted({half, plan.chunk, 2 * plan.chunk}):
        splits = -(-capacity // chunk)
        c = gqa.DecodePlan(chunk, splits, (splits,) + tuple(plan.grid[1:]),
                           B * H * splits * (hd + 2) * 4 if splits > 1 else 0,
                           plan.warps)
        mod.decode_plan = lambda *a, c=c, **k: c
        try:
            ms = device_ms(kern, sets)
        finally:
            mod.decode_plan = plan_fn
        out.append(dict(plan_record(c), ms=ms, plan=chunk == plan.chunk))
    return out


def _sweep_line(sweep):
    return "    at other chunks (chunk/splits: ms): " + ", ".join(
        f"{c['chunk']}/{c['splits']}: {c['ms']:.4f}" + (" (plan)" if c["plan"] else "")
        for c in sweep)


def check_gqa_decode(torch, gqa, ref, g, serve_pos_hi):
    """gqa_decode against its plain version at B=16 H=16 KVH=8 hd=128: the
    serving shape (cache 256, pos up to the serving length) and long caches
    (S=1000 and 4096, pos 1 to S), bf16 and fp32, softcap 50 and window 24
    beside the plain case. Every case: two calls give the same bits and a
    call launches one CUDA kernel; each is timed (kernel, plain, SDPA where
    no softcap, eager call) with its plan, GB/s and share of the bound; the
    bf16 long caches also at half and twice the plan's chunk."""
    B, H, KVH, hd = 16, 16, 8, 128
    cases = []
    for S in (256, 1000, 4096):
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
            for cap, win in ((0.0, 0), (50.0, 0), (0.0, 24)):
                main = S == 256 and dt == torch.bfloat16 and not cap and not win
                hi = serve_pos_hi if main else S
                pos = torch.randint(1, hi + 1, (B,), generator=g, device="cuda",
                                    dtype=torch.int32)
                pos[0], pos[-1] = 1, hi
                q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
                elt = q.element_size()
                n_copy = copies_for(2 * B * S * KVH * hd * elt)
                caches = [(torch.randn(B, S, KVH, hd, generator=g, device="cuda").to(dt),
                           torch.randn(B, S, KVH, hd, generator=g, device="cuda").to(dt))
                          for _ in range(n_copy)]
                ck, cv = caches[0]
                got, n_cuda, same = decode_call(gqa, gqa.gqa_decode, q, ck, cv, pos,
                                                softcap=cap, window=win)
                want = ref.gqa_decode_ref(q, ck, cv, pos, softcap=cap, window=win)
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                ok = bool((err <= tol + tol * want.float().abs()).all())
                if not ok or not same or n_cuda != 1:
                    raise AssertionError(f"gqa_decode S={S} {dt} cap={cap} win={win}: "
                                         f"max err {err.max().item():.3e} (tol {tol}), "
                                         f"same bits {same}, CUDA launches {n_cuda}")
                sets = [(q, k, v, pos) for k, v in caches]

                def kern(q, k, v, p):
                    return gqa.gqa_decode(q, k, v, p, softcap=cap, window=win)

                def plain(q, k, v, p):
                    return ref.gqa_decode_ref(q, k, v, p, softcap=cap, window=win)
                k_ms = device_ms(kern, sets)
                p_ms = device_ms(plain, sets, 40 if S < 4096 else 10)
                call_ms = bench_ms(kern, sets)
                lib_ms = None
                if not cap:
                    idx = torch.arange(S, device="cuda")
                    p64 = pos.long()[:, None]
                    valid = idx[None, :] < p64
                    if win:
                        valid &= (p64 - 1 - idx[None, :]) < win
                    mask = valid[:, None, None, :]

                    def sdpa(q, k, v, p, mask=mask):
                        return torch.nn.functional.scaled_dot_product_attention(
                            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                            attn_mask=mask, enable_gqa=True)
                    lib_ms = device_ms(sdpa, sets)
                lo = (pos.long() - win).clamp(min=0) if win else torch.zeros_like(pos.long())
                keys = int((pos.long().clamp(max=S) - lo).sum())
                nbytes = (2 * q.numel() * elt + 2 * keys * KVH * hd * elt + 4 * B)
                flops = 4 * keys * (H // KVH) * KVH * hd
                dname = str(dt).split(".")[1]
                plan = gqa.decode_plan(B, KVH, S, 1, H=H, hd=hd, window=win)
                rec = dict(S=S, dtype=dname, softcap=cap, window=win, pos_max=hi,
                           main=main, max_abs_err=float(err.max()), tol=tol,
                           ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, call_ms=call_ms,
                           cuda_launches_per_call=n_cuda, plan=plan_record(plan))
                decode_rates(rec, nbytes, flops, dname)
                line = (f"  gqa_decode S={S:4d} {dname:8s} cap={cap:4.0f} win={win:2d}: "
                        f"err {rec['max_abs_err']:.2e} (tol {tol}), same bits, "
                        f"{n_cuda} CUDA launch; plan {rec['plan']}; kernel {k_ms:.4f} ms "
                        f"plain {p_ms:.4f} ms library "
                        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms bound "
                        f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
                        f"{rec['gb_s']:.0f} GB/s = {rec['bound_share']:.2f} of the bound; "
                        f"eager call {call_ms:.4f} ms")
                if S > 256 and dt == torch.bfloat16 and not cap and not win:
                    rec["split_ms"] = chunk_sweep(gqa, gqa, plan, S, 1, B, H, hd,
                                                  kern, sets)
                    line += "\n" + _sweep_line(rec["split_ms"])
                cases.append(rec)
                log(line)
    return cases


def check_decode_edges(torch, gqa, paged, ref, g):
    """Both decode kernels at qwen3's widths over a 2048-key cache (page 16)
    holding the same values, as a contiguous cache and as a shuffled pool:
    rows at pos 1, chunk-1, chunk, chunk+1 and the capacity; no softcap,
    softcap 50, windows of 24 (one chunk a row), 200 (two chunks, across an
    edge) and 5 (smaller than a page); bf16 and fp32. Each against its plain version, two
    calls with the same bits."""
    B, H, KVH, hd, cap, page = 6, 16, 8, 128, 2048, 16
    n_pg = cap // page
    chunk = gqa.decode_plan(B, KVH, cap, page, H=H, hd=hd).chunk
    pos = torch.tensor([1, chunk - 1, chunk, chunk + 1, 3 * chunk + 5, cap],
                       dtype=torch.int32, device="cuda")
    out = []
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
        ck = torch.randn(B, cap, KVH, hd, generator=g, device="cuda").to(dt)
        cv = torch.randn(B, cap, KVH, hd, generator=g, device="cuda").to(dt)
        perm = torch.randperm(B * n_pg, generator=g, device="cuda")
        kp = torch.full((B * n_pg + 1, page, KVH, hd), 7.0, device="cuda", dtype=dt)
        vp = torch.full_like(kp, -7.0)
        kp[perm] = ck.reshape(-1, page, KVH, hd)
        vp[perm] = cv.reshape(-1, page, KVH, hd)
        tbl = perm.reshape(B, n_pg).to(torch.int32)
        live = (pos.long() + page - 1) // page
        tbl[torch.arange(n_pg, device="cuda")[None, :] >= live[:, None]] = B * n_pg
        dname = str(dt).split(".")[1]
        worst = 0.0
        for sc, win in ((0.0, 0), (50.0, 0), (0.0, 24), (0.0, 200), (0.0, 5)):
            for name, mod, fn, args, plain in (
                    ("gqa_decode", gqa, gqa.gqa_decode, (q, ck, cv, pos),
                     ref.gqa_decode_ref),
                    ("paged_gqa_decode", paged, paged.paged_gqa_decode,
                     (q, kp, vp, tbl, pos), ref.paged_gqa_decode_ref)):
                got, _, same = decode_call(mod, fn, *args, softcap=sc, window=win)
                want = plain(*args, softcap=sc, window=win)
                err = (got.float() - want.float()).abs()
                if not bool((err <= tol + tol * want.float().abs()).all()) or not same:
                    raise AssertionError(f"{name} edges {dname} cap={sc} win={win}: "
                                         f"max err {err.max().item():.3e} (tol {tol}), "
                                         f"same bits {same}")
                worst = max(worst, float(err.max()))
                out.append(dict(kernel=name, case="edges", dtype=dname, softcap=sc,
                                window=win, main=False, max_abs_err=float(err.max()),
                                tol=tol))
        log(f"  decode edges {dname}: pos {pos.tolist()} (chunk {chunk}), cap 0/50, "
            f"window 0/24/200/5, both kernels: max err {worst:.2e} (tol {tol}), "
            f"same bits")
    return out


SGMV_PAIRS = [(1024, 2048), (1024, 1024), (1024, 1024), (2048, 1024),
              (1024, 6144), (3072, 1024)]   # q, k, v, o, mlp_in, mlp_out
SGMV_SCALE = 2.0        # qwen3-0.6b's LoRA scaling (alpha 32 / rank 16)


def sgmv_bytes(R, T_live, d, dout, r, x_bytes, add):
    """Bytes an sgmv call must move: the rows, each live adapter's A and B,
    the segment table, and the output: the fp32 product written (sgmv), or
    y read and written in the rows' dtype (sgmv_add_)."""
    out = 2 * R * dout * x_bytes if add else 4 * R * dout
    return R * d * x_bytes + T_live * (d * r + r * dout) * 4 + 4 * R + out


def _add_close(got, want, delta):
    """sgmv_add_ against its plain version: fp32 rows at rtol 1e-5, atol
    1e-4; bf16 rows may also differ by one bf16 step (2^-7 of the value) of
    the delta's and the sum's rounding, where the two fp32 products differ
    in their last bits and round the other way. Returns the max abs
    difference, or raises."""
    import torch
    err = (got.float() - want.float()).abs()
    tol = 1e-4 + 1e-5 * want.float().abs()
    if got.dtype == torch.bfloat16:
        top = torch.maximum(got.float().abs(), want.float().abs())
        tol = tol + 2.0 ** -7 * (top + delta.abs())
    if not bool((err <= tol).all()):
        raise AssertionError(f"sgmv_add_: max err {err.max().item():.3e}")
    return float(err.max())


def sgmv_plan_sweep(sgmv, plan, d, dout, fn, sets):
    """Device ms of sgmv_add_ at its plan and with the column tile halved and
    doubled (the cluster from the tiles as the plan sets it), and with
    clusters of 4, each patched in for the wrapper module's plan in turn."""
    plan_fn = sgmv.sgmv_plan
    out = []
    for bn in sorted({max(64, plan.bn // 2), plan.bn, min(1024, plan.bn * 2)}):
        tiles_n = -(-dout // bn)
        for c in sorted({sgmv.cluster_for(tiles_n), 4}):
            groups = -(-tiles_n // c)
            kc = sgmv._stage(plan.bm, bn, 16, 2, c, sgmv.slice_of(d, c))
            p = plan._replace(bn=bn, kc=kc, cluster=c, col_groups=groups,
                              grid=(groups * c, plan.row_tiles))
            sgmv.sgmv_plan = lambda *a, p=p, **k: p
            sgmv._plan_args.cache_clear()
            try:
                ms = device_ms(fn, sets)
            finally:
                sgmv.sgmv_plan = plan_fn
                sgmv._plan_args.cache_clear()
            out.append(dict(bn=bn, cluster=c, kc=kc, ms=ms,
                            plan=(bn, c) == (plan.bn, plan.cluster)))
    return out


def check_sgmv(torch, sgmv, ref, g, S_p, specs=None):
    """Both epilogues of the sgmv kernel against their plain versions: sgmv
    (the fp32 product) and sgmv_add_ (the scaled delta added into y in place,
    as the serving path calls it). Cases: the six projections at decode
    (R=16, 4 rows of each of 4 adapters) and at the served prefill (R=16 x
    the prompt bucket), mlp_in with fp32 rows, one row a slot (R=16, T=16),
    a continuous-prefill size (R=2048, T=4) and phase 11's radix suffix
    prefill (one row's 8-token bucket, one live adapter of 4). Each case:
    the plan, one CUDA launch a call, two calls' bits, sgmv_add_ bit-equal
    to sgmv followed by the torch composition, and the times of both epilogues,
    their plain versions, the library yardstick (a gather and two bmm; for
    sgmv_add_ also the scale and the add), the eager call (sgmv_add_ as the
    batched LoraCtx calls it: adapters checked once a forward, autograd
    off; sgmv as a user calls it, with its checks) and the bound.
    `specs` replaces the case list (phase 14's projections)."""
    r = 16
    bf16 = torch.bfloat16
    if specs is None:
        specs = [(16, 4, d, dout, bf16, "decode") for d, dout in SGMV_PAIRS]
        specs += [(16 * S_p, 4, d, dout, bf16, "prefill") for d, dout in SGMV_PAIRS]
        specs += [(16, 4, 1024, 6144, torch.float32, "decode fp32"),
                  (16, 16, 1024, 6144, bf16, "one row a slot"),
                  (2048, 4, 1024, 6144, bf16, "continuous prefill"),
                  (8, 4, 1024, 6144, bf16, "radix suffix")]

    def gathered_bmm(x, a, b, ids):
        il = ids.long()
        return torch.bmm(torch.bmm(x.float()[:, None, :], a[il]), b[il])[:, 0]

    def lib_add(y, x, a, b, ids):
        return y.add_((gathered_bmm(x, a, b, ids) * SGMV_SCALE).to(x.dtype))

    def plain_add(y, x, a, b, ids):
        return ref.sgmv_add_ref(y, x, a, b, ids, SGMV_SCALE)

    def kern_a(x, a, b, ids, table):
        return sgmv.sgmv(x, a, b, ids, table=table)

    def kern_b(y, x, a, b, table):
        return sgmv.sgmv_add_(y, x, a, b, table, SGMV_SCALE)

    def path_b(y, x, a, b, table):
        # as the batched LoraCtx calls it: adapters checked once a forward,
        # autograd off (the engines serve under no_grad or inference_mode)
        with torch.no_grad():
            return sgmv.sgmv_add_(y, x, a, b, table, SGMV_SCALE, checked=True)

    cases = []
    for R, T, d, dout, xdt, label in specs:
        ids = torch.arange(T, device="cuda", dtype=torch.int32).repeat_interleave(R // T)
        if label == "radix suffix":      # phase 11's suffix prefill: one row
            ids = torch.full((R,), 1, device="cuda", dtype=torch.int32)
        x = torch.randn(R, d, generator=g, device="cuda").to(xdt)
        y0 = torch.randn(R, dout, generator=g, device="cuda").to(xdt)
        n_copy = copies_for(4 * T * r * (d + dout))
        ads = [(torch.randn(T, d, r, generator=g, device="cuda") / d ** 0.5,
                torch.randn(T, r, dout, generator=g, device="cuda") * 0.1)
               for _ in range(n_copy)]
        a, b = ads[0]
        table = sgmv.sgmv_table(ids, T)
        n0 = sgmv.CUDA_LAUNCHES.n
        got = kern_a(x, a, b, ids, table)
        launches_a = sgmv.CUDA_LAUNCHES.n - n0
        again = kern_a(x, a, b, ids, table)
        y = y0.clone()
        n0 = sgmv.CUDA_LAUNCHES.n
        kern_b(y, x, a, b, table)
        launches_b = sgmv.CUDA_LAUNCHES.n - n0
        y_again = kern_b(y0.clone(), x, a, b, table)
        want = ref.sgmv_ref(x, a, b, ids)
        want_b = plain_add(y0.clone(), x, a, b, ids)
        composed = y0 + (got * SGMV_SCALE).to(xdt)
        torch.cuda.synchronize()
        name = f"sgmv R={R} T={T} {d}->{dout} {str(xdt).split('.')[1]}"
        if (launches_a, launches_b) != (1, 1):
            raise AssertionError(f"{name}: {launches_a} and {launches_b} CUDA "
                                 f"launches a call, want 1")
        if not (same_bits(torch, got, again) and same_bits(torch, y, y_again)):
            raise AssertionError(f"{name}: two calls gave other bits")
        if not same_bits(torch, y, composed):
            raise AssertionError(f"{name}: sgmv_add_ is not sgmv followed by "
                                 f"y + (s * d).to(x.dtype)")
        err = (got - want).abs()
        if not bool((err <= 1e-4 + 1e-5 * want.abs()).all()):
            raise AssertionError(f"{name}: max err {err.max().item():.3e}")
        err_b = _add_close(y, want_b, want * SGMV_SCALE)

        sets_a = [(x, a_, b_, ids, table) for a_, b_ in ads]
        sets_b = [(y, x, a_, b_, table) for a_, b_ in ads]
        sets_p = [(y, x, a_, b_, ids) for a_, b_ in ads]
        plain_iters = 10 if R > 256 else 40
        rec = dict(label=label, R=R, T=T, d=d, dout=dout, r=r,
                   x_dtype=str(xdt).split(".")[1],
                   main=(label, d, dout) == ("decode", 1024, 6144),
                   plan=sgmv.sgmv_plan(R, T, d, dout, r=r,
                                       x_bytes=x.element_size())._asdict(),
                   cuda_launches_per_call=launches_b, same_bits=True,
                   add_equals_composition=True,
                   max_abs_err=float(err.max()), tol=1e-4, add_max_abs_err=err_b,
                   ms=device_ms(kern_b, sets_b),
                   plain_ms=device_ms(plain_add, sets_p, iters=plain_iters),
                   library_ms=device_ms(lib_add, sets_p, iters=plain_iters),
                   call_ms=bench_ms(path_b, sets_b),
                   a_ms=device_ms(kern_a, sets_a),
                   a_plain_ms=device_ms(ref.sgmv_ref, [t[1:] for t in sets_p],
                                        iters=plain_iters),
                   a_library_ms=device_ms(gathered_bmm, [t[1:] for t in sets_p],
                                          iters=plain_iters),
                   a_call_ms=bench_ms(kern_a, sets_a))
        flops = 2 * R * (d * r + r * dout)
        for key, add in (("", True), ("a_", False)):
            nb = sgmv_bytes(R, T, d, dout, r, x.element_size(), add)
            b_ms, b_by = bound_ms(nb, flops, "float32")
            rec[key + "bound_ms"], rec[key + "bound_by"] = b_ms, b_by
            rec[key + "bytes"] = nb
            rec[key + "gb_s"] = nb / (rec[key + "ms"] * 1e-3) / 1e9
            rec[key + "bound_share"] = b_ms / rec[key + "ms"]
        if rec["main"] or label == "continuous prefill":
            rec["plan_sweep"] = sgmv_plan_sweep(
                sgmv, sgmv.sgmv_plan(R, T, d, dout), d, dout, kern_b, sets_b)
        cases.append(rec)
        p = rec["plan"]
        log(f"  {name} ({label}): plan bm {p['bm']} bn {p['bn']} cluster "
            f"{p['cluster']} grid {p['grid']}; err {rec['max_abs_err']:.2e}, add "
            f"{err_b:.2e}; 1 CUDA launch a call, same bits\n"
            f"    sgmv_add_ {rec['ms'] * 1e3:.2f} us (eager {rec['call_ms'] * 1e3:.1f} "
            f"us) plain {rec['plain_ms'] * 1e3:.1f} library {rec['library_ms'] * 1e3:.1f} "
            f"bound {rec['bound_ms'] * 1e3:.2f} us ({rec['bound_share']:.2f}); "
            f"sgmv {rec['a_ms'] * 1e3:.2f} us (eager {rec['a_call_ms'] * 1e3:.1f} us) "
            f"plain {rec['a_plain_ms'] * 1e3:.1f} library {rec['a_library_ms'] * 1e3:.1f} "
            f"bound {rec['a_bound_ms'] * 1e3:.2f} us ({rec['a_bound_share']:.2f})")
        if "plan_sweep" in rec:
            log("    sgmv_add_ at other column tiles and clusters (bn/cluster: us): "
                + ", ".join(f"{c['bn']}/{c['cluster']}: {c['ms'] * 1e3:.2f}"
                            + (" (plan)" if c["plan"] else "")
                            for c in rec["plan_sweep"]))
    return cases


def check_token_logprob(torch, tlp, ref, g, R_main, cases=None):
    """Forward and backward kernels against their plain versions. Timed at
    the smoke's training batch (R_main token rows) and a production
    micro-batch (PROD_ROWS), qwen3-0.6b widths in bf16 with the tied
    embedding's transpose as W; checked also at small V in fp32, with a
    softcap and with an untied head. Tolerances: logprob/entropy/lse 1e-3
    bf16 and 1e-4 fp32 absolute (fp32 accumulation both sides, sum order
    only); dh 1e-2 (bf16: dz rounds to bf16 before dz @ W^T) and 1e-4 (fp32)
    of dh's largest element. Two forward calls and two backward calls must
    give the same bits. Each record carries the CUDA kernels one call
    launched, as the C launchers count them (a forward call must launch 2:
    the kernel and the merge), and the backward's the scratch one call
    allocated (peak allocator bytes less dh); the bf16 backward's scratch
    must stay within tlp.SCRATCH_LIMIT and its launches must match its plan
    (two products per vocab chunk and a reduce). Each record carries W's
    route as tlp.w_feed picks it ("feed": TMA, the kernel's cp.async copies
    and their width, or 2-byte loads) and how the launchers loaded W
    (tlp.FWD_W_VECTOR, tlp.BWD_W_VECTOR: the vocab chunks loaded by TMA or
    16-byte copies), which must agree; a head padded to a multiple of 8 a
    row must take TMA in the forward and in every backward chunk. The bf16
    records also carry their plans (forward: vocab slices and blocks; backward: vocab
    chunk, K-splits, planned scratch) and, where timed, the TFLOP/s.
    `cases` (R, d, V, dtype, softcap, layout, timed) replaces the case list
    (phase 14's widths and vocabularies); none of them is then the main
    case."""
    import torch.nn.functional as F
    d, V = 1024, 151936
    fwd_cases, bwd_cases = [], []
    main_cases = cases is None
    if cases is None:
        cases = [(R_main, d, V, torch.bfloat16, 0.0, "tied", True),
                 (PROD_ROWS, d, V, torch.bfloat16, 0.0, "tied", True),
                 (300, d, 5003, torch.float32, 0.0, "tied", False),
                 (300, d, 5003, torch.bfloat16, 30.0, "tied", False),
                 (300, d, 5003, torch.float32, 30.0, "untied", False),
                 (300, d, 5003, torch.bfloat16, 0.0, "untied", False)]
    for R, d, Vc, dt, cap, layout, timed in cases:
        h = torch.randn(R, d, generator=g, device="cuda").to(dt)
        if layout == "tied":     # the embedding table [V, d] read as W = table.T
            w = (torch.randn(Vc, d, generator=g, device="cuda") * 0.02).to(dt).T
        elif layout == "untied":
            w = (torch.randn(d, Vc, generator=g, device="cuda") * 0.02).to(dt)
        else:                    # "padded": a [:, :V] view of rows padded to 8
            w = (torch.randn(d, -(-Vc // 8) * 8, generator=g, device="cuda")
                 * 0.02).to(dt)[:, :Vc]
        t = torch.randint(0, Vc, (R,), generator=g, device="cuda", dtype=torch.int32)
        g_lp = torch.randn(R, generator=g, device="cuda") / R
        g_ent = torch.randn(R, generator=g, device="cuda") / R
        n_fwd, v_fwd = tlp.FWD_CUDA_LAUNCHES.n, tlp.FWD_W_VECTOR.n
        lp, ent, lse = tlp.token_logprob_fwd(h, w, t, cap)
        n_fwd, v_fwd = tlp.FWD_CUDA_LAUNCHES.n - n_fwd, tlp.FWD_W_VECTOR.n - v_fwd
        fwd_again = tlp.token_logprob_fwd(h, w, t, cap)
        want_lp, want_ent, want_lse = ref.token_logprob_stats_ref(h, w, t, cap)
        dh = tlp.token_logprob_bwd(h, w, t, want_lse, want_ent, g_lp, g_ent, cap)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        n_bwd, v_bwd = tlp.BWD_CUDA_LAUNCHES.n, tlp.BWD_W_VECTOR.n
        dh_again = tlp.token_logprob_bwd(h, w, t, want_lse, want_ent, g_lp, g_ent,
                                         cap)
        n_bwd, v_bwd = tlp.BWD_CUDA_LAUNCHES.n - n_bwd, tlp.BWD_W_VECTOR.n - v_bwd
        torch.cuda.synchronize()
        scratch = torch.cuda.max_memory_allocated() - base - dh_again.nbytes
        want_dh = ref.token_logprob_bwd_ref(h, w, t, want_lse, want_ent, g_lp,
                                            g_ent, cap)
        torch.cuda.synchronize()
        bits = torch.int16 if dt == torch.bfloat16 else torch.int32
        if not torch.equal(dh.view(bits), dh_again.view(bits)):
            raise AssertionError(f"token_logprob R={R} V={Vc} {dt}: two backward "
                                 f"calls gave different bits")
        if not all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip((lp, ent, lse), fwd_again)):
            raise AssertionError(f"token_logprob R={R} V={Vc} {dt}: two forward "
                                 f"calls gave different bits")
        if n_fwd != 2:
            raise AssertionError(f"token_logprob R={R} V={Vc} {dt}: a forward call "
                                 f"launched {n_fwd} CUDA kernels (want 2)")
        tol = 1e-3 if dt == torch.bfloat16 else 1e-4
        dh_tol = 1e-2 if dt == torch.bfloat16 else 1e-4
        f_err = max(float((got - want).abs().max()) for got, want in
                    ((lp, want_lp), (ent, want_ent), (lse, want_lse)))
        dh_scale = float(want_dh.float().abs().max())
        b_err = float((dh.float() - want_dh.float()).abs().max())
        name = f"R={R} V={Vc} {str(dt).split('.')[1]} cap={cap:.0f} {layout}"
        if f_err > tol or b_err > dh_tol * dh_scale:
            raise AssertionError(f"token_logprob {name}: forward err {f_err:.3e} "
                                 f"(tol {tol}), dh err {b_err:.3e} (tol "
                                 f"{dh_tol} x {dh_scale:.3e})")
        shape = dict(R=R, d=d, V=Vc, dtype=str(dt).split(".")[1], softcap=cap,
                     layout=layout, main=main_cases and R == R_main and timed)
        # how the launchers loaded W, as they report it: a vocab chunk's tiles
        # by TMA or 16-byte copies ("vector"), or narrower ("scalar"); and
        # the bf16 route w_feed picked
        chunks = (n_bwd - 1) // 2 if dt == torch.bfloat16 else 1
        if dt == torch.bfloat16:
            feed = tlp.w_feed(w.data_ptr(), tuple(w.shape), w.stride())
            shape["feed"] = feed._asdict()
            wide = feed.width == 16       # TMA, or 16-byte copies
            if v_fwd != wide or v_bwd != chunks * wide:
                raise AssertionError(f"token_logprob R={R} V={Vc}: w_feed picked "
                                     f"{feed}, the launchers report 16-byte loads in "
                                     f"the forward {v_fwd}, in {v_bwd} of {chunks} "
                                     f"backward chunks")
        shape["staging"] = dict(
            forward="vector" if v_fwd else "scalar",
            backward=("vector" if v_bwd == chunks else "scalar" if not v_bwd
                      else "mixed"),
            backward_vector_chunks=v_bwd, backward_chunks=chunks)
        fc = dict(shape, max_abs_err=f_err, tol=tol, cuda_launches_per_call=n_fwd)
        bc = dict(shape, max_abs_err=b_err, tol=dh_tol * dh_scale,
                  cuda_launches_per_call=n_bwd, scratch_bytes=scratch)
        if dt == torch.bfloat16:
            fplan = tlp.forward_plan(R, Vc)
            fc.update(plan=dict(vsplit=fplan.vsplit, slice_tiles=fplan.slice_tiles,
                                blocks=-(-R // 128) * fplan.vsplit))
            plan = tlp.backward_plan(R, d, Vc)
            bc.update(plan=dict(vc=plan.vc, splits=plan.splits, piece=plan.piece,
                                chunks=-(-Vc // plan.vc),
                                scratch_bytes=plan.scratch_bytes))
            if scratch > tlp.SCRATCH_LIMIT or n_bwd != 2 * bc["plan"]["chunks"] + 1:
                raise AssertionError(f"token_logprob {name}: backward scratch "
                                     f"{scratch} B (limit {tlp.SCRATCH_LIMIT}), "
                                     f"{n_bwd} CUDA launches for plan {bc['plan']}")
            # what the padded head is for: W by TMA in the forward and in
            # every chunk of the backward, the ragged last one included
            if layout == "padded" and (shape["feed"]["route"] != "tma" or v_fwd != 1
                                       or v_bwd != chunks):
                raise AssertionError(f"token_logprob {name}: W by {shape['feed']}, "
                                     f"wide in the forward {v_fwd}, in {v_bwd} of "
                                     f"{chunks} backward chunks")
        name += " staging fwd {forward} bwd {backward}".format(**shape["staging"])
        if "feed" in shape:
            name += " feed {route}/{width}/{major}".format(**shape["feed"])
        line = f"  token_logprob {name}: fwd err {f_err:.2e} (tol {tol}) dh err " \
               f"{b_err:.2e} (tol {dh_tol} x {dh_scale:.2e}), two calls of each " \
               f"bit-identical; CUDA launches a call fwd {n_fwd} bwd {n_bwd}, bwd " \
               f"scratch {scratch / 2**20:.1f} MiB"
        if "plan" in bc:
            line += f"; fwd plan {fc['plan']}; bwd plan {bc['plan']}"
        if timed:
            elt = h.element_size()
            peak = str(dt).split(".")[1]
            sets = [(h, w, t)]
            bsets = [(h, w, t, want_lse, want_ent, g_lp, g_ent)]

            def kfwd(h, w, t):
                return tlp.token_logprob_fwd(h, w, t, cap)

            def pfwd(h, w, t):
                return ref.token_logprob_stats_ref(h, w, t, cap)

            def lfwd(h, w, t):
                logits = (h @ w).float()
                lp = -F.cross_entropy(logits, t.long(), reduction="none")
                ls = torch.log_softmax(logits, dim=-1)
                return lp, -(ls.exp() * ls).sum(-1)

            def kbwd(h, w, t, lse, ent, a, b):
                return tlp.token_logprob_bwd(h, w, t, lse, ent, a, b, cap)

            def pbwd(h, w, t, lse, ent, a, b):
                return ref.token_logprob_bwd_ref(h, w, t, lse, ent, a, b, cap)

            def lfwdbwd(h, w, t, lse, ent, a, b):
                hh = h.detach().requires_grad_(True)
                with torch.enable_grad():
                    lp, en = lfwd(hh, w, t)
                    return torch.autograd.grad((lp * a + en * b).sum(), hh)[0]

            it = 10 if R > 1000 else 20
            fc.update(ms=device_ms(kfwd, sets, it), call_ms=bench_ms(kfwd, sets, it),
                      plain_ms=device_ms(pfwd, sets, 3),
                      library_ms=device_ms(lfwd, sets, 5))
            lib_fb = device_ms(lfwdbwd, bsets, 5)
            bc.update(ms=device_ms(kbwd, bsets, it), call_ms=bench_ms(kbwd, bsets, it),
                      plain_ms=device_ms(pbwd, bsets, 3),
                      library_ms=max(lib_fb - fc["library_ms"], 0.0),
                      library_fwd_bwd_ms=lib_fb)
            w_bytes, h_bytes = d * Vc * elt, R * d * elt
            fb_ms, fb_by = bound_ms(w_bytes + h_bytes + 4 * R + 8 * R,
                                    2 * R * d * Vc, peak)
            bb_ms, bb_by = bound_ms(w_bytes + 2 * h_bytes + 4 * R + 16 * R,
                                    4 * R * d * Vc, peak)
            fc.update(bound_ms=fb_ms, bound_by=fb_by,
                      tflops=2 * R * d * Vc / fc["ms"] / 1e9)
            if dt == torch.bfloat16:     # the plan's split beside others
                fc["split_ms"] = forward_splits(torch, tlp, h, w, t, cap, it)
            bc.update(bound_ms=bb_ms, bound_by=bb_by,
                      tflops=4 * R * d * Vc / bc["ms"] / 1e9)
            line += (f"\n    forward: kernel {fc['ms']:.4f} ms (eager call "
                     f"{fc['call_ms']:.4f}) plain {fc['plain_ms']:.4f} library "
                     f"{fc['library_ms']:.4f} bound {fb_ms:.4f} ({fb_by}); "
                     f"{fc['tflops']:.1f} TFLOP/s"
                     f"\n    backward: kernel {bc['ms']:.4f} ms (eager call "
                     f"{bc['call_ms']:.4f}) plain {bc['plain_ms']:.4f} library "
                     f"{bc['library_ms']:.4f} (fwd+bwd {lib_fb:.4f}) bound "
                     f"{bb_ms:.4f} ({bb_by}); {bc['tflops']:.1f} TFLOP/s")
            if "split_ms" in fc:
                line += "\n    forward at other vocab splits (slices: ms): " + ", ".join(
                    f"{c['vsplit']}: {c['ms']:.4f}" + (" (plan)" if c["plan"] else "")
                    for c in fc["split_ms"])
        fwd_cases.append(fc)
        bwd_cases.append(bc)
        log(line)
    return fwd_cases, bwd_cases


def forward_splits(torch, tlp, h, w, t, cap, iters):
    """Device ms of the bf16 forward at its plan's vocab split and at half,
    twice and four times as many slices, in one run (each split patched in
    for forward_plan, which the wrapper calls)."""
    R, V = h.shape[0], w.shape[1]
    n_tiles = -(-V // 128)
    plan_fn = tlp.forward_plan
    plan = plan_fn(R, V)
    cands = {plan}
    for f in (0.5, 2, 4):
        per = -(-n_tiles // max(1, round(plan.vsplit * f)))
        cands.add(tlp.ForwardPlan(-(-n_tiles // per), per))
    out = []
    for c in sorted(cands):
        tlp.forward_plan = lambda R, V, c=c: c
        try:
            ms = device_ms(lambda h, w, t: tlp.token_logprob_fwd(h, w, t, cap),
                           [(h, w, t)], iters)
        finally:
            tlp.forward_plan = plan_fn
        out.append(dict(vsplit=c.vsplit, slice_tiles=c.slice_tiles,
                        blocks=-(-R // 128) * c.vsplit, ms=ms, plan=c == plan))
    return out


def _paged_case(torch, g, B, H, KVH, hd, page, max_pg, n_pool, pos_lo, pos_hi, dt,
                alias=0):
    """q, a pool of n_pool pages (+ scratch) handed out as a random
    permutation (no row's pages are contiguous), a block table with the
    sentinel past each row's live pages, and pos in [pos_lo, pos_hi]. With
    alias > 0 every row's first `alias` entries name the same pages."""
    pos = torch.randint(pos_lo, pos_hi + 1, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    pos[0], pos[-1] = pos_lo, pos_hi
    live = (pos.long() + page - 1) // page
    perm = torch.randperm(n_pool, generator=g, device="cuda").to(torch.int32)
    tbl = torch.full((B, max_pg), n_pool, dtype=torch.int32, device="cuda")
    at = alias
    for b in range(B):
        n = int(live[b])
        tbl[b, :alias] = perm[:alias]
        tbl[b, alias:n] = perm[at:at + n - alias]
        at += n - alias
    if at > n_pool:
        raise AssertionError(f"paged case needs {at} pages of {n_pool}")
    q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
    return q, pos, tbl


def check_paged_decode(torch, paged, gqa, ref, g):
    """paged_gqa_decode against its plain version: (a) the slice's shape,
    B=16 H=16 KVH=8 hd=128, page 16, 32 pages a row, a pool of 128 pages,
    pos 20-110; (b) long caches, 256 pages a row (4096 tokens), pos up to
    4096; (c) tables that alias shared prompt pages across rows; (d) an
    identity table, against the gqa_decode kernel on the same values; (e)
    softcap 50 and window 64. bf16 and fp32 each; two calls give the same
    bits and a call launches one CUDA kernel; (a) and (b) timed with their
    plans, GB/s and share of the bound, bf16 (b) also at half and twice the
    plan's chunk."""
    B, H, KVH, hd, page = 16, 16, 8, 128, 16
    cases = []
    specs = []
    for dt in (torch.bfloat16, torch.float32):
        specs += [("a", dt, 32, 128, 20, 110, 0.0, 0, 0),
                  ("b", dt, 256, B * 256, 1, 4096, 0.0, 0, 0),
                  ("c", dt, 32, 128, 40, 110, 0.0, 0, 2),
                  ("e", dt, 32, 128, 20, 110, 50.0, 64, 0)]
    for name, dt, max_pg, n_pool, lo, hi, cap, win, alias in specs:
        tol = 3e-2 if dt == torch.bfloat16 else 2e-5
        q, pos, tbl = _paged_case(torch, g, B, H, KVH, hd, page, max_pg, n_pool,
                                  lo, hi, dt, alias)
        elt = q.element_size()
        pool_bytes = 2 * (n_pool + 1) * page * KVH * hd * elt
        timed = name in ("a", "b")
        n_copy = copies_for(pool_bytes) if timed else 1
        pools = [(torch.randn(n_pool + 1, page, KVH, hd, generator=g,
                              device="cuda").to(dt),
                  torch.randn(n_pool + 1, page, KVH, hd, generator=g,
                              device="cuda").to(dt)) for _ in range(n_copy)]
        kp, vp = pools[0]
        got, n_cuda, same = decode_call(paged, paged.paged_gqa_decode, q, kp, vp,
                                        tbl, pos, softcap=cap, window=win)
        want = ref.paged_gqa_decode_ref(q, kp, vp, tbl, pos, softcap=cap, window=win)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        dname = str(dt).split(".")[1]
        if not bool((err <= tol + tol * want.float().abs()).all()) or not same \
                or n_cuda != 1:
            raise AssertionError(f"paged_gqa_decode ({name}) {dname}: max err "
                                 f"{err.max().item():.3e} (tol {tol}), same bits "
                                 f"{same}, CUDA launches {n_cuda}")
        plan = gqa.decode_plan(B, KVH, max_pg * page, page, H=H, hd=hd, window=win)
        rec = dict(case=name, B=B, H=H, KVH=KVH, hd=hd, page=page,
                   max_pages=max_pg, pool_pages=n_pool, pos_min=lo, pos_max=hi,
                   dtype=dname, softcap=cap, window=win, aliased_pages=alias,
                   main=name == "a" and dt == torch.bfloat16,
                   max_abs_err=float(err.max()), tol=tol,
                   cuda_launches_per_call=n_cuda, plan=plan_record(plan))
        line = f"  paged_gqa_decode ({name}) {dname:8s} pages/row {max_pg:3d} pos " \
               f"{lo}-{hi} cap {cap:.0f} win {win} alias {alias}: err " \
               f"{rec['max_abs_err']:.2e} (tol {tol}), same bits, {n_cuda} CUDA " \
               f"launch; plan {rec['plan']}"
        if timed:
            sets = [(q, k, v, tbl, pos) for k, v in pools]

            def kern(q, k, v, t, p):
                return paged.paged_gqa_decode(q, k, v, t, p)

            def plain(q, k, v, t, p):
                return ref.paged_gqa_decode_ref(q, k, v, t, p)
            idx = torch.arange(max_pg * page, device="cuda")
            mask = (idx[None, :] < pos.long()[:, None])[:, None, None, :]

            def gather_sdpa(q, k, v, t, p, mask=mask):
                ti = t.long()
                kc = k[ti].reshape(B, max_pg * page, KVH, hd)
                vc = v[ti].reshape(B, max_pg * page, KVH, hd)
                return torch.nn.functional.scaled_dot_product_attention(
                    q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)
            rec.update(ms=device_ms(kern, sets), plain_ms=device_ms(plain, sets, 10),
                       library_ms=device_ms(gather_sdpa, sets, 10),
                       call_ms=bench_ms(kern, sets))
            keys = int(pos.long().sum())
            pages_read = int(((pos.long() + page - 1) // page).sum())
            nbytes = (2 * q.numel() * elt + 2 * keys * KVH * hd * elt
                      + 4 * pages_read + 4 * B)
            decode_rates(rec, nbytes, 4 * keys * H * hd, dname)
            line += (f"; kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} ms "
                     f"gather+SDPA {rec['library_ms']:.4f} ms bound "
                     f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
                     f"{rec['gb_s']:.0f} GB/s = {rec['bound_share']:.2f} of the bound; "
                     f"eager call {rec['call_ms']:.4f} ms")
            if name == "b" and dt == torch.bfloat16:
                rec["split_ms"] = chunk_sweep(gqa, paged, plan, max_pg * page, page,
                                              B, H, hd, kern, sets)
                line += "\n" + _sweep_line(rec["split_ms"])
        cases.append(rec)
        log(line)
    # (d) identity table: the paged kernel reads what gqa_decode reads
    for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
        max_pg = 8
        ck = torch.randn(B, max_pg * page, KVH, hd, generator=g, device="cuda").to(dt)
        cv = torch.randn(B, max_pg * page, KVH, hd, generator=g, device="cuda").to(dt)
        q = torch.randn(B, H, hd, generator=g, device="cuda").to(dt)
        pos = torch.randint(1, max_pg * page + 1, (B,), generator=g, device="cuda",
                            dtype=torch.int32)
        zero = torch.zeros(1, page, KVH, hd, device="cuda", dtype=dt)
        kp = torch.cat([ck.reshape(B * max_pg, page, KVH, hd), zero])
        vp = torch.cat([cv.reshape(B * max_pg, page, KVH, hd), zero])
        tbl = torch.arange(B * max_pg, dtype=torch.int32,
                           device="cuda").reshape(B, max_pg)
        got = paged.paged_gqa_decode(q, kp, vp, tbl, pos)
        want = gqa.gqa_decode(q, ck, cv, pos)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        dname = str(dt).split(".")[1]
        log(f"  paged_gqa_decode (d) {dname:8s} identity table vs gqa_decode kernel: "
            f"max abs diff {err:.2e} (tol {tol})")
        if err > tol:
            raise AssertionError(f"paged_gqa_decode identity table {dname}: {err}")
        cases.append(dict(case="d", dtype=dname, main=False, max_abs_err=err, tol=tol))
    return cases


def kernel_entry(name, source, replaces, cases, launches, extra):
    main = next(c for c in cases if c["main"])
    return dict(name=name, route="cuda", source=source, replaces=replaces,
                launches=launches, max_abs_err=max(c["max_abs_err"] for c in cases),
                tolerance=main["tol"], ms=main["ms"], kernel_ms=main["ms"],
                call_ms=main["call_ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by=main["bound_by"], library_ms=main["library_ms"],
                shape={k: v for k, v in main.items()
                       if k not in ("ms", "plain_ms", "library_ms", "bound_ms",
                                    "bound_by", "max_abs_err", "tol", "main",
                                    "call_ms", "library_fwd_bwd_ms", "tflops",
                                    "scratch_bytes", "plan", "split_ms",
                                    "cuda_launches_per_call", "gb_s",
                                    "bound_share", "label", "same_bits",
                                    "add_equals_composition", "add_max_abs_err",
                                    "bytes", "plan_sweep")
                       and not k.startswith("a_")},
                **extra, cases=cases)


# ---------------------------------------------------------------------------
# phase 5: teacher-forced fp32 check, card vs CPU
# ---------------------------------------------------------------------------

def teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, device,
                            enc=None):
    """Per-token logprobs of each row's generated tokens, teacher-forced
    through forward_seq in fp32 on `device` (encdec: with the rows' frame
    embeddings `enc`)."""
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.rollout.prefill import _bucket_len

    def fp32(tree):
        return M.tree_map(lambda t: t.to(device=device, dtype=torch.float32), tree)

    p32 = fp32(params)
    stacked = stack_adapters([fp32(a) for a in adapters])
    S = _bucket_len(max(len(r["tokens"]) for r, _ in rows))
    tokens = torch.zeros((len(rows), S), dtype=torch.int32)
    for i, (r, _) in enumerate(rows):
        tokens[i, :len(r["tokens"])] = torch.tensor(r["tokens"])
    ids = torch.tensor([a for _, a in rows], dtype=torch.int32, device=device)
    if enc is not None:
        enc = enc.to(device=device, dtype=torch.float32)
    with torch.inference_mode():
        h, _, _ = M.forward_seq(p32, tokens.to(device), cfg,
                                batched_ctx(stacked, ids, cfg), enc_embeds=enc)
        logp = torch.log_softmax(M.lm_logits(h, p32, cfg), dim=-1)
    out = []
    for i, (r, _) in enumerate(rows):
        p0 = r["prompt_len"]
        tgt = torch.tensor(r["tokens"][p0:], device=device).long()
        pos = torch.arange(p0 - 1, len(r["tokens"]) - 1, device=device)
        out.append(logp[i, pos, tgt].cpu().double())
    return out


def _profile_report(prof, wall_s):
    """(device busy seconds, device ms by group, report lines) of a
    torch.profiler run: device time by kernel and group, host time by op."""
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue              # host ops; their device time is their kernels'
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_s = sum(r[0] for r in rows) / 1e6
    groups = {}
    for us, _, key in rows:
        g = _kernel_group(key)
        groups[g] = groups.get(g, 0.0) + us / 1e3
    host = sorted(((e.self_cpu_time_total, e.count, e.key) for e in prof.key_averages()
                   if "CUDA" not in str(getattr(e, "device_type", ""))), reverse=True)
    lines = [f"{us / 1e3:10.3f} ms {n:7d} calls  {key}" for us, n, key in rows]
    host_lines = [f"{us / 1e3:10.3f} ms {n:7d} calls  {key}" for us, n, key in host[:40]]
    text = (f"wall {wall_s:.4f} s, device busy {busy_s:.4f} s\n\n-- device time by "
            f"group (ms)\n"
            + "\n".join(f"{v:10.3f}  {k}" for k, v in sorted(groups.items(),
                                                             key=lambda kv: -kv[1]))
            + "\n\n-- device time by kernel\n" + "\n".join(lines)
            + "\n\n-- host self time by op (top 40)\n" + "\n".join(host_lines) + "\n")
    return busy_s, groups, lines, text


def profile_launches(text):
    """(device launches, of them sgmv's) in a profile table written by
    _profile_report: the call counts of its "device time by kernel"
    section (memory copies and sets included)."""
    section = text.split("-- device time by kernel\n")[1].split("\n\n")[0]
    total = sgmv_n = 0
    for line in section.splitlines():
        m = re.match(r"\s*[\d.]+ ms\s+(\d+) calls  (.*)", line)
        if m:
            total += int(m.group(1))
            sgmv_n += int(m.group(1)) if _kernel_group(m.group(2)) == "sgmv" else 0
    return total, sgmv_n


def _groups_line(groups):
    return ", ".join(f"{k} {v:.2f}" for k, v in sorted(groups.items(),
                                                       key=lambda kv: -kv[1]))


def profile_serve(torch, cfg, params, adapters, out_dir):
    """One short served round under torch.profiler: device time by kernel,
    and the device's busy share of the round's wall time. The full table
    goes to out_dir/serve_profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests
    from repro_torch.rollout.engine import RolloutEngine

    eng = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=2, device="cuda")
    reqs = make_requests(TENANTS, PER_TENANT, max_new_tokens=8, seed=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, st = eng.generate(reqs, adapters)
    busy_s, groups, lines, text = _profile_report(prof, st.wall_seconds)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "serve_profile.txt").write_text(
        f"decode steps {st.decode_steps}, " + text)
    total, n_sgmv = profile_launches(text)
    forwards = st.decode_steps + 1
    log(f"[4b profile] {st.decode_steps} decode steps, wall {st.wall_seconds:.4f} s "
        f"(under the profiler), device busy {busy_s:.4f} s = "
        f"{100 * busy_s / st.wall_seconds:.1f}%; {total} device launches = "
        f"{total / forwards:.1f} a forward ({forwards} forwards; sgmv {n_sgmv} = "
        f"{n_sgmv / forwards:.1f} a forward); device ms by group: "
        + _groups_line(groups))
    for line in lines[:12]:
        log("  " + line[:150])


def profile_train(torch, cfg, params, start, tb, tc, out_dir):
    """One train step of phase 6's last batch under torch.profiler (device
    time by kernel group, busy share); the table goes to
    out_dir/train_profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.train.train_step import batch_from_trajectory, make_train_step

    step = make_train_step(cfg, tc)
    batch = batch_from_trajectory(tb, tc, "cuda")
    lora, opt = start
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        step(params, lora, opt, batch)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_s, groups, lines, text = _profile_report(prof, wall)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "train_profile.txt").write_text("one train step, " + text)
    log(f"[6b profile] one train step, wall {wall:.4f} s (under the profiler), "
        f"device busy {busy_s:.4f} s = {100 * busy_s / wall:.1f}%; device ms by "
        f"group: " + _groups_line(groups))
    for line in lines[:12]:
        log("  " + line[:150])


def profile_continuous(torch, cfg, params, adapters, out_dir):
    """A short continuous run over the paged pool under torch.profiler (16
    requests on 16 slots, 8 new tokens); the table goes to
    out_dir/continuous_profile.txt."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests
    from repro_torch.rollout.engine import ContinuousRolloutEngine

    eng = ContinuousRolloutEngine(
        cfg, params, max_slots=CONT_SLOTS, max_adapters=TENANTS,
        max_len=CONT_MAX_LEN, paged_kv=True, prefix_cache=False,
        kv_page_size=PAGE, kv_pool_pages=POOL_PAGES, seed=2, device="cuda")
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    for r in make_requests(TENANTS, CONT_SLOTS // TENANTS, max_new_tokens=8,
                           seed=2):
        eng.submit(r)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        eng.drain()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    busy_s, groups, lines, text = _profile_report(prof, wall)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "continuous_profile.txt").write_text(
        f"decode steps {eng.stats.decode_steps}, " + text)
    log(f"[8b profile] continuous paged, {eng.stats.decode_steps} decode steps, wall "
        f"{wall:.4f} s (under the profiler), device busy {busy_s:.4f} s = "
        f"{100 * busy_s / wall:.1f}%; device ms by group: " + _groups_line(groups))
    for line in lines[:12]:
        log("  " + line[:150])


def _kernel_group(name):
    """Coarse owner of a device kernel, for the profile's breakdown."""
    if "sgmv" in name:
        return "sgmv"
    if "tlp_" in name:
        return "token_logprob"
    if "paged_decode" in name:
        return "paged_gqa_decode"
    if "gqa_decode" in name:
        return "gqa_decode"
    if "Memcpy" in name or "Memset" in name:
        return "memcpy"
    if "nvjet" in name or "gemm" in name or "Gemm" in name:
        return "matmul"
    if "<long" in name or "Bitwise" in name or "shift" in name:
        return "int64 elementwise (sampler)"
    return "other elementwise / reductions"


# ---------------------------------------------------------------------------
# phases 6 and 7: GRPO training
# ---------------------------------------------------------------------------

def grpo_requests(env, rng, task_id):
    """GROUPS x GROUP_SIZE requests on adapter 0; each group's samples share
    one prompt (as the JAX runtime's _build_requests builds them)."""
    from repro_torch.rollout.engine import RolloutRequest
    reqs = []
    for _ in range(GROUPS):
        prompt, truth = env.sample_prompt(rng)
        reqs += [RolloutRequest(task_id, 0, prompt, truth, env,
                                max_new_tokens=MAX_NEW, temperature=0.8)
                 for _ in range(GROUP_SIZE)]
    return reqs


def sgmv_per_forward(cfg):
    """sgmv launches a forward of `cfg`: one an adapted projection, as
    ``applicable_targets`` names them, in every layer, and in the hybrid's
    shared block at each of its invocations (qwen3-0.6b: 6 x 28 = 168)."""
    from repro_torch.lora.adapters import applicable_targets
    from repro_torch.models.model import n_attn_layers
    t = applicable_targets(cfg)
    return (len(t["layers"]) * cfg.num_layers
            + (len(t["shared"]) * n_attn_layers(cfg) if t["shared"] else 0))


def attn_per_step(cfg):
    """Decode-attention launches a decode step: one an attention layer (the
    hybrid's shared-block invocations; none for ssm)."""
    from repro_torch.models.model import n_attn_layers
    return n_attn_layers(cfg)


def count_all(kernel_modules, reset=False):
    """Every kernel wrapper's launch count (set to 0 first with reset)."""
    counts = {}
    for name, counter in kernel_modules.items():
        if reset:
            counter.n = 0
        counts[name] = counter.n
    return counts


def train_phase(torch, cfg, params, counters, card, iters=TRAIN_ITERS, tag="6"):
    """Phase 6: `iters` iterations of generate -> to_trajectory_batch ->
    make_train_step at full size, one tenant. Returns the record, the last
    batch, and the adapter and optimizer state that step started from."""
    from repro_torch.envs.tasks import make_env
    from repro_torch.launch.serve import make_adapters
    from repro_torch.rollout.engine import RolloutEngine, to_trajectory_batch
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import AdamWConfig
    from repro_torch.train.train_step import (TrainConfig, batch_from_trajectory,
                                              init_opt_state, make_train_step)
    import math

    tc = TrainConfig(group_size=GROUP_SIZE, use_logprob_kernel=True, kl_coef=0.01,
                     ent_coef=0.01, adamw=AdamWConfig(lr=LR))
    lora = make_adapters(cfg, 1, seed=3, device="cuda", b_scale=B_SCALE)[0]
    opt = init_opt_state(cfg, tc, params, lora)
    step = make_train_step(cfg, tc)
    engine = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=3, device="cuda")
    env, rng = make_env("gsm8k"), random.Random(7)
    steps = []
    count_all(counters, reset=True)
    for it in range(iters):
        results, st = engine.generate(grpo_requests(env, rng, "tenant-0"), [lora])
        for r in results:
            if not all(math.isfinite(lp) and lp <= 0 for lp in r["gen_logprobs"]):
                raise AssertionError("served logprob non-finite or positive")
        tb = to_trajectory_batch(results, "tenant-0", it, GROUP_SIZE)
        batch = batch_from_trajectory(tb, tc, "cuda")
        S = tb.tokens.shape[1]
        loss_tokens = float((tb.completion_mask()[:, :S - 1]
                             * tb.meta["loss_mask"][:, :S - 1]).sum())
        before = count_all(counters)
        prev = (lora, opt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        lora, opt, m = step(params, lora, opt, batch)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        after = count_all(counters)
        fwd = after["token_logprob_fwd"] - before["token_logprob_fwd"]
        bwd = after["token_logprob_bwd"] - before["token_logprob_bwd"]
        if (fwd, bwd) != (2, 1):
            raise AssertionError(f"train step {it}: token_logprob forward {fwd} "
                                 f"and backward {bwd} launches (want 2 and 1)")
        m = {k: float(v) for k, v in m.items()}
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"train step {it}: non-finite metrics {m}")
        if not m["grad_norm"] > 0:
            raise AssertionError(f"train step {it}: zero gradient")
        same = [bool(torch.equal(a, b)) for a, b in zip(tree_leaves(prev[0]),
                                                         tree_leaves(lora))]
        if any(same):
            raise AssertionError(f"train step {it}: {sum(same)} adapter leaves "
                                 f"unchanged")
        rec = dict(step=it, rows=tb.num_rows, seq=S, token_rows=tb.num_rows * (S - 1),
                   loss_tokens=loss_tokens, train_ms=1e3 * secs,
                   trained_tokens_per_s=loss_tokens / secs,
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   generate_s=st.wall_seconds, reward_mean=m["reward_mean"],
                   **{k: m[k] for k in ("loss", "pg_loss", "kl", "entropy",
                                        "grad_norm")})
        steps.append(rec)
        log(f"[{tag} train] {cfg.name} step {it}: {tb.num_rows} rows x {S - 1} positions "
            f"({loss_tokens:.0f} loss tokens), train {rec['train_ms']:.1f} ms = "
            f"{rec['trained_tokens_per_s']:.1f} trained tok/s, peak "
            f"{rec['peak_mem_gib']:.2f} GiB; loss {m['loss']:.6f} kl {m['kl']:.6f} "
            f"entropy {m['entropy']:.4f} grad_norm {m['grad_norm']:.6f} reward "
            f"{m['reward_mean']:.3f}; generate {st.wall_seconds:.2f} s")
    launches = count_all(counters)
    return dict(steps=steps, launches=launches, card=card), tb, prev, tc


def train_check(torch, M, cfg, params, tb, start, tc):
    """Phase 7: one group of the last batch in fp32 through the step's own
    functions (make_grad_fn, then adamw_update as make_train_step does), on
    the card (kernels) and on the CPU (plain versions), from the same adapter
    and optimizer state. Raises on any miss."""
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import adamw_update, global_norm
    from repro_torch.train.train_step import batch_from_trajectory, make_grad_fn
    from repro_torch.kernels import token_logprob as tlp

    lora, opt = start
    out = {}
    for dev in ("cuda", "cpu"):
        def mv(tree, dev=dev):
            return M.tree_map(lambda t: t.to(device=dev, dtype=torch.float32)
                              if t.is_floating_point() else t.to(dev), tree)
        p32 = mv(params)
        batch = {k: v[:GROUP_SIZE] for k, v in
                 batch_from_trajectory(tb, tc, dev).items()}
        n0 = (tlp.FWD_LAUNCHES.n, tlp.BWD_LAUNCHES.n)
        metrics, grads = make_grad_fn(cfg, tc)(p32, mv(lora), batch)
        new, _, gnorm = adamw_update(mv(lora), grads, mv(opt), tc.adamw)
        n1 = (tlp.FWD_LAUNCHES.n - n0[0], tlp.BWD_LAUNCHES.n - n0[1])
        if n1 != ((2, 1) if dev == "cuda" else (0, 0)):
            raise AssertionError(f"phase 7 on {dev}: token_logprob launches {n1}")
        out[dev] = ([M.tree_map(lambda t: t.cpu(), x) for x in (metrics, grads, new)],
                    float(gnorm))
        del p32
    (m_g, g_g, new_g), _ = out["cuda"]
    (m_c, g_c, new_c), gnorm_c = out["cpu"]
    m_err = max(abs(float(m_g[k]) - float(m_c[k])) for k in m_c)
    g_norm = float(global_norm(g_c))
    g_err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(g_g),
                                                          tree_leaves(g_c)))
    # AdamW's first moments make each step ~ lr * g / (|g| + eps): compare
    # the updated adapters only where the clipped CPU gradient is > 100 eps
    clip = min(1.0, tc.adamw.grad_clip / (gnorm_c + 1e-9)) if tc.adamw.grad_clip else 1.0
    p_err, n_cmp, n_all = 0.0, 0, 0
    for a, b, g in zip(tree_leaves(new_g), tree_leaves(new_c), tree_leaves(g_c)):
        sure = (g * clip).abs() > 100 * tc.adamw.eps
        n_cmp += int(sure.sum())
        n_all += g.numel()
        if sure.any():
            p_err = max(p_err, float((a - b).abs()[sure].max()))
    rec = dict(rows=GROUP_SIZE, metric_max_abs_diff=m_err, metric_tol=METRIC_TOL,
               grad_norm=g_norm, grad_max_abs_diff=g_err,
               grad_tol=GRAD_TOL * g_norm, update_max_abs_diff=p_err,
               update_tol=1e-2 * tc.adamw.lr, update_elements_compared=n_cmp,
               update_elements=n_all, loss_card=float(m_g["loss"]),
               loss_cpu=float(m_c["loss"]))
    log(f"[7 train check] fp32, {GROUP_SIZE} rows, card (kernels) vs CPU (plain): "
        f"metrics max abs diff {m_err:.3e} (tol {METRIC_TOL}); gradient max abs "
        f"diff {g_err:.3e} of norm {g_norm:.4e} (tol {GRAD_TOL} x norm); updated "
        f"adapters max abs diff {p_err:.3e} (tol {rec['update_tol']:.1e}) over "
        f"{n_cmp} of {n_all} elements whose gradient is above 100 eps")
    if m_err > METRIC_TOL or g_err > GRAD_TOL * g_norm or p_err > rec["update_tol"] \
            or n_cmp < n_all // 10:
        raise AssertionError(f"phase 7: card and CPU steps differ: {rec}")
    return rec


def train_check_bf16(torch, cfg, params, tb, start, tc):
    """Phase 7 in bf16: one group of the last batch through make_grad_fn on
    the card at the served dtype, once as the step runs (token_logprob's bf16
    forward and backward kernels), once with the plain backward
    (``token_logprob_bwd_ref``) in the backward kernel's place and once with
    the plain forward (``token_logprob_stats_ref``) in the forward kernel's
    place; the rest of the step is the same code on the same inputs. The
    adapter gradients' max abs diff must stay within BF16_GRAD_TOL of the
    plain gradient's norm in both comparisons, and the loss and metrics
    within BF16_METRIC_TOL of the plain forward's. Raises on a miss."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import token_logprob as tlp
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_step import batch_from_trajectory, make_grad_fn

    lora, _ = start
    batch = {k: v[:GROUP_SIZE] for k, v in
             batch_from_trajectory(tb, tc, "cuda").items()}
    grad_fn = make_grad_fn(cfg, tc)
    kernel_fwd, kernel_bwd = tlp.token_logprob_fwd, tlp.token_logprob_bwd
    runs = {}
    for name, fwd, bwd, want in (
            ("kernels", kernel_fwd, kernel_bwd, (2, 1)),
            ("plain backward", kernel_fwd, ref.token_logprob_bwd_ref, (2, 0)),
            ("plain forward", ref.token_logprob_stats_ref, kernel_bwd, (0, 1))):
        n0 = (tlp.FWD_LAUNCHES.n, tlp.BWD_LAUNCHES.n)
        tlp.token_logprob_fwd, tlp.token_logprob_bwd = fwd, bwd   # what the
        try:                                                       # autograd node calls
            runs[name] = grad_fn(params, lora, batch)
        finally:
            tlp.token_logprob_fwd, tlp.token_logprob_bwd = kernel_fwd, kernel_bwd
        n1 = (tlp.FWD_LAUNCHES.n - n0[0], tlp.BWD_LAUNCHES.n - n0[1])
        if n1 != want:
            raise AssertionError(f"phase 7 bf16 ({name}): token_logprob launches "
                                 f"{n1}, want {want}")

    def grad_diff(other):
        return max(float((a.float() - b.float()).abs().max()) for a, b in
                   zip(tree_leaves(runs["kernels"][1]), tree_leaves(runs[other][1])))

    m_k, m_p = runs["kernels"][0], runs["plain forward"][0]
    g_norm = float(global_norm(runs["plain backward"][1]))
    rec = dict(rows=GROUP_SIZE, dtype=str(params["embed"].dtype).split(".")[1],
               grad_norm=g_norm, grad_max_abs_diff=grad_diff("plain backward"),
               grad_tol=BF16_GRAD_TOL * g_norm,
               fwd_grad_max_abs_diff=grad_diff("plain forward"),
               metric_max_abs_diff=max(abs(float(m_k[k]) - float(m_p[k])) for k in m_p),
               metric_tol=BF16_METRIC_TOL, loss_kernels=float(m_k["loss"]),
               loss_plain_forward=float(m_p["loss"]))
    log(f"[7 train check] {rec['dtype']}, {GROUP_SIZE} rows, on the card: backward "
        f"kernel vs plain backward: gradient max abs diff "
        f"{rec['grad_max_abs_diff']:.3e} of norm {g_norm:.4e} (tol {BF16_GRAD_TOL} x "
        f"norm); forward kernel vs plain forward: loss {rec['loss_kernels']:.6f} vs "
        f"{rec['loss_plain_forward']:.6f}, metrics max abs diff "
        f"{rec['metric_max_abs_diff']:.3e} (tol {BF16_METRIC_TOL}), gradient max abs "
        f"diff {rec['fwd_grad_max_abs_diff']:.3e} (tol {BF16_GRAD_TOL} x norm)")
    if not g_norm > 0 or rec["grad_max_abs_diff"] > rec["grad_tol"] \
            or rec["fwd_grad_max_abs_diff"] > rec["grad_tol"] \
            or not rec["metric_max_abs_diff"] <= BF16_METRIC_TOL:
        raise AssertionError(f"phase 7 bf16: the step with the kernels and with a "
                             f"plain version differ: {rec}")
    return rec


# ---------------------------------------------------------------------------
# phases 8 and 9: the continuous engine over the paged KV pool
# ---------------------------------------------------------------------------

def continuous_phase(torch, cfg, params, adapters, counters, card, tag="8"):
    """Phase 8: ContinuousRolloutEngine over the paged pool at full size,
    CONT_PER_TENANT gsm8k requests per tenant on CONT_SLOTS slots. The last
    tenant's requests arrive after decode step PREEMPT_AT with priority 1:
    tenant-1 is preempted to make room (its rows snapshot to host and restore
    when slots free), so prefills and restores happen mid-decode. Checks the
    engine's invariants after every step and the kernels' launch counts over
    the run (``attn_per_step`` and ``sgmv_per_forward`` of `cfg`), and records
    the largest host snapshot a row took. Returns the record and the
    completions."""
    import numpy as np
    from repro_torch.launch.serve import make_requests
    from repro_torch.rollout.engine import ContinuousRolloutEngine

    reqs = make_requests(TENANTS, CONT_PER_TENANT, max_new_tokens=CONT_MAX_NEW,
                         seed=8)
    late = [r for r in reqs if r.task_id == f"tenant-{TENANTS - 1}"]
    for i, r in enumerate(reqs):
        r.seed = 1000 + i                       # distinct per-row keys
        r.priority = 1 if r in late else 0
    eng = ContinuousRolloutEngine(
        cfg, params, max_slots=CONT_SLOTS, max_adapters=TENANTS,
        max_len=CONT_MAX_LEN, paged_kv=True, prefix_cache=False,
        kv_page_size=PAGE, kv_pool_pages=POOL_PAGES, device="cuda")
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    refill, forwards = eng._refill_fn, {"n": 0}

    def counted_refill(*a):
        forwards["n"] += 1
        return refill(*a)
    eng._refill_fn = counted_refill
    snap_bytes, try_add = [], eng._snap_store.try_add

    def sized_add(snap):
        snap_bytes.append(snap.nbytes)
        return try_add(snap)
    eng._snap_store.try_add = sized_add
    for r in reqs:
        if r not in late:
            eng.submit(r)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count_all(counters, reset=True)
    t0 = time.monotonic()
    comps, preempted, steps = [], 0, 0
    while not eng.idle():
        eng.step()
        steps += 1
        eng.check_page_invariants()
        if not preempted and eng.stats.decode_steps >= PREEMPT_AT:
            # the last tenant arrives with a higher priority; tenant-1's rows
            # make room for it, snapshot to host and restore when slots free
            preempted = eng.preempt_tenant("tenant-1")
            if not preempted:
                raise AssertionError(f"phase {tag}: tenant-1 had no resident row")
            for r in late:
                eng.submit(r)
        comps += eng.drain_completions()
        if steps > 50 * CONT_MAX_NEW:
            raise AssertionError(f"phase {tag}: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = count_all(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    st = eng.stats
    pages = eng.page_stats()
    idx = sorted(c.submit_index for c in comps)
    if idx != list(range(len(reqs))):
        raise AssertionError(f"phase {tag}: completions {idx}")
    if not (st.preemptions > 0 and st.restores > 0 and st.replays == 0):
        raise AssertionError(f"phase {tag}: preemptions {st.preemptions} restores "
                             f"{st.restores} replays {st.replays}")
    if pages["kv_pages_peak"] > POOL_PAGES or pages["kv_pages_used"] != 0:
        raise AssertionError(f"phase {tag}: pages {pages}")
    n_sgmv = sgmv_per_forward(cfg) * (st.decode_steps + forwards["n"])
    want = {"paged_gqa_decode": attn_per_step(cfg) * st.decode_steps,
            "gqa_decode": 0, "sgmv": n_sgmv, "sgmv_cuda": n_sgmv}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"phase {tag}: launches {got}, want {want}")
    for c in comps:
        gen = c.tokens[c.prompt_len:]
        if not 1 <= len(gen) <= CONT_MAX_NEW or \
                not all(0 <= t < cfg.vocab_size for t in gen):
            raise AssertionError(f"phase {tag}: row of {len(gen)} tokens")
        if not all(np.isfinite(lp) and lp <= 0 for lp in c.gen_logprobs):
            raise AssertionError(f"phase {tag}: non-finite or positive logprob")
    decode_tokens = st.occupied_row_steps
    rec = dict(requests=len(reqs), slots=CONT_SLOTS, max_len=CONT_MAX_LEN,
               page=PAGE, pool_pages=POOL_PAGES, max_new_tokens=CONT_MAX_NEW,
               decode_steps=st.decode_steps, decode_s=st.decode_seconds,
               decode_ms_per_step=1e3 * st.decode_seconds / st.decode_steps,
               decode_tokens=decode_tokens,
               decode_tokens_per_s=decode_tokens / st.decode_seconds,
               prefill_s=st.prefill_seconds, refills=st.refills,
               refill_forwards=forwards["n"],
               slot_utilization=st.slot_utilization(),
               preempted_rows=preempted, preemptions=st.preemptions,
               restores=st.restores, snapshots=st.snapshots, replays=st.replays,
               replay_tokens_saved=st.replay_tokens_saved,
               snapshot_bytes_per_row_max=max(snap_bytes, default=0),
               snapshot_drops=st.snapshot_drops,
               kv_pages_peak=pages["kv_pages_peak"], wall_s=wall,
               peak_mem_gib=peak_gib, launches=launches, card=card)
    log(f"[{tag} continuous] {cfg.name}: {len(reqs)} requests ({TENANTS} tenants) on {CONT_SLOTS} slots, "
        f"paged pool {POOL_PAGES} pages x {PAGE} tokens, max_len {CONT_MAX_LEN}: "
        f"{st.decode_steps} decode steps, {decode_tokens} decode tokens in "
        f"{st.decode_seconds:.3f} s = {rec['decode_tokens_per_s']:.1f} tok/s "
        f"({rec['decode_ms_per_step']:.2f} ms/step), {st.refills} refills "
        f"({forwards['n']} prefill forwards, {st.prefill_seconds:.3f} s), slot "
        f"utilization {st.slot_utilization():.3f}, kv_pages_peak "
        f"{pages['kv_pages_peak']:.0f}, {preempted} rows preempted -> "
        f"{st.restores} restores, {st.replays} replays, a row's snapshot "
        f"{rec['snapshot_bytes_per_row_max'] / 2**20:.1f} MiB at most; peak memory "
        f"{peak_gib:.2f} GiB; wall {wall:.2f} s; launches {got} on {card}")
    return rec, comps


def paged_check(torch, M, cfg, params, adapters, comps):
    """Phase 9: PAGED_TF_ROWS of phase 8's rows in fp32. On the card each
    row's prompt and all but its last PAGED_TF_STEPS + 1 tokens prefill
    into a paged cache whose pages are shuffled, then PAGED_TF_STEPS tokens
    are teacher-forced through decode_step (paged_gqa_decode), whose logits
    give the logprobs of the row's last PAGED_TF_STEPS tokens; the steps
    cross a page boundary. On the CPU the same on a dense cache with the
    plain versions. The logprobs must agree within TF_TOL."""
    from repro_torch.kernels import paged_decode as paged
    from repro_torch.kernels import sgmv
    from repro_torch.lora.adapters import batched_ctx, stack_adapters
    from repro_torch.rollout.prefill import _bucket_len

    T = PAGED_TF_STEPS
    rows = [c for c in sorted(comps, key=lambda c: c.submit_index)
            if len(c.tokens) - c.prompt_len > T and (len(c.tokens) - T - 1) % PAGE]
    rows = rows[::max(1, len(rows) // PAGED_TF_ROWS)][:PAGED_TF_ROWS]
    if len(rows) < PAGED_TF_ROWS:
        raise AssertionError("phase 9: too few rows long enough")
    n = len(rows)
    pre = [c.tokens[:len(c.tokens) - T - 1] for c in rows]
    S = _bucket_len(max(len(p) for p in pre))
    S_c = -(-S // PAGE) * PAGE
    max_pg = -(-max(len(c.tokens) for c in rows) // PAGE) + 1
    tokens = torch.zeros((n, S), dtype=torch.int32)
    for i, p in enumerate(pre):
        tokens[i, :len(p)] = torch.tensor(p)
    lens = torch.tensor([len(p) for p in pre], dtype=torch.int32)
    feed = torch.tensor([c.tokens[len(c.tokens) - T - 1:-1] for c in rows])
    target = torch.tensor([c.tokens[len(c.tokens) - T:] for c in rows])
    ids = torch.tensor([int(c.task_id.split("-")[1]) for c in rows],
                       dtype=torch.int32)
    out = {}
    for dev in ("cuda", "cpu"):
        def fp32(tree, dev=dev):
            return M.tree_map(lambda t: t.to(device=dev, dtype=torch.float32), tree)
        p32 = fp32(params)
        lora = batched_ctx(stack_adapters([fp32(a) for a in adapters]),
                           ids.to(dev), cfg)
        n0, s0 = paged.LAUNCHES.n, sgmv.CUDA_LAUNCHES.n
        with torch.inference_mode():
            scratch = M.init_cache(cfg, n, S_c, dtype=torch.float32, device=dev)
            _, scratch, _ = M.forward_seq(p32, tokens.to(dev), cfg, lora, scratch)
            if dev == "cuda":
                cache = M.init_paged_cache(cfg, n, pool_pages=n * max_pg,
                                           page_size=PAGE,
                                           max_pages_per_row=max_pg,
                                           dtype=torch.float32, device=dev)
                gen = torch.Generator(device="cuda").manual_seed(9)
                perm = torch.randperm(n * max_pg, generator=gen, device=dev)
                cache["tbl"].copy_(perm.reshape(n, max_pg).to(torch.int32))
                chunks = S_c // PAGE
                dest = cache["tbl"][:, :chunks].reshape(-1).long()
                L, KVH, hd = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
                cache["kp"][:, dest] = scratch["k"].reshape(L, n * chunks, PAGE,
                                                            KVH, hd)
                cache["vp"][:, dest] = scratch["v"].reshape(L, n * chunks, PAGE,
                                                            KVH, hd)
            else:
                cache = M.init_cache(cfg, n, max_pg * PAGE, dtype=torch.float32,
                                     device=dev)
                S_w = scratch["k"].shape[2]
                cache["k"][:, :, :S_w] = scratch["k"]
                cache["v"][:, :, :S_w] = scratch["v"]
            cache["pos"].copy_(lens)
            lps = []
            for t in range(T):
                logits, cache = M.decode_step(p32, feed[:, t].to(dev), cache, cfg,
                                              lora)
                logp = torch.log_softmax(logits.float(), dim=-1)
                lps.append(logp.gather(1, target[:, t:t + 1].to(dev))[:, 0].cpu())
        launched = paged.LAUNCHES.n - n0
        if launched != (cfg.num_layers * T if dev == "cuda" else 0):
            raise AssertionError(f"phase 9 on {dev}: {launched} paged launches")
        launched = sgmv.CUDA_LAUNCHES.n - s0
        if launched != (6 * cfg.num_layers * (T + 1) if dev == "cuda" else 0):
            raise AssertionError(f"phase 9 on {dev}: {launched} sgmv launches")
        out[dev] = torch.stack(lps, dim=1).double()
        del p32, lora, scratch, cache
    err = float((out["cuda"] - out["cpu"]).abs().max())
    served = torch.tensor([c.gen_logprobs[-T:] for c in rows], dtype=torch.float64)
    bf16_dev = float((out["cuda"] - served).abs().max())
    log(f"[9 paged check] fp32, {n} rows x {T} teacher-forced decode steps over "
        f"shuffled pages (prefix {min(lens.tolist())}-{max(lens.tolist())} tokens), "
        f"card (paged kernel) vs CPU (dense, plain): max abs diff {err:.3e} (tol "
        f"{TF_TOL}); served bf16 vs fp32 max abs diff {bf16_dev:.3e}")
    if not err <= TF_TOL:
        raise AssertionError(f"phase 9: fp32 card vs CPU logprobs differ by {err}")
    return dict(rows=n, steps=T, max_abs_diff=err, tol=TF_TOL,
                served_bf16_vs_fp32=bf16_dev)


# ---------------------------------------------------------------------------
# phase 10: the runtime, rollout and trainer threads on one card
# ---------------------------------------------------------------------------

def _median(xs):
    xs = sorted(xs)
    return (xs[len(xs) // 2] + xs[(len(xs) - 1) // 2]) / 2 if xs else float("nan")


def graded_env(env):
    """`env` with a graded verifier, the share of even token ids in a
    completion: random weights earn no task reward, and with every reward
    equal the GRPO advantages, gradients and updates would all be 0."""
    class Graded(type(env)):
        def verify(self, truth, completion_ids):
            ids = list(completion_ids)
            return sum(t % 2 == 0 for t in ids) / max(1, len(ids))
    return Graded()


def biased_sampler(torch):
    """Install a sampler in the port's engine and prefill modules that
    returns tok.CALL at the CALL_AT counters and never EOS (remapped to a
    plain token): random weights would almost never sample CALL, so this is
    what makes agentic rows call their tools, alike in every mode. Works
    on the device's tensors. Returns the function that undoes it."""
    from repro_torch.data import tokenizer as tok
    from repro_torch.rollout import engine as eng_mod, prefill as pf_mod
    orig = pf_mod._sample_rows

    def biased(logits, keys, counters, temps):
        s = orig(logits, keys, counters, temps)
        s = torch.where(s == tok.EOS, 10, s)
        hit = torch.zeros(counters.shape, dtype=torch.bool, device=counters.device)
        for c in CALL_AT:
            hit = hit | (counters == c)
        return torch.where(hit, tok.CALL, s)
    pf_mod._sample_rows = eng_mod._sample_rows = biased

    def undo():
        pf_mod._sample_rows = eng_mod._sample_rows = orig
    return undo


def runtime_phase(torch, cfg, params, counters, card, run, device="cuda"):
    """Phase 10, one run: MARLaaSRuntime with ALL_RUNS[run] over the run's
    tenants (RT_ENVS, or RT_RUN_ENVS[run] with the biased sampler), each
    rewarded by a graded verifier, each tenant's prompt stream pinned. The
    engine's step and the trainer's step are wrapped to time each engine
    step and keep each commit's metrics (the engine counts its forwards,
    the prefill workers' too); the manager's commit and the engine's
    set_adapters to check that every install is a committed tree and lands
    in the stacked buffer the decode reads; launches are counted from just
    before run() to just after. Raises on any miss; returns the record."""
    import math
    from repro_torch.core.manager import TaskSpec
    from repro_torch.core.metrics import summarize
    from repro_torch.core.runtime import MARLaaSRuntime, RuntimeConfig
    from repro_torch.launch.serve import make_adapters
    from repro_torch.models import tree_leaves

    envs = RT_RUN_ENVS.get(run, RT_ENVS)
    spec = dict(RT_SPEC, **P10_CUT.get(run, {}))
    gc.collect()            # earlier phases' engines: out of the peak
    rt = MARLaaSRuntime(cfg, params, RuntimeConfig(
        policy="marlaas", device=device, max_slots=RT_SLOTS,
        max_adapter_slots=len(envs), max_len=MAX_LEN, seed=0,
        **ALL_RUNS[run]))
    adapters = make_adapters(cfg, len(envs), seed=20, device=device,
                             b_scale=B_SCALE)
    tids = [f"{env}-{i}" for i, env in enumerate(envs)]
    for i, (tid, env, tree) in enumerate(zip(tids, envs, adapters)):
        rt.submit_task(TaskSpec(tid, env, **spec), tree)
        rt.envs[tid] = graded_env(rt.envs[tid])
        # the runtime seeds a tenant's prompt stream with the salted str
        # hash; a pinned stream gives every run of a call the same prompts
        rt.datagens[tid] = random.Random(100 + i)
    eng = rt.cengine
    # every tree a tenant held: its initial one, then each commit's (listed
    # before the manager publishes it, so the rollout thread finds it)
    committed, commit, set_adapters = list(adapters), rt.mgr.commit, eng.set_adapters
    installed = {tid: 0 for tid in tids}       # installs of a trained tree

    def listed_commit(tid, tree, *a, **kw):
        committed.append(tree)
        return commit(tid, tree, *a, **kw)

    def checked_install(slot, tree):
        set_adapters(slot, tree)
        owner = [tid for tid in tids if rt.mgr.state(tid).adapter_slot == slot]
        if not any(tree is t for t in committed) or len(owner) != 1:
            raise AssertionError(f"phase 10 {run}: slot {slot} installed a tree "
                                 f"no tenant committed (owners {owner})")
        if not all(torch.equal(buf[:, slot], leaf) for buf, leaf in
                   zip(tree_leaves(eng._stacked), tree_leaves(tree))):
            raise AssertionError(f"phase 10 {run}: slot {slot} differs from its tree")
        installed[owner[0]] += not any(tree is t for t in adapters)
    rt.mgr.commit, eng.set_adapters = listed_commit, checked_install
    step, steps, fc = eng.step, [], eng.forward_counts

    def on_decode_thread():     # prefill forwards run by the decode thread
        return fc["refill"].n + fc["suffix"].n

    def timed_step():
        d0, f0 = eng.stats.decode_steps, on_decode_thread()
        t0 = time.monotonic()
        out = step()
        steps.append((t0, time.monotonic(), eng.stats.decode_steps - d0,
                      on_decode_thread() - f0))
        if run in P14_RUNS:      # outside the timed interval
            eng.check_page_invariants()
        return out
    eng.step = timed_step
    train_step, metrics = rt._train_step_for(rt.mgr.spec_for(tids[0])), []

    def kept_step(*a):
        out = train_step(*a)
        metrics.append(out[2])
        return out
    rt._train_steps[RT_SPEC["group_size"]] = kept_step
    undo = biased_sampler(torch) if run in RT_RUN_ENVS else None
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count_all(counters, reset=True)
    t0 = time.monotonic()
    try:
        rt.run(timeout_s=600)
    finally:
        if undo is not None:
            undo()
    launches = count_all(counters)
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    wall = max(st.last_step_at for _, st in rt.mgr.task_items()) - t0
    states = dict(rt.mgr.task_items())
    if not rt.mgr.all_done() or any(st.version != spec["target_steps"]
                                    for st in states.values()):
        raise AssertionError(f"phase 10 {run}: versions "
                             f"{[st.version for st in states.values()]}")
    commits = rt.mgr.total_steps_done()
    acc = rt.row_accounting()
    if acc["orphaned"] or acc["failed"] or acc["quarantine_dropped"] or \
            acc["completed"] != (acc["trained"] + acc["stale_dropped"]
                                 + acc["discarded_tails"]):
        raise AssertionError(f"phase 10 {run}: row accounting {acc}")
    ivs = rt.rec.intervals
    trains = sorted([iv for iv in ivs if iv.phase == "train"], key=lambda iv: iv.start)
    decodes = [iv for iv in ivs if iv.phase == "decode"]
    if len(trains) != commits or any(b.start < a.end - 1e-6
                                     for a, b in zip(trains, trains[1:])):
        raise AssertionError(f"phase 10 {run}: train intervals not serialised")
    decode_steps = eng.stats.decode_steps
    forwards = {k: c.n for k, c in fc.items()}
    prefill_forwards = sum(forwards.values()) - forwards["decode"]
    if forwards["decode"] != decode_steps:
        raise AssertionError(f"phase 10 {run}: forwards {forwards}, "
                             f"{decode_steps} decode steps")
    n_sgmv = sgmv_per_forward(cfg) * sum(forwards.values())
    attn = "paged_gqa_decode" if ALL_RUNS[run].get("paged_kv") else "gqa_decode"
    want = {"gqa_decode": 0, "paged_gqa_decode": 0, "sgmv": n_sgmv,
            "sgmv_cuda": n_sgmv, "token_logprob_fwd": commits,
            "token_logprob_bwd": commits}
    want[attn] = attn_per_step(cfg) * decode_steps
    got = {k: launches[k] for k in want}
    if run == "A":
        rows = commits * spec["group_size"] * spec["num_groups"]
        if commits != len(RT_ENVS) * spec["target_steps"] or acc != dict(
                completed=rows, trained=rows, stale_dropped=0,
                discarded_tails=0, failed=0, quarantine_dropped=0, orphaned=0):
            raise AssertionError(f"phase 10 A: {commits} commits, rows {acc}")
        if not any("+" in iv.task_id for iv in decodes):
            raise AssertionError("phase 10 A: no decode interval served two tenants")
        if not any(d.start < t.end and t.start < d.end for d in decodes for t in trains):
            raise AssertionError("phase 10 A: no decode interval overlaps a train interval")
    elif run == "B":
        if eng._pages.used_pages != 0:
            raise AssertionError(f"phase 10 B: {eng._pages.used_pages} pages held")
    else:
        st_ = eng.stats
        if eng._pages.used_pages != eng._prefix_idx.held_pages \
                or (run == "C" and st_.prefix_hits == 0) \
                or (run in P14_RUNS and (st_.prefix_hits or st_.cow_forks
                                         or eng._prefix_idx.held_pages)):
            raise AssertionError(f"phase 10 {run}: {eng._pages.used_pages} pages "
                                 f"held, {eng._prefix_idx.held_pages} by the index; "
                                 f"{st_.prefix_hits} prefix hits")
    if run in ("D", "T") or run in P14_RUNS:
        st_, waits = eng.stats, rt.rec.env_wait_by_task()
        agentic = {tid for tid, env in zip(tids, envs) if env == "hopsearch"}
        if not (st_.parks > 0 and st_.tool_wait_slot_steps == 0
                and st_.splices > 0 and st_.decode_stall_seconds == 0.0
                and set(waits) == agentic and all(waits.values())):
            raise AssertionError(f"phase 10 D: parks {st_.parks}, tool-wait slot "
                                 f"steps {st_.tool_wait_slot_steps}, splices "
                                 f"{st_.splices}, decode stall "
                                 f"{st_.decode_stall_seconds}, env wait {waits}")
    grad_norms = [float(m["grad_norm"]) for m in metrics]
    losses = [float(m["loss"]) for m in metrics]
    if len(metrics) != commits or not all(map(math.isfinite, grad_norms + losses)) \
            or not all(g > 0 for g in grad_norms):
        raise AssertionError(f"phase 10 {run}: train metrics {grad_norms} {losses}")
    if not all(installed.values()):
        raise AssertionError(f"phase 10 {run}: trained trees installed {installed}")

    def inside(t0_, t1_):
        return any(t0_ < t.end and t.start < t1_ for t in trains)
    pure = [(a, b) for a, b, d, f in steps if d == 1 and f == 0]
    d_in = [1e3 * (b - a) for a, b in pure if inside(a, b)]
    d_out = [1e3 * (b - a) for a, b in pure if not inside(a, b)]
    summary = summarize(rt.mgr, rt.rec)
    counters_ = rt.rec.counters_snapshot()
    drops = rt.mgr.drop_counters()
    rec = dict(run=run, config=ALL_RUNS[run], envs=envs, **spec,
               slots=RT_SLOTS, max_len=MAX_LEN, wall_to_last_commit_s=wall,
               commits=commits, rows=acc, decode_steps=decode_steps,
               prefill_forwards=prefill_forwards, forwards=forwards,
               decode_ms_per_step=1e3 * eng.stats.decode_seconds / decode_steps,
               decode_only_steps=len(pure),
               decode_step_ms_median=_median(d_in + d_out),
               decode_step_ms_p90=_pct(d_in + d_out, 0.9),
               decode_step_ms_median_in_train=_median(d_in),
               decode_step_ms_median_outside_train=_median(d_out),
               decode_steps_in_train=len(d_in), decode_steps_outside_train=len(d_out),
               train_ms_median=_median([1e3 * (t.end - t.start) for t in trains]),
               train_ms=[1e3 * (t.end - t.start) for t in trains],
               grad_norm=grad_norms, loss=losses, trained_trees_installed=installed,
               reward_history={tid: st.reward_history for tid, st in rt.mgr.task_items()},
               stale_rows_trained=counters_.get("stale_rows_trained", 0),
               stale_rows_dropped=drops["stale_rows_dropped"],
               discarded_tail_rows=drops["discarded_tail_rows"],
               summary={k: summary[k] for k in (
                   "span_s", "total_steps", "utilization_pct", "idle_pct",
                   "ttfs_mean_s", "ttfs_max_s", "tpts_mean_s", "slot_util_pct",
                   "steps_per_hr")},
               peak_mem_gib=peak_gib, launches=launches, card=card)
    if eng.prefix_cache:
        st_ = eng.stats
        rec["prefix"] = dict(prefix_hits=st_.prefix_hits,
                             prefix_hit_tokens=st_.prefix_hit_tokens,
                             cow_forks=st_.cow_forks,
                             prefill_tokens=st_.prefill_tokens,
                             index_pages=eng._prefix_idx.held_pages)
    if run in RT_RUN_ENVS:
        st_ = eng.stats
        rec["stages"] = dict(
            parks=st_.parks, resumes=st_.resumes, splices=st_.splices,
            tool_wait_slot_steps=st_.tool_wait_slot_steps,
            prefill_s=st_.prefill_seconds, decode_stall_s=st_.decode_stall_seconds,
            splice_s=st_.splice_seconds, splice_wait_s=st_.splice_wait_seconds,
            env_wait_by_task=rt.rec.env_wait_by_task())
    phase = 13 if run in P13_RUNS else "14a" if run in P14_RUNS else 10
    log(f"[{phase} runtime {run}] {cfg.name}: {len(envs)} tenants {envs} x {spec['target_steps']} "
        f"steps ({ALL_RUNS[run] or 'defaults'}): last commit at {wall:.2f} s, "
        f"{commits} commits, rows {acc}; {decode_steps} decode steps "
        f"({prefill_forwards} prefill forwards {forwards}), "
        f"decode {rec['decode_step_ms_median']:.2f} ms/step median "
        f"({rec['decode_step_ms_median_in_train']:.2f} in {len(d_in)} steps inside "
        f"train intervals, {rec['decode_step_ms_median_outside_train']:.2f} in "
        f"{len(d_out)} outside), train {rec['train_ms_median']:.1f} ms/step median; "
        f"grad_norm {min(grad_norms):.3e}-{max(grad_norms):.3e}, trained trees "
        f"installed {sum(installed.values())}; stale rows trained "
        f"{rec['stale_rows_trained']} dropped {rec['stale_rows_dropped']}; summary "
        f"{json.dumps(rec['summary'])}; peak {peak_gib:.2f} GiB; launches {got} on {card}"
        + (f"; prefix cache {json.dumps(rec['prefix'])}" if "prefix" in rec else "")
        + (f"; stages {json.dumps(rec['stages'])}" if "stages" in rec else ""))
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"phase 10 {run}: launches {got}, want {want}")
    if rt.tracer is not None:
        rec["trace"] = trace_checks(rt, run, card)
    return rec


# ---------------------------------------------------------------------------
# phase 11: the copy-on-write prefix cache in the continuous engine
# ---------------------------------------------------------------------------

def prefix_requests():
    """Phase 11's 32 requests: each tenant's two gsm8k prompts behind one
    128-token header (8 whole pages), each prompt a GRPO group of 4; the
    first groups come first, the second ones (priority 1) later."""
    from repro_torch.launch.serve import make_group_requests
    reqs = make_group_requests(TENANTS, P11_PROMPTS, P11_GROUP,
                               header_len=P11_HEADER, max_new_tokens=P11_MAX_NEW,
                               seed=11)
    early = [r for i, r in enumerate(reqs) if (i // P11_GROUP) % 2 == 0]
    late = [r for r in reqs if r not in early]
    for r in late:
        r.priority = 1
    return early, late


def expected_prefix_hits(reqs, page):
    """The prefix hits and hit tokens of phase 11's schedule, from the
    prompts alone (``tests/test_torch_prefix.py`` runs the same schedule on
    the CPU and gets these): the first row of each tenant's first group
    prefills privately; every other row of a group shares all of its
    leader's pages (the full pages, plus the tail, which is recomputed when
    the prompt is page-aligned); the leader of a later group shares the full
    pages its prompt has in common with the tenant's earlier prompts (at
    least one token left to prefill)."""
    hits = tokens = 0
    seen = []
    for r in reqs:
        L = len(r.prompt)
        if (r.adapter_index, r.prompt) in seen:
            hits += 1
            tokens += L // page * page if L % page else L - page
            continue
        best = 0
        for a, p in seen:
            if a != r.adapter_index:
                continue
            n = 0
            while (n + 1) * page <= min(L - 1, len(p)) and \
                    p[n * page:(n + 1) * page] == r.prompt[n * page:(n + 1) * page]:
                n += 1
            best = max(best, n)
        if best:
            hits += 1
            tokens += best * page
        seen.append((r.adapter_index, r.prompt))
    return hits, tokens


def prefix_run(torch, cfg, params, adapters, *, prefix_cache, pool=0,
               max_new=P11_MAX_NEW, counters=None):
    """One drive of phase 11's schedule on the card: the first groups, then
    after decode step P11_LATE_AT the second groups arrive (priority 1) and
    tenant-1 is preempted for them (its rows park in the pool with the
    prefix cache, snapshot to host without). Page invariants after every
    step; the refill and suffix forwards, index evictions and spills are
    counted, and with `counters` the kernels' launches from just before the
    drive to just after it. Returns the completions by submit index and
    the record."""
    from repro_torch.rollout.engine import ContinuousRolloutEngine
    early, late = prefix_requests()
    for r in early + late:
        r.max_new_tokens = max_new
    eng = ContinuousRolloutEngine(
        cfg, params, max_slots=CONT_SLOTS, max_adapters=TENANTS,
        max_len=CONT_MAX_LEN, paged_kv=True, prefix_cache=prefix_cache,
        kv_page_size=PAGE, kv_pool_pages=pool, device="cuda")
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    n = {"forwards": 0, "evicted": 0, "spilled": 0}

    def counted(fn, key, size=lambda out: 1):
        def wrapped(*a):
            out = fn(*a)
            n[key] += size(out)
            return out
        return wrapped
    eng._refill_fn = counted(eng._refill_fn, "forwards")
    if prefix_cache:
        eng._suffix_fn = counted(eng._suffix_fn, "forwards")
        eng._prefix_idx.pop_lru = counted(eng._prefix_idx.pop_lru, "evicted", len)
        eng._spill_dev_parked = counted(eng._spill_dev_parked, "spilled", int)
    for r in early:
        eng.submit(r)
    torch.cuda.synchronize()
    if counters is not None:
        count_all(counters, reset=True)
    comps, parked, steps, hbm = {}, 0, 0, []
    t0 = time.monotonic()
    while not eng.idle():
        eng.step()
        steps += 1
        eng.check_page_invariants()
        if any(r is not None for r in eng._rows):
            hbm.append(eng.page_stats()["kv_hbm_bytes_per_row"])
        if not parked and eng.stats.decode_steps >= P11_LATE_AT:
            for r in late:
                eng.submit(r)
            parked = eng.preempt_tenant("tenant-1")
            if not parked:
                raise AssertionError("phase 11: tenant-1 had no resident row")
        for c in eng.drain_completions():
            comps[c.submit_index] = c
        if steps > 50 * max_new:
            raise AssertionError("phase 11: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = count_all(counters) if counters is not None else None
    if sorted(comps) != list(range(len(early) + len(late))):
        raise AssertionError(f"phase 11: completions {sorted(comps)}")
    st = eng.stats
    held = eng._prefix_idx.held_pages if prefix_cache else 0
    if eng._pages.used_pages != held:
        raise AssertionError(f"phase 11: {eng._pages.used_pages} pages held at "
                             f"idle, {held} by the index")
    rec = dict(prefix_cache=prefix_cache, pool_pages=eng.kv_pool_pages,
               rows=len(comps), preempted_rows=parked, decode_steps=st.decode_steps,
               decode_ms_per_step=1e3 * st.decode_seconds / st.decode_steps,
               prefill_s=st.prefill_seconds, prefill_tokens=st.prefill_tokens,
               forwards=n["forwards"], prefix_hits=st.prefix_hits,
               prefix_hit_tokens=st.prefix_hit_tokens, cow_forks=st.cow_forks,
               device_resident_resumes=st.device_resident_resumes,
               restores=st.restores, snapshots=st.snapshots,
               snapshot_drops=st.snapshot_drops, replays=st.replays,
               pool_exhausted=st.pool_exhausted, index_evicted_pages=n["evicted"],
               spills=n["spilled"], kv_pages_peak=eng._pages.peak_used,
               kv_hbm_bytes_per_row=_median(hbm), index_pages_at_idle=held,
               finish_reasons=sorted({c.finish_reason for c in comps.values()}),
               wall_s=wall, launches=launches)
    return comps, rec


def parted_rows(torch, a, b, reqs, vocab):
    """Rows of two runs of the same requests (completions by submit index;
    `reqs` by submit index too): how many streams are equal; where two
    part, the largest difference of the logprobs of the tokens they share,
    and at the token where they part the difference of the sampler's two
    scores, logprob + temperature x the row's Gumbel noise at that counter
    (the sampler takes the argmax of logits / temperature + noise, so a
    parting token is a near-tie in that score, not in the logprob)."""
    from repro_torch.rollout import prng
    equal, parted, shared_err, tie_err = 0, 0, 0.0, 0.0
    for i in a:
        ta, tb = a[i].tokens[a[i].prompt_len:], b[i].tokens[b[i].prompt_len:]
        la, lb = a[i].gen_logprobs, b[i].gen_logprobs
        t = next((k for k in range(min(len(ta), len(tb))) if ta[k] != tb[k]),
                 None)
        same = min(len(ta), len(tb)) if t is None else t
        if same:
            shared_err = max(shared_err, max(abs(x - y) for x, y in
                                             zip(la[:same], lb[:same])))
        if t is None:
            equal += ta == tb
            continue
        parted += 1
        key = prng.fold_in_host(prng.prng_key(0), reqs[i].seed)
        g = prng.gumbel(prng.fold_in(torch.from_numpy(key.astype("int64"))[None],
                                     torch.tensor([t])), vocab)[0]
        T = reqs[i].temperature
        tie_err = max(tie_err, abs((la[t] + T * float(g[ta[t]]))
                                   - (lb[t] + T * float(g[tb[t]]))))
    return equal, parted, shared_err, tie_err


def prefix_phase(torch, cfg, params, adapters, counters, card):
    """Phase 11: phase 11's schedule with the prefix cache (the engine's
    default with the paged pool; launches counted over this drive), then
    the same requests with private pages, then with the cache and a pool
    of P11_SMALL_POOL pages, then both modes in fp32 (TF32 off). Raises on
    any miss; returns the record."""
    import dataclasses
    from repro_torch.core.admission import (task_state_bytes_paged,
                                            task_state_bytes_shared)
    from repro_torch.core.manager import TaskSpec
    from repro_torch.models import tree_map
    early, late = prefix_requests()
    want_hits = expected_prefix_hits(early + late, PAGE)
    shared, rec = prefix_run(torch, cfg, params, adapters, prefix_cache=True,
                             counters=counters)
    private, rec_p = prefix_run(torch, cfg, params, adapters, prefix_cache=False)
    _, rec_s = prefix_run(torch, cfg, params, adapters, prefix_cache=True,
                          pool=P11_SMALL_POOL)
    n_sgmv = 6 * cfg.num_layers * (rec["decode_steps"] + rec["forwards"])
    want = {"paged_gqa_decode": cfg.num_layers * rec["decode_steps"],
            "gqa_decode": 0, "sgmv": n_sgmv, "sgmv_cuda": n_sgmv}
    got = {k: rec["launches"][k] for k in want}
    problems = []
    if got != want:
        problems.append(f"launches {got}, want {want}")
    if 2 * rec["prefill_tokens"] > rec_p["prefill_tokens"]:
        problems.append(f"prefill tokens {rec['prefill_tokens']} with the cache, "
                        f"{rec_p['prefill_tokens']} without")
    if (rec["prefix_hits"], rec["prefix_hit_tokens"]) != want_hits:
        problems.append(f"prefix hits {rec['prefix_hits']} / tokens "
                        f"{rec['prefix_hit_tokens']}, want {want_hits}")
    if not (rec["cow_forks"] > 0 and rec["device_resident_resumes"] > 0
            and rec["snapshots"] == 0 and rec["spills"] == 0):
        problems.append(f"forks {rec['cow_forks']}, device-resident resumes "
                        f"{rec['device_resident_resumes']}, snapshots "
                        f"{rec['snapshots']}, spills {rec['spills']}")
    if not (rec_s["index_evicted_pages"] > 0 and rec_s["spills"] > 0
            and rec_s["kv_pages_peak"] <= P11_SMALL_POOL):
        problems.append(f"small pool: {rec_s['index_evicted_pages']} index pages "
                        f"evicted, {rec_s['spills']} spills, peak "
                        f"{rec_s['kv_pages_peak']}")
    # fp32, TF32 off (main() turns it off): both modes, fewer new tokens
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    p32 = tree_map(lambda t: t.float(), params)
    a32 = [tree_map(lambda t: t.float(), a) for a in adapters]
    on32, rec32 = prefix_run(torch, cfg32, p32, a32, prefix_cache=True,
                             max_new=P11_FP32_NEW)
    off32, rec32_p = prefix_run(torch, cfg32, p32, a32, prefix_cache=False,
                                max_new=P11_FP32_NEW)
    del p32, a32
    by_index = dict(enumerate(early + late))        # by submit index
    equal, parted, shared_err, tie_err = parted_rows(torch, on32, off32,
                                                     by_index, cfg.vocab_size)
    if not (shared_err <= TF_TOL and tie_err <= TF_TOL):
        problems.append(f"fp32: shared-token logprobs differ by {shared_err:.3e}, "
                        f"parting scores by {tie_err:.3e} (tol {TF_TOL})")
    bf16_equal = sum(shared[i].tokens == private[i].tokens for i in shared)
    L = sorted(len(r.prompt) for r in early + late)[len(early + late) // 2]
    spec = TaskSpec("t", "gsm8k", group_size=P11_GROUP, num_groups=P11_PROMPTS,
                    max_new_tokens=P11_MAX_NEW)
    admit = (task_state_bytes_paged(cfg, spec, L, page_size=PAGE)
             / task_state_bytes_shared(cfg, spec, L, page_size=PAGE))
    out = dict(requests=len(early + late), header=P11_HEADER, prompt_len=L,
               slots=CONT_SLOTS, page=PAGE, max_len=CONT_MAX_LEN,
               late_at=P11_LATE_AT, expected_prefix_hits=want_hits,
               shared=rec, private=rec_p, small_pool=rec_s,
               fp32=dict(new_tokens=P11_FP32_NEW, rows_equal=equal,
                         rows_parted=parted, shared_logprob_max_abs_diff=shared_err,
                         parting_score_max_abs_diff=tie_err, tol=TF_TOL,
                         shared=rec32, private=rec32_p),
               bf16_rows_equal=bf16_equal,
               admission_paged_over_shared=admit, card=card)
    log(f"[11 prefix cache] {len(early + late)} requests ({TENANTS} tenants x "
        f"{P11_PROMPTS} prompts x groups of {P11_GROUP}, {P11_HEADER}-token header, "
        f"prompts ~{L} tokens, {P11_MAX_NEW} new), {CONT_SLOTS} slots, pages of "
        f"{PAGE}, tenant-1 preempted after step {P11_LATE_AT} on {card}")
    for name, r in (("cache", rec), ("private", rec_p),
                    (f"cache, {P11_SMALL_POOL}-page pool", rec_s),
                    ("fp32 cache", rec32), ("fp32 private", rec32_p)):
        log(f"  {name}: {r['decode_steps']} decode steps "
            f"{r['decode_ms_per_step']:.2f} ms/step, prefill {r['prefill_s']:.3f} s "
            f"({r['prefill_tokens']} tokens, {r['forwards']} forwards), hits "
            f"{r['prefix_hits']} ({r['prefix_hit_tokens']} tokens), forks "
            f"{r['cow_forks']}, device-resident resumes {r['device_resident_resumes']}, "
            f"snapshots {r['snapshots']}, index pages evicted "
            f"{r['index_evicted_pages']}, spills {r['spills']}, pages peak "
            f"{r['kv_pages_peak']}, HBM bytes/row (median over steps) "
            f"{r['kv_hbm_bytes_per_row']:.0f}, finishes {r['finish_reasons']}, "
            f"wall {r['wall_s']:.2f} s")
    log(f"  expected hits {want_hits}; launches {got}; bf16 rows equal to the "
        f"private run {bf16_equal}/{len(shared)}; fp32 rows equal {equal}/{len(on32)} "
        f"(parted {parted}; shared-token logprobs max diff {shared_err:.3e}, "
        f"parting scores {tie_err:.3e}, tol {TF_TOL}); admission paged/shared "
        f"bytes {admit:.3f}")
    if problems:
        raise AssertionError("phase 11: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 12: the disaggregated stages in the continuous engine
# ---------------------------------------------------------------------------

def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else float("nan")


def stage_requests(max_new):
    """Phase 12's 32 requests: CONT_PER_TENANT a tenant, tenants on
    P12_ENVS (hopsearch: kb 32, 2 hops, at most 2 tool turns, the env's own
    latency of 0.08 +- 0.02 s a call), explicit per-row seeds."""
    from repro_torch.envs.tasks import make_env
    from repro_torch.rollout.engine import RolloutRequest
    rng, reqs = random.Random(12), []
    for t, name in enumerate(P12_ENVS):
        env = (make_env(name, kb_size=32, hops=2) if name == "hopsearch"
               else make_env(name))
        for _ in range(CONT_PER_TENANT):
            prompt, truth = env.sample_prompt(rng)
            reqs.append(RolloutRequest(
                f"tenant-{t}", t, prompt, truth, env, max_new_tokens=max_new,
                seed=3000 + len(reqs),
                max_turns=2 if env.is_agentic else None))
    return reqs


def stage_run(torch, cfg, params, adapters, mode, counters, max_new):
    """One drive of phase 12's requests in `mode` (P12_MODES) on the card,
    all submitted at once: page invariants after every step of a paged
    engine, each decode step's time (the engine's clock), the kernels'
    launches from just before the drive to just after, and the engine's
    forwards. Returns the completions by submit index and the record."""
    from repro_torch.rollout.engine import ContinuousRolloutEngine
    kw = dict(dict(paged_kv=True, kv_page_size=PAGE), **P12_MODES[mode])
    reqs = stage_requests(max_new)
    eng = ContinuousRolloutEngine(cfg, params, max_slots=CONT_SLOTS,
                                  max_adapters=TENANTS, max_len=CONT_MAX_LEN,
                                  device="cuda", **kw)
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    for r in reqs:
        eng.submit(r)
    gc.collect()            # the earlier modes' engines: out of the peak
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count_all(counters, reset=True)
    comps, step_ms, st = {}, [], eng.stats
    t0 = time.monotonic()
    deadline = t0 + 600
    while not eng.idle():
        d0, s0 = st.decode_steps, st.decode_seconds
        progressed = eng.step()
        if st.decode_steps > d0:
            step_ms.append(1e3 * (st.decode_seconds - s0))
        if eng.paged_kv:
            eng.check_page_invariants()
        for c in eng.drain_completions():
            comps[c.submit_index] = c
        if time.monotonic() > deadline:
            raise AssertionError(f"phase 12 {mode}: the engine did not drain")
        if not progressed:
            time.sleep(0.0005)      # waiting on the workers or the tools
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = count_all(counters)
    forwards = {k: c.n for k, c in eng.forward_counts.items()}
    held = eng._prefix_idx.held_pages if eng.prefix_cache else 0
    pages_used = eng._pages.used_pages if eng.paged_kv else 0
    eng.shutdown()
    # a worker call's cost with no other thread launching, beside the
    # worker calls' time under contention above
    alone_ms = whole_alone_ms(torch, eng, reqs[0]) if eng.disagg_prefill else None
    rec = dict(mode=mode, config=kw, rows=len(comps), decode_steps=st.decode_steps,
               decode_ms_median=_median(step_ms), decode_ms_p90=_pct(step_ms, 0.9),
               prefill_s=st.prefill_seconds,
               prefill_on="workers" if eng.disagg_prefill else "decode thread",
               prefill_chunks=st.prefill_chunks, prefill_tokens=st.prefill_tokens,
               splices=st.splices, splice_s=st.splice_seconds,
               splice_wait_s=st.splice_wait_seconds,
               decode_stall_s=st.decode_stall_seconds,
               slot_occupancy=st.slot_utilization(),
               tool_wait_slot_steps=st.tool_wait_slot_steps, parks=st.parks,
               resumes=st.resumes, restores=st.restores,
               device_resident_resumes=st.device_resident_resumes,
               snapshots=st.snapshots, replays=st.replays,
               fused_forced_tokens=st.fused_forced_tokens,
               env_wait_s=st.env_wait_seconds, forwards=forwards,
               worker_call_ms_mean=(1e3 * st.prefill_seconds / st.prefill_chunks
                                    if st.prefill_chunks else None),
               whole_call_alone_ms=alone_ms,
               pages_used_at_idle=pages_used, index_pages_at_idle=held,
               wall_s=wall, peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches)
    return comps, reqs, rec


def whole_alone_ms(torch, eng, req, n=5):
    """Host time of one prefill-worker call (``PrefillKernels.whole`` on
    one row, the engine's adapters) run on this thread with no other thread
    launching, synchronised: median of n after a warm-up call."""
    from repro_torch.rollout.prefill import _bucket_len
    L = len(req.prompt)
    Lb = _bucket_len(L)
    width = -(-Lb // eng.kv_page_size) * eng.kv_page_size
    toks = torch.zeros((1, Lb), dtype=torch.int32, device=eng.device)
    toks[0, :L] = torch.tensor(req.prompt, dtype=torch.int32)

    def vec(x, dt):
        return torch.tensor(x, dtype=dt, device=eng.device)
    args = (eng.base_params, eng._stacked, vec([req.adapter_index], torch.int32),
            toks, L, width, vec([0], torch.int32), vec([[1, 2]], torch.int64),
            vec([req.temperature], torch.float32), vec([0], torch.int32),
            vec([0], torch.int32))
    times = []
    with torch.no_grad():
        for _ in range(n + 1):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            first = eng._pkernels.whole(*args)[0]
            int(first.cpu()[0])
            times.append(1e3 * (time.monotonic() - t0))
    return _median(times[1:])


def stage_checks(cfg, rec):
    """Phase 12's checks on one bf16 mode's record; returns the misses."""
    m, bad = rec["mode"], []
    env_stage = P12_MODES[m].get("env_stage", False)
    disagg = P12_MODES[m].get("disagg_prefill", False)
    if rec["rows"] != TENANTS * CONT_PER_TENANT:
        bad.append(f"{rec['rows']} completions")
    if env_stage:
        if not (rec["tool_wait_slot_steps"] == 0 and rec["parks"] > 0
                and rec["resumes"] == rec["parks"]):
            bad.append(f"tool-wait slot steps {rec['tool_wait_slot_steps']}, parks "
                       f"{rec['parks']}, resumes {rec['resumes']}")
    elif rec["tool_wait_slot_steps"] <= 0 or rec["parks"]:
        bad.append(f"frozen calls: tool-wait slot steps "
                   f"{rec['tool_wait_slot_steps']}, parks {rec['parks']}")
    if m == "DE" and not (rec["device_resident_resumes"] == rec["resumes"]
                          and rec["snapshots"] == 0):
        bad.append(f"device-resident resumes {rec['device_resident_resumes']}, "
                   f"snapshots {rec['snapshots']}")
    if m == "DER" and not rec["fused_forced_tokens"] > 0:
        bad.append("no fused forced token")
    if disagg:
        if not (rec["splices"] > 0 and rec["decode_stall_s"] == 0.0):
            bad.append(f"splices {rec['splices']}, decode stall {rec['decode_stall_s']}")
    elif not rec["decode_stall_s"] == rec["prefill_s"] > 0:
        bad.append(f"decode stall {rec['decode_stall_s']} != prefill {rec['prefill_s']}")
    if rec["pages_used_at_idle"] != rec["index_pages_at_idle"]:
        bad.append(f"{rec['pages_used_at_idle']} pages held at idle, "
                   f"{rec['index_pages_at_idle']} by the index")
    fw, steps, L = rec["forwards"], rec["decode_steps"], cfg.num_layers
    attn = "paged_gqa_decode" if P12_MODES[m].get("paged_kv", True) else "gqa_decode"
    other = "gqa_decode" if attn == "paged_gqa_decode" else "paged_gqa_decode"
    n_sgmv = 6 * L * sum(fw.values())
    want = {attn: L * steps, other: 0, "sgmv": n_sgmv, "sgmv_cuda": n_sgmv}
    got = {k: rec["launches"][k] for k in want}
    if got != want or fw["decode"] != steps:
        bad.append(f"launches {got}, want {want} (forwards {fw})")
    return [f"{m}: {b}" for b in bad]


def stage_phase(torch, cfg, params, adapters, counters, card):
    """Phase 12: phase 12's requests in every mode of P12_MODES in bf16 at
    P12_MAX_NEW new tokens, then in fp32 (TF32 off) at P12_FP32_NEW new tokens
    in P12_FP32_MODES,
    all under the biased sampler (undone at the end). Raises on any miss;
    returns the record."""
    import dataclasses
    from repro_torch.models import tree_map
    undo = biased_sampler(torch)
    try:
        runs = {m: stage_run(torch, cfg, params, adapters, m, counters,
                             P12_MAX_NEW) for m in P12_MODES}
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        a32 = [tree_map(lambda t: t.float(), a) for a in adapters]
        runs32 = {m: stage_run(torch, cfg32, p32, a32, m, counters, P12_FP32_NEW)
                  for m in P12_FP32_MODES}
        del p32, a32
    finally:
        undo()
    problems = []
    for m, (_, _, rec) in runs.items():
        problems += stage_checks(cfg, rec)
    by_index = dict(enumerate(runs["F"][1]))
    bf16_equal = {m: sum(runs[m][0][i].tokens == runs["F"][0][i].tokens
                         for i in by_index) for m in P12_MODES}
    fp32 = {}
    for m in P12_FP32_MODES[1:]:
        equal, parted, shared_err, tie_err = parted_rows(
            torch, runs32["F"][0], runs32[m][0], by_index, cfg.vocab_size)
        fp32[m] = dict(rows_equal=equal, rows_parted=parted,
                       shared_logprob_max_abs_diff=shared_err,
                       parting_score_max_abs_diff=tie_err)
        if not (shared_err <= TF_TOL and tie_err <= TF_TOL):
            problems.append(f"fp32 {m} vs F: shared-token logprobs differ by "
                            f"{shared_err:.3e}, parting scores by {tie_err:.3e}")
    out = dict(requests=len(by_index), envs=P12_ENVS, slots=CONT_SLOTS,
               page=PAGE, max_len=CONT_MAX_LEN, max_new_tokens=P12_MAX_NEW,
               call_at=CALL_AT, modes={m: r[2] for m, r in runs.items()},
               bf16_rows_equal_to_F=bf16_equal,
               fp32=dict(new_tokens=P12_FP32_NEW, tol=TF_TOL, vs_F=fp32,
                         modes={m: r[2] for m, r in runs32.items()}),
               card=card)
    log(f"[12 stages] {len(by_index)} requests ({TENANTS} tenants {P12_ENVS} x "
        f"{CONT_PER_TENANT}, {P12_MAX_NEW} new, CALL at counters {CALL_AT}), "
        f"{CONT_SLOTS} slots, pages of {PAGE}, max_len {CONT_MAX_LEN} on {card}")
    for name, r in [(m, runs[m][2]) for m in P12_MODES] + \
            [(f"fp32 {m}", runs32[m][2]) for m in P12_FP32_MODES]:
        log(f"  {name}: {r['decode_steps']} decode steps, decode "
            f"{r['decode_ms_median']:.2f} ms/step median, {r['decode_ms_p90']:.2f} "
            f"p90; prefill {r['prefill_s']:.3f} s on the {r['prefill_on']} "
            f"({r['prefill_chunks']} worker calls, {r['prefill_tokens']} tokens), "
            f"splices {r['splices']} in {r['splice_s']:.3f} s (wait "
            f"{r['splice_wait_s']:.3f} s), decode stall {r['decode_stall_s']:.3f} s, "
            f"slot occupancy {r['slot_occupancy']:.3f}, tool-wait slot steps "
            f"{r['tool_wait_slot_steps']}, parks {r['parks']} resumes {r['resumes']} "
            f"(device-resident {r['device_resident_resumes']}, replays "
            f"{r['replays']}, fused forced tokens {r['fused_forced_tokens']}); "
            f"forwards {r['forwards']}; wall {r['wall_s']:.2f} s, peak "
            f"{r['peak_mem_gib']:.2f} GiB"
            + (f"; a worker call {r['worker_call_ms_mean']:.1f} ms mean, "
               f"{r['whole_call_alone_ms']:.1f} ms alone"
               if r["whole_call_alone_ms"] is not None else ""))
    log(f"  bf16 rows equal to F {bf16_equal}; fp32 vs F "
        + "; ".join(f"{m}: {v['rows_equal']} equal, {v['rows_parted']} parted, "
                    f"shared logprobs {v['shared_logprob_max_abs_diff']:.3e}, "
                    f"parting scores {v['parting_score_max_abs_diff']:.3e}"
                    for m, v in fp32.items()) + f" (tol {TF_TOL})")
    if problems:
        raise AssertionError("phase 12: " + "; ".join(problems))
    return out


# ---------------------------------------------------------------------------
# phase 13: tracing, chaos and restart from a checkpoint
# ---------------------------------------------------------------------------

def trace_checks(rt, run, card):
    """Run T's trace: every episode from `submitted` to `committed` or
    `dropped`, none lost to the ring buffer; the Chrome export written and
    read back by the port's report command, whose components sum to each
    episode's latency within 1%. Returns the report's figures."""
    import tempfile
    from repro_torch.obs import report
    tr = rt.tracer
    seqs = {t: tr.state_sequence(t) for t in tr.components()}
    bad = {t: q for t, q in seqs.items()
           if q[0] != "submitted" or q[-1] not in ("committed", "dropped")}
    issued = sum(st.rollout_rows_total for _, st in rt.mgr.task_items())
    if bad or len(seqs) != issued or tr.dropped_events:
        raise AssertionError(f"phase 13 {run}: {len(seqs)} traced episodes of "
                             f"{issued}, {tr.dropped_events} events dropped, "
                             f"malformed {list(bad.items())[:3]}")
    with tempfile.TemporaryDirectory() as d:
        path, out = Path(d) / "trace.json", Path(d) / "report.json"
        tr.dump_json(str(path))
        trace_bytes = path.stat().st_size
        if report.main([str(path), "--json", str(out)]) != 0:
            raise AssertionError(f"phase 13 {run}: the report found no episode")
        res = json.loads(out.read_text())
    if res["episodes"] != len(seqs) or not res["max_relative_residual"] <= 0.01:
        raise AssertionError(f"phase 13 {run}: report episodes {res['episodes']}, "
                             f"residual {res['max_relative_residual']}")
    terminals = {}
    for q in seqs.values():
        terminals[q[-1]] = terminals.get(q[-1], 0) + 1
    tenants = {tid: dict(episodes=t["episodes"], e2e_p50_s=t["e2e_p50"],
                         e2e_p95_s=t["e2e_p95"], bottleneck=t["bottleneck"],
                         components_mean_s=t["components_mean"])
               for tid, t in res["tenants"].items()}
    comp_total = {}
    for t in res["tenants"].values():
        for k, v in t["components_mean"].items():
            comp_total[k] = comp_total.get(k, 0.0) + v * t["episodes"]
    bottleneck = max(comp_total, key=comp_total.get)
    out = dict(episodes=len(seqs), terminals=terminals,
               max_relative_residual=res["max_relative_residual"],
               trace_bytes=trace_bytes, tenants=tenants,
               bottleneck=bottleneck,
               component_share={k: v / sum(comp_total.values())
                                for k, v in sorted(comp_total.items())},
               flow_kinds=sorted({k for t in seqs for k in tr.flow_kinds_of(t)}))
    log(f"[13 trace {run}] {len(seqs)} episodes {terminals}, residual "
        f"{100 * res['max_relative_residual']:.4f}% of E2E, trace "
        f"{trace_bytes} bytes; per tenant E2E p50/p95 "
        + ", ".join(f"{tid} {t['e2e_p50_s']:.2f}/{t['e2e_p95_s']:.2f} s "
                    f"({t['bottleneck']})" for tid, t in tenants.items())
        + f"; bottleneck over all episodes {bottleneck} "
        f"({100 * out['component_share'][bottleneck]:.1f}% of episode time) on {card}")
    return out


def _same_tree(np, store, a, b):
    """Bit-equal trees (tensors on any device or numpy leaves), dtypes too."""
    fa, fb = store.tree_to_flat(a), store.tree_to_flat(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and np.array_equal(fa[k], fb[k]) for k in fa)


def recovery_run(torch, cfg, params, counters, card, ckpt_dir, device="cuda"):
    """Phase 13 run R: run T's runtime with P13_CHAOS, a snapshot after every
    commit (P13_KEEP kept) and a crash after P13_FAIL_AFTER commits, through
    run_with_recovery. Class-level wraps (undone at the end) reach both
    incarnations: each engine step is timed and followed by the page
    invariants; each commit's trees are kept; each save and its hold of the
    manager lock are timed; the adoption compares the snapshot with the
    crashed runtime's committed trees and the adopted trees with the
    snapshot, then pins the prompt streams and graded envs again. Raises on
    any miss; returns the record."""
    import numpy as np
    from repro_torch.checkpoint import store
    from repro_torch.core import runtime as rt_mod
    from repro_torch.core.chaos import ChaosConfig
    from repro_torch.core.manager import MultiTaskManager, TaskSpec
    from repro_torch.core.runtime import (FailureInjector, MARLaaSRuntime,
                                          RuntimeConfig)
    from repro_torch.launch.serve import make_adapters
    from repro_torch.models import tree_leaves
    from repro_torch.rollout.engine import ContinuousRolloutEngine as Eng

    envs = RT_RUN_ENVS["T"]
    tids = [f"{env}-{i}" for i, env in enumerate(envs)]
    gc.collect()
    rcfg = RuntimeConfig(policy="marlaas", device=device, max_slots=RT_SLOTS,
                         max_adapter_slots=len(envs), max_len=MAX_LEN, seed=0,
                         checkpoint_dir=ckpt_dir, checkpoint_every=1,
                         checkpoint_keep_last=P13_KEEP,
                         chaos=ChaosConfig(**P13_CHAOS), **P13_RUNS["T"])
    rt = MARLaaSRuntime(cfg, params, rcfg, failure=FailureInjector(
        fail_after_commits=P13_FAIL_AFTER))
    adapters = make_adapters(cfg, len(envs), seed=20, device=device,
                             b_scale=B_SCALE)

    def pin(r):
        for i, tid in enumerate(tids):
            r.envs[tid] = graded_env(r.envs[tid])
            r.datagens[tid] = random.Random(100 + i)
        r.mgr.rebind_episode_envs(r.envs)
    for tid, env, tree in zip(tids, envs, adapters):
        rt.submit_task(TaskSpec(tid, env, **RT_SPEC), tree)
    pin(rt)
    committed = {(tid, 0): (st.adapters, st.opt_state)
                 for tid, st in rt.mgr.task_items()}
    steps, commit_times, saves, holds, snap_calls, fresh = [], [], [], [], [0], []
    engines = []
    orig = dict(commit=MultiTaskManager.commit, step=Eng.step,
                snap=Eng._snapshot_row, save=rt_mod.save_checkpoint,
                payload=store._write_payload,
                adopt=MARLaaSRuntime.adopt_checkpoint)

    def commit(self, tid, adapters_, opt, version, **kw):
        out = orig["commit"](self, tid, adapters_, opt, version, **kw)
        committed[(tid, self.state(tid).version)] = (adapters_, opt)
        commit_times.append(time.monotonic())
        return out

    def step(self):
        if self not in engines:
            engines.append(self)
        fc = self.forward_counts
        d0, f0 = self.stats.decode_steps, fc["refill"].n + fc["suffix"].n
        t0 = time.monotonic()
        out = orig["step"](self)
        steps.append((t0, time.monotonic(), self.stats.decode_steps - d0,
                      fc["refill"].n + fc["suffix"].n - f0, id(self)))
        self.check_page_invariants()
        return out

    def snapshot_row(self, slot, row):
        snap_calls[0] += 1
        return orig["snap"](self, slot, row)

    def save(directory, mgr, *a, **kw):
        t0 = time.monotonic()
        path = orig["save"](directory, mgr, *a, **kw)
        t1 = time.monotonic()
        nbytes = sum(f.stat().st_size for f in Path(path).iterdir())
        saves.append((t0, t1, nbytes))
        return path

    def payload(tmp, mgr, tag):
        t0 = time.monotonic()
        out = orig["payload"](tmp, mgr, tag)
        holds.append(time.monotonic() - t0)
        return out

    def adopt(self, path):
        snap = store.load_checkpoint(path, MultiTaskManager())
        for tid, st in snap.task_items():
            ad, opt = committed[(tid, st.version)]
            if not (_same_tree(np, store, st.adapters, ad)
                    and _same_tree(np, store, st.opt_state, opt)):
                raise AssertionError(f"phase 13 R: snapshot {path} differs from "
                                     f"{tid}'s committed v{st.version} trees")
        orig["adopt"](self, path)
        for tid, st in self.mgr.task_items():
            want = snap.state(tid)
            if not (_same_tree(np, store, st.adapters, want.adapters)
                    and _same_tree(np, store, st.opt_state, want.opt_state)
                    and all(t.device.type == device for t in
                            tree_leaves(st.adapters) + tree_leaves(st.opt_state))):
                raise AssertionError(f"phase 13 R: {tid}'s adopted trees differ "
                                     f"from the snapshot")
        pin(self)
        fresh.append((self, path, {tid: st.version
                                   for tid, st in snap.task_items()}))

    MultiTaskManager.commit, Eng.step, Eng._snapshot_row = commit, step, snapshot_row
    rt_mod.save_checkpoint, store._write_payload = save, payload
    MARLaaSRuntime.adopt_checkpoint = adopt
    undo = biased_sampler(torch)
    torch.cuda.synchronize()
    count_all(counters, reset=True)
    t0 = time.monotonic()
    try:
        fin = rt.run_with_recovery(timeout_s=900)
    finally:
        undo()
        MultiTaskManager.commit, Eng.step = orig["commit"], orig["step"]
        Eng._snapshot_row = orig["snap"]
        rt_mod.save_checkpoint, store._write_payload = orig["save"], orig["payload"]
        MARLaaSRuntime.adopt_checkpoint = orig["adopt"]
    launches = count_all(counters)
    torch.cuda.synchronize()
    wall = max(commit_times) - t0
    if len(fresh) != 1 or fresh[0][0] is not fin or fin is rt:
        raise AssertionError(f"phase 13 R: {len(fresh)} adoptions")
    restarts = fin.rec.counters_snapshot().get("checkpoint_restarts", 0)
    versions = {tid: st.version for tid, st in fin.mgr.task_items()}
    if restarts != 1 or not fin.mgr.all_done() or set(versions.values()) != {
            RT_SPEC["target_steps"]}:
        raise AssertionError(f"phase 13 R: restarts {restarts}, versions {versions}")
    chaos = {"crashed": rt.chaos.counts(), "restarted": fin.chaos.counts()}
    fired = {site: chaos["crashed"].get(site, 0) + chaos["restarted"].get(site, 0)
             for site in ("prefill_worker_kill", "env_worker_kill",
                          "tool_error_transient", "snapshot_drop")}
    if not all(fired[s_] for s_ in ("prefill_worker_kill", "env_worker_kill",
                                   "tool_error_transient")) \
            or fired["snapshot_drop"] != min(1, snap_calls[0]) \
            or fired["snapshot_drop"] != P13_SNAPSHOT_DROPS:
        raise AssertionError(f"phase 13 R: chaos fired {chaos}, "
                             f"{snap_calls[0]} snapshots taken")
    sup = {}
    for r in (rt, fin):
        for k, v in r.rec.counters_snapshot().items():
            if k.startswith(("supervisor_", "env_re", "chaos_")):
                sup[k] = sup.get(k, 0) + v
    if not (sup.get("supervisor_prefill_worker_restarts", 0)
            + sup.get("supervisor_env_worker_restarts", 0)) >= 1:
        raise AssertionError(f"phase 13 R: supervisor counters {sup}")
    acc = fin.row_accounting()
    if acc["completed"] != (acc["trained"] + acc["stale_dropped"]
                            + acc["discarded_tails"] + acc["failed"]
                            + acc["quarantine_dropped"] + acc["orphaned"]) \
            or acc["failed"] or acc["quarantine_dropped"]:
        raise AssertionError(f"phase 13 R: row accounting {acc}")
    commits = len(commit_times)
    forwards = {}
    decode_steps = 0
    for e in engines:
        decode_steps += e.stats.decode_steps
        for k, c in e.forward_counts.items():
            forwards[k] = forwards.get(k, 0) + c.n
    n_sgmv = 6 * cfg.num_layers * sum(forwards.values())
    want = {"gqa_decode": 0, "paged_gqa_decode": cfg.num_layers * decode_steps,
            "sgmv": n_sgmv, "sgmv_cuda": n_sgmv, "token_logprob_fwd": commits,
            "token_logprob_bwd": commits}
    got = {k: launches[k] for k in want}
    if len(engines) != 2 or forwards["decode"] != decode_steps or got != want:
        raise AssertionError(f"phase 13 R: {len(engines)} engines, forwards "
                             f"{forwards}, {decode_steps} decode steps; launches "
                             f"{got}, want {want}")
    pure = [(a, b) for a, b, d, f, _ in steps if d == 1 and f == 0]
    in_save = [1e3 * (b - a) for a, b in pure
               if any(a < s1 and s0 < b for s0, s1, _ in saves)]
    out_save = [1e3 * (b - a) for a, b in pure
                if not any(a < s1 and s0 < b for s0, s1, _ in saves)]
    save_s = [s1 - s0 for s0, s1, _ in saves]
    # the rollout thread between two engine steps (feeding, completions:
    # manager calls, which wait while a save holds the manager lock)
    gaps = [(p[1], q[0]) for p, q in zip(steps, steps[1:]) if p[4] == q[4]]
    gap_in = [1e3 * (b - a) for a, b in gaps
              if any(a < s1 and s0 < b for s0, s1, _ in saves)]
    gap_out = [1e3 * (b - a) for a, b in gaps
               if not any(a < s1 and s0 < b for s0, s1, _ in saves)]
    stall = [max([min(b, s1) - max(a, s0) for a, b in gaps
                  if a < s1 and s0 < b], default=0.0) for s0, s1, _ in saves]
    rec = dict(config=dict(P13_RUNS["T"], chaos=P13_CHAOS, checkpoint_every=1,
                           checkpoint_keep_last=P13_KEEP,
                           fail_after_commits=P13_FAIL_AFTER),
               wall_to_last_commit_s=wall, commits=commits, restarts=restarts,
               adopted=Path(fresh[0][1]).name, adopted_versions=fresh[0][2],
               chaos=chaos, snapshots_taken=snap_calls[0], fault_counters=sup,
               rows=acc, decode_steps=decode_steps, forwards=forwards,
               saves=len(saves), snapshot_bytes=[b for _, _, b in saves],
               save_s_median=_median(save_s), save_s_max=max(save_s),
               lock_hold_s_median=_median(holds), lock_hold_s_max=max(holds),
               decode_step_ms_median_in_save=_median(in_save),
               decode_step_ms_median_outside_save=_median(out_save),
               decode_steps_in_save=len(in_save),
               decode_steps_outside_save=len(out_save),
               decode_step_ms_p90=_pct(in_save + out_save, 0.9),
               rollout_gap_ms_median_in_save=_median(gap_in),
               rollout_gap_ms_max_in_save=max(gap_in, default=float("nan")),
               rollout_gap_ms_median_outside_save=_median(gap_out),
               rollout_gap_ms_max_outside_save=max(gap_out, default=float("nan")),
               rollout_stall_s_per_save=stall,
               launches=launches, card=card)
    log(f"[13 recovery R] {commits} commits over 2 incarnations (crash after "
        f"{P13_FAIL_AFTER}, adopted {rec['adopted']} {fresh[0][2]}), every tenant "
        f"at v{RT_SPEC['target_steps']}, restarts {restarts}; last commit at "
        f"{wall:.2f} s; chaos {chaos} ({snap_calls[0]} host snapshots taken); "
        f"fault counters {sup}; rows {acc}; {len(saves)} saves of "
        f"{_median([b for _, _, b in saves]) / 1e6:.1f} MB, "
        f"{rec['save_s_median']:.3f} s median ({rec['save_s_max']:.3f} max), "
        f"manager lock held {rec['lock_hold_s_median']:.3f} s median "
        f"({rec['lock_hold_s_max']:.3f} max); decode "
        f"{rec['decode_step_ms_median_in_save']:.2f} ms/step in {len(in_save)} "
        f"steps inside saves, {rec['decode_step_ms_median_outside_save']:.2f} in "
        f"{len(out_save)} outside; the rollout thread between steps "
        f"{rec['rollout_gap_ms_median_in_save']:.2f} ms median "
        f"({rec['rollout_gap_ms_max_in_save']:.1f} max) inside saves, "
        f"{rec['rollout_gap_ms_median_outside_save']:.2f} "
        f"({rec['rollout_gap_ms_max_outside_save']:.1f} max) outside, its longest "
        f"wait a save {_median(stall):.3f} s median ({max(stall):.3f} max); "
        f"launches {got} on {card}")
    return rec


def fault_phase(torch, cfg, params, counters, card, d_rec, device="cuda"):
    """Phase 13: run T (run D traced) and run R (chaos, snapshots, a crash
    and run_with_recovery), each beside phase 10's run D of this call."""
    import tempfile
    t_rec = runtime_phase(torch, cfg, params, counters, card, "T", device)
    with tempfile.TemporaryDirectory() as d:
        r_rec = recovery_run(torch, cfg, params, counters, card, d, device)
    cost = t_rec["decode_step_ms_median"] / d_rec["decode_step_ms_median"] - 1
    log(f"[13 T vs D] decode ms/step median {t_rec['decode_step_ms_median']:.2f} vs "
        f"{d_rec['decode_step_ms_median']:.2f} ({100 * cost:+.1f}%), p90 "
        f"{t_rec['decode_step_ms_p90']:.2f} vs {d_rec['decode_step_ms_p90']:.2f}; "
        f"last commit {t_rec['wall_to_last_commit_s']:.2f} s vs "
        f"{d_rec['wall_to_last_commit_s']:.2f} s; R's last commit "
        f"{r_rec['wall_to_last_commit_s']:.2f} s on {card}")
    return dict(T=t_rec, R=r_rec, D=dict(
        decode_step_ms_median=d_rec["decode_step_ms_median"],
        decode_step_ms_p90=d_rec["decode_step_ms_p90"],
        wall_to_last_commit_s=d_rec["wall_to_last_commit_s"]),
        tracing_cost_decode_median=cost)


# ---------------------------------------------------------------------------
# phase 14: the moe, ssm and hybrid families at full width
# ---------------------------------------------------------------------------

P14_SGMV = ((P14_HYBRID, "ssm_in", 2048, 8384), (P14_HYBRID, "ssm_out", 4096, 2048),
            (P14_HYBRID, "shared mlp_in", 2048, 16384),
            (P14_HYBRID, "shared mlp_out", 8192, 2048),
            (P14_SSM, "ssm_in", 1536, 6448), (P14_SSM, "ssm_out", 3072, 1536),
            (P14_MOE, "shared-expert mlp_in", 2048, 5632),
            (P14_MOE, "shared-expert mlp_out", 2816, 2048))
P14_VOCAB = ((P14_HYBRID, 2048, 32000, "tied"), (P14_SSM, 1536, 50280, "tied"),
             (P14_MOE, 2048, 102400, "untied"))
P14_DECODE = ((P14_MOE, 16, 128), (P14_HYBRID, 32, 64))   # (arch, H = KVH, hd)


def check_family_decode(torch, gqa, paged, ref, g, shapes=P14_DECODE,
                        kernels=("gqa_decode", "paged_gqa_decode"), tag="14"):
    """Both decode kernels (or those of `kernels`) at phase 14's rep-1
    shapes (deepseek-moe's MHA, 16 heads of 128, and zamba2's shared block,
    32 heads of 64; `shapes` replaces them): B=16, a 512-token cache
    (contiguous; paged in 16-token pages handed out in a random order), pos
    1 to 512, bf16 and fp32. Each against its plain version, two calls with
    the same bits, one CUDA launch a call; the bf16 cases timed (kernel,
    plain, library, eager call, bound)."""
    B, S, page = 16, 512, 16
    out = {k: [] for k in kernels}
    for arch, H, hd in shapes:
        for dt, tol in ((torch.bfloat16, 3e-2), (torch.float32, 2e-5)):
            dname = str(dt).split(".")[1]
            timed = dt == torch.bfloat16
            q, pos, tbl = _paged_case(torch, g, B, H, H, hd, page, S // page,
                                      B * S // page, 1, S, dt)
            elt = q.element_size()
            n_copy = copies_for(2 * B * S * H * hd * elt) if timed else 1
            caches = [(torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt),
                       torch.randn(B, S, H, hd, generator=g, device="cuda").to(dt))
                      for _ in range(n_copy)]
            pools = [(torch.cat([k.reshape(-1, page, H, hd),
                                 torch.zeros(1, page, H, hd, device="cuda", dtype=dt)]),
                      torch.cat([v.reshape(-1, page, H, hd),
                                 torch.zeros(1, page, H, hd, device="cuda", dtype=dt)]))
                     for k, v in caches]
            keys = int(pos.long().sum())
            pages_read = int(((pos.long() + page - 1) // page).sum())
            idx = torch.arange(S, device="cuda")
            mask = (idx[None, :] < pos.long()[:, None])[:, None, None, :]
            for kname, mod in (("gqa_decode", gqa), ("paged_gqa_decode", paged)):
                if kname not in kernels:
                    continue
                if kname == "gqa_decode":
                    sets = [(q, k, v, pos) for k, v in caches]
                    kern, plain = gqa.gqa_decode, ref.gqa_decode_ref

                    def lib(q, k, v, p):
                        return torch.nn.functional.scaled_dot_product_attention(
                            q[:, :, None, :], k.transpose(1, 2), v.transpose(1, 2),
                            attn_mask=mask)
                    nbytes = 2 * q.numel() * elt + 2 * keys * H * hd * elt + 4 * B
                    plan = gqa.decode_plan(B, H, S, 1, H=H, hd=hd)
                else:
                    sets = [(q, k, v, tbl, pos) for k, v in pools]
                    kern, plain = paged.paged_gqa_decode, ref.paged_gqa_decode_ref

                    def lib(q, k, v, t, p):
                        ti = t.long()
                        kc = k[ti].reshape(B, S, H, hd)
                        vc = v[ti].reshape(B, S, H, hd)
                        return torch.nn.functional.scaled_dot_product_attention(
                            q[:, :, None, :], kc.transpose(1, 2), vc.transpose(1, 2),
                            attn_mask=mask)
                    nbytes = (2 * q.numel() * elt + 2 * keys * H * hd * elt
                              + 4 * pages_read + 4 * B)
                    plan = gqa.decode_plan(B, H, S, page, H=H, hd=hd)
                got, n_cuda, same = decode_call(mod, kern, *sets[0])
                want = plain(*sets[0])
                torch.cuda.synchronize()
                err = (got.float() - want.float()).abs()
                if not bool((err <= tol + tol * want.float().abs()).all()) or not same \
                        or n_cuda != 1:
                    raise AssertionError(f"phase {tag} {kname} {arch} {dname}: max err "
                                         f"{err.max().item():.3e} (tol {tol}), same "
                                         f"bits {same}, CUDA launches {n_cuda}")
                rec = dict(arch=arch, B=B, S=S, H=H, KVH=H, hd=hd, rep=1,
                           page=page if mod is paged else 1, dtype=dname, main=False,
                           max_abs_err=float(err.max()), tol=tol,
                           cuda_launches_per_call=n_cuda, plan=plan_record(plan))
                line = (f"  {kname} {arch} H=KVH={H} hd={hd} {dname}: err "
                        f"{rec['max_abs_err']:.2e} (tol {tol}), same bits, {n_cuda} "
                        f"CUDA launch; plan {rec['plan']}")
                if timed:
                    rec.update(ms=device_ms(kern, sets), plain_ms=device_ms(plain, sets, 10),
                               library_ms=device_ms(lib, sets, 10),
                               call_ms=bench_ms(kern, sets))
                    decode_rates(rec, nbytes, 4 * keys * H * hd, dname)
                    line += (f"; kernel {rec['ms']:.4f} ms plain {rec['plain_ms']:.4f} "
                             f"library {rec['library_ms']:.4f} bound "
                             f"{rec['bound_ms']:.4f} ms ({rec['bound_by']}); "
                             f"{rec['gb_s']:.0f} GB/s = {rec['bound_share']:.2f} of "
                             f"the bound; eager call {rec['call_ms']:.4f} ms")
                out[kname].append(rec)
                log(line)
    return out


def family_model(torch, M, arch):
    """(cfg, params, adapters) of `arch` at its full published size in bf16:
    random weights from seed 0 drawn on the card one layer at a time, and
    TENANTS adapters with b ~ N(0, B_SCALE^2) in every subtree."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import make_adapters
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    adapters = make_adapters(cfg, TENANTS, seed=0, device="cuda", b_scale=B_SCALE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in M.tree_leaves(params))
    log(f"[14 {arch}] {cfg.family}: {cfg.num_layers} layers, d={cfg.d_model}, "
        f"V={cfg.vocab_size}: {n / 1e9:.3f} B parameters "
        f"({sum(t.nbytes for t in M.tree_leaves(params)) / 1e9:.2f} GB bf16) drawn in "
        f"{time.monotonic() - t0:.1f} s; sgmv {sgmv_per_forward(cfg)} launches a "
        f"forward, decode attention {attn_per_step(cfg)} a decode step")
    return cfg, params, adapters


def family_serve(torch, cfg, params, adapters, counters, card, tag):
    """Phase 4's served round on `cfg`: RolloutEngine.generate (dense cache)
    for TENANTS x PER_TENANT gsm8k requests of MAX_NEW tokens; gqa_decode
    attn_per_step launches a decode step, sgmv sgmv_per_forward a forward
    (the prefill and every decode step), its CUDA launches equal to its
    calls. Returns the record and the results."""
    import numpy as np
    from repro_torch.launch.serve import make_requests
    from repro_torch.rollout.engine import RolloutEngine
    reqs = make_requests(TENANTS, PER_TENANT, max_new_tokens=MAX_NEW, seed=0)
    RolloutEngine(cfg, params, max_len=MAX_LEN, seed=1, device="cuda").generate(
        make_requests(TENANTS, 1, max_new_tokens=2, seed=1), adapters)
    engine = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    count_all(counters, reset=True)
    results, stats = engine.generate(reqs, adapters)
    launches = count_all(counters)
    steps = stats.decode_steps
    n_sgmv = sgmv_per_forward(cfg) * (steps + 1)
    want = {"gqa_decode": attn_per_step(cfg) * steps, "paged_gqa_decode": 0,
            "sgmv": n_sgmv, "sgmv_cuda": n_sgmv}
    got = {k: launches[k] for k in want}
    if got != want:
        raise AssertionError(f"phase {tag} serve: launches {got}, want {want}")
    for r in results:
        gen = r["tokens"][r["prompt_len"]:]
        if not (1 <= len(gen) <= MAX_NEW and all(0 <= t < cfg.vocab_size for t in gen)
                and all(np.isfinite(lp) and lp <= 0 for lp in r["gen_logprobs"])):
            raise AssertionError(f"phase {tag} serve: a bad row")
    decode_tokens = stats.tokens_generated - len(reqs)
    rec = dict(requests=len(reqs), decode_steps=steps, decode_s=stats.decode_seconds,
               decode_ms_per_step=1e3 * stats.decode_seconds / steps,
               decode_tokens_per_s=decode_tokens / stats.decode_seconds,
               prefill_s=stats.prefill_seconds, wall_s=stats.wall_seconds,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, card=card)
    log(f"[{tag} serve] {cfg.name}: {len(reqs)} requests, {steps} decode steps, "
        f"{rec['decode_ms_per_step']:.2f} ms/step ({rec['decode_tokens_per_s']:.1f} "
        f"tok/s), prefill {stats.prefill_seconds:.3f} s, wall {stats.wall_seconds:.2f} s, "
        f"peak {rec['peak_mem_gib']:.2f} GiB; launches {got} on {card}")
    return rec, [(r, q.adapter_index) for r, q in zip(results, reqs)]


def first_layers(M, cfg, params, adapters, depth):
    """(cfg, params, adapters) of the model's first `depth` layers: views of
    the stacked layer leaves, the adapters' too."""
    import dataclasses
    cfg = dataclasses.replace(cfg, num_layers=depth)
    params = dict(params, layers=M.tree_map(lambda t: t[:depth], params["layers"]))
    adapters = [{k: M.tree_map(lambda t: t[:depth], v) for k, v in a.items()}
                for a in adapters]
    return cfg, params, adapters


def family_tf_check(torch, M, cfg, params, adapters, rows, tag, depth=None,
                    enc=None):
    """Teacher-forced fp32 logprobs of TF_ROWS served rows through
    forward_seq on the card (the sgmv kernel, sgmv_per_forward launches)
    against the CPU (plain versions), within TF_TOL; with `depth`, the
    model's first `depth` layers (their adapters too) on the same tokens;
    encdec's rows with their frame embeddings (`enc`, a row each)."""
    from repro_torch.kernels import sgmv
    idx = list(range(0, len(rows), max(1, len(rows) // TF_ROWS)))[:TF_ROWS]
    rows = [rows[i] for i in idx]
    if enc is not None:
        enc = enc[idx]
    if depth is not None:
        cfg, params, adapters = first_layers(M, cfg, params, adapters, depth)
    n0 = sgmv.CUDA_LAUNCHES.n
    on_card = teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, "cuda",
                                      enc)
    launched = sgmv.CUDA_LAUNCHES.n - n0
    if launched != sgmv_per_forward(cfg):
        raise AssertionError(f"phase {tag} check: {launched} sgmv launches, want "
                             f"{sgmv_per_forward(cfg)}")
    gc.collect()
    torch.cuda.empty_cache()
    on_cpu = teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, "cpu",
                                     enc)
    err = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    rec = dict(rows=len(rows), tokens=sum(len(a) for a in on_card),
               layers=cfg.num_layers, max_abs_diff=err, tol=TF_TOL)
    if depth is None:
        served = [torch.tensor(r["gen_logprobs"], dtype=torch.float64) for r, _ in rows]
        rec["served_bf16_vs_fp32"] = max(float((a - s).abs().max())
                                         for a, s in zip(on_card, served))
    log(f"[{tag} check] {cfg.name}{'' if depth is None else f' (first {depth} layers)'}: "
        f"teacher-forced fp32 logprobs of {len(rows)} rows ({rec['tokens']} tokens), "
        f"card (kernels) vs CPU (plain): max abs diff {err:.3e} (tol {TF_TOL})"
        + (f"; served bf16 vs fp32 {rec['served_bf16_vs_fp32']:.3e}"
           if "served_bf16_vs_fp32" in rec else ""))
    if not err <= TF_TOL:
        raise AssertionError(f"phase {tag}: fp32 card vs CPU logprobs differ by {err}")
    return rec


def family_train(torch, cfg, params, counters, card, tag):
    """One GRPO LoRA step (phase 6's settings: token_logprob 2 forward and
    1 backward launches) at full size."""
    train, _, _, _ = train_phase(torch, cfg, params, counters, card, iters=1, tag=tag)
    la = train["launches"]
    if (la["token_logprob_fwd"], la["token_logprob_bwd"]) != (2, 1) \
            or la["gqa_decode"] % max(1, attn_per_step(cfg)) \
            or (attn_per_step(cfg) == 0 and la["gqa_decode"]) or not la["sgmv"]:
        raise AssertionError(f"phase {tag} train: launches {la}")
    return train


def family_phase(torch, M, counters, card, gqa, paged, sgmv, tlp, ref, g, R_main):
    """Phase 14: the kernels at the families' shapes, then (a) zamba2-1.2b
    through the runtime at run D's settings, (b) mamba2-780m at phase 8's
    settings and one GRPO step, (c) deepseek-moe-16b's served round, phase
    8's run and one GRPO step; each with an fp32 card-vs-CPU check."""
    from repro_torch.models import moe
    t_all = time.monotonic()
    log("[14 kernels] each kernel at the families' shapes against its plain version")
    kern = check_family_decode(torch, gqa, paged, ref, g)
    kern["sgmv"] = check_sgmv(torch, sgmv, ref, g, 0, specs=[
        (16, 4, d, dout, torch.bfloat16, f"{arch} {name}")
        for arch, name, d, dout in P14_SGMV])
    kern["token_logprob_fwd"], kern["token_logprob_bwd"] = check_token_logprob(
        torch, tlp, ref, g, R_main, cases=[
            (R_main, d, V, torch.bfloat16, 0.0, layout, True)
            for _, d, V, layout in P14_VOCAB])
    out = {"kernels_s": time.monotonic() - t_all}

    t0 = time.monotonic()
    cfg, params, adapters = family_model(torch, M, P14_HYBRID)
    run = runtime_phase(torch, cfg, params, counters, card, "Z")
    serve_a, rows = family_serve(torch, cfg, params, adapters, counters, card, "14a")
    out["a"] = dict(arch=cfg.name, runtime=run, serve=serve_a,
                    check=family_tf_check(torch, M, cfg, params, adapters, rows, "14a"),
                    wall_s=time.monotonic() - t0)
    del cfg, params, adapters, rows

    t0 = time.monotonic()
    cfg, params, adapters = family_model(torch, M, P14_SSM)
    cont, comps = continuous_phase(torch, cfg, params, adapters, counters, card,
                                   tag="14b")
    if cont["launches"]["paged_gqa_decode"] or cont["launches"]["gqa_decode"]:
        raise AssertionError(f"phase 14b: decode attention launched {cont['launches']}")
    train = family_train(torch, cfg, params, counters, card, "14b")
    rows = [(dict(tokens=c.tokens, prompt_len=c.prompt_len,
                  gen_logprobs=c.gen_logprobs), int(c.task_id.split("-")[1]))
            for c in sorted(comps, key=lambda c: c.submit_index)]
    out["b"] = dict(arch=cfg.name, continuous=cont, train=train,
                    check=family_tf_check(torch, M, cfg, params, adapters, rows, "14b"),
                    wall_s=time.monotonic() - t0)
    del cfg, params, adapters, rows, comps

    t0 = time.monotonic()
    cfg, params, adapters = family_model(torch, M, P14_MOE)
    dropped = {}
    moe.DROPS.reset(True)
    serve, rows = family_serve(torch, cfg, params, adapters, counters, card, "14c")
    dropped["serve"] = moe.DROPS.total()
    moe.DROPS.reset(True)
    cont, comps = continuous_phase(torch, cfg, params, adapters, counters, card,
                                   tag="14c")
    dropped["continuous"] = moe.DROPS.total()
    # the same schedule on a second engine: equal streams, logprob bits and
    # drops (frozen and empty lanes take no expert capacity, so the scratch
    # page they read cannot move a live token's drop; ROADMAP §3)
    moe.DROPS.reset(True)
    _, comps2 = continuous_phase(torch, cfg, params, adapters, counters, card,
                                 tag="14c")
    again = moe.DROPS.total()

    def streams(cs_):
        return [(list(c.tokens), list(c.gen_logprobs))
                for c in sorted(cs_, key=lambda c: c.submit_index)]
    if streams(comps) != streams(comps2) or again != dropped["continuous"]:
        raise AssertionError(f"phase 14c: two engines differ (drops "
                             f"{dropped['continuous']}, {again})")
    log(f"[14c moe] a second engine: the same {len(comps2)} streams, logprob "
        f"bits and {again} drops")
    del comps, comps2
    moe.DROPS.reset(True)
    train = family_train(torch, cfg, params, counters, card, "14c")
    dropped["train"] = moe.DROPS.total()
    moe.DROPS.reset(False)
    peak = max(serve["peak_mem_gib"], cont["peak_mem_gib"],
               max(s["peak_mem_gib"] for s in train["steps"]))
    log(f"[14c moe] {cfg.name}: capacity_factor {cfg.moe.capacity_factor}, "
        f"assignments dropped at capacity {dropped}; peak memory {peak:.2f} GiB "
        f"on {card}")
    out["c"] = dict(arch=cfg.name, serve=serve, continuous=cont, train=train,
                    dropped_assignments=dropped, peak_mem_gib=peak,
                    check=family_tf_check(torch, M, cfg, params, adapters, rows,
                                          "14c", depth=P14_MOE_TF_LAYERS),
                    wall_s=time.monotonic() - t0)
    del cfg, params, adapters, rows
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t_all
    launches = {k: 0 for k in counters}
    for part in (run, serve_a, out["b"]["continuous"], out["b"]["train"], serve,
                 out["c"]["continuous"], out["c"]["train"]):
        for k in counters:
            launches[k] += part["launches"][k]
    out["launches"] = launches
    log(f"[14 families] wall {out['wall_s']:.1f} s (kernels {out['kernels_s']:.1f} s, "
        f"(a) {out['a']['wall_s']:.1f} s, (b) {out['b']['wall_s']:.1f} s, (c) "
        f"{out['c']['wall_s']:.1f} s); launches {launches}")
    return out, kern


# ---------------------------------------------------------------------------
# phase 15: the encdec family (seamless-m4t-large-v2) through launch.specs
# ---------------------------------------------------------------------------

P15_ARCH = "seamless-m4t-large-v2"
P15_CACHE, P15_ENC_LEN, P15_STEPS = 512, 128, 32   # (b): dense cache, frames, steps
P15_TRAIN_ROWS, P15_TRAIN_SEQ = 32, 512            # (d): the step's ShapeConfig
P15_REMAT_BLOCK = 4                                # (e): 24 layers in 6 blocks
P15_SGMV = (("q/k/v/o", 1024, 1024), ("mlp_in", 1024, 8192),
            ("mlp_out", 8192, 1024))
P15_D, P15_V = 1024, 256206                        # the untied head [d, V]


def encdec_kernels(torch, gqa, paged, sgmv, tlp, ref, g, R_main, S_p):
    """Phase 15 (a): the three kernels of seamless's path at its shapes
    against their plain versions, timed beside one library call and the
    bound: gqa_decode (B=16, 16/16 heads of 64, a 512-token cache; bf16 and
    fp32), sgmv at the decoder's three projection shapes in decode (R=16)
    and the served prefill (R=16 x the prompt bucket), token_logprob forward
    and backward at V=256206 on the untied head and on a [:, :V] view of a
    head whose rows are padded to 256208 (R_main and PROD_ROWS rows), each
    with the route its W took, as w_feed picks it and the launchers
    report it."""
    bf16 = torch.bfloat16
    kern = check_family_decode(torch, gqa, paged, ref, g, shapes=((P15_ARCH, 16, 64),),
                               kernels=("gqa_decode",), tag="15")
    kern["sgmv"] = check_sgmv(torch, sgmv, ref, g, 0, specs=[
        (R, 4, d, dout, bf16, f"{P15_ARCH} {name} {label}")
        for label, R in (("decode", 16), ("prefill", 16 * S_p))
        for name, d, dout in P15_SGMV])
    kern["token_logprob_fwd"], kern["token_logprob_bwd"] = check_token_logprob(
        torch, tlp, ref, g, R_main, cases=[
            (R, P15_D, P15_V, bf16, 0.0, layout, True)
            for layout in ("untied", "padded") for R in (R_main, PROD_ROWS)])
    return kern


def encdec_round_flops(cfg, B, S_p, lens, steps):
    """launch.analytic's FLOPs of phase 15's served round: the prefill of B
    rows of S_p tokens, and each decode step at the rows' mean context. (The
    analytic model amortises an encoder of S/4 frames over the decoder's
    tokens; the round's 128 frames are counted separately, in
    encoder_flops.)"""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import analytic
    pre = analytic.analytic_terms(cfg, ShapeConfig("p15 prefill", S_p, B, "prefill"),
                                  1, 1, 1).flops
    mean0 = sum(lens) / len(lens)
    dec = sum(analytic.analytic_terms(
        cfg, ShapeConfig("p15 decode", int(round(mean0 + t + 1)), B, "decode"),
        1, 1, 1).flops for t in range(steps))
    return pre, dec


def encoder_flops(cfg, B, frames):
    """FLOPs of the encoder over B rows of `frames` frames: its matmuls and
    its bidirectional attention (launch.analytic's per-token terms)."""
    from repro_torch.launch import analytic
    per = (2.0 * analytic._layer_matmul_params(cfg, "dense")
           + 4.0 * frames * cfg.num_heads * cfg.head_dim)
    return B * frames * cfg.encoder_layers * per


def encdec_serve(torch, M, cfg, params, adapters, counters, card, peaks):
    """Phase 15 (b): a served round through launch.specs' step builders:
    TENANTS x PER_TENANT gsm8k prompts, each on its tenant's adapter of
    NUM_TENANTS stacked, with N(0, 1) frame embeddings (P15_ENC_LEN frames,
    seeded, in bf16) for the stub frontend; build_prefill_step fills the
    dense cache (P15_CACHE tokens) and the cross-attention memory, then
    P15_STEPS build_decode_step steps, each sampled by the port's per-row
    sampler (temperature 0.8). gqa_decode attn_per_step launches a decode
    step (the cross-attention is plain), sgmv sgmv_per_forward a forward
    (the decoder's six projections; the encoder has no adapters).
    Returns the record, the rows and their frame embeddings."""
    import numpy as np
    from repro_torch.launch import specs
    from repro_torch.launch.roofline import share_of_peak
    from repro_torch.launch.serve import make_requests
    from repro_torch.lora.adapters import stack_adapters
    from repro_torch.models.common import dtype_of
    from repro_torch.rollout import prng
    from repro_torch.rollout.prefill import _bucket_len, _log_softmax_at, _sample_rows
    reqs = make_requests(TENANTS, PER_TENANT, max_new_tokens=P15_STEPS, seed=0)
    B = len(reqs)
    S_p = _bucket_len(max(len(r.prompt) for r in reqs))
    tokens = torch.zeros((B, S_p), dtype=torch.int32)
    for i, r in enumerate(reqs):
        tokens[i, :len(r.prompt)] = torch.tensor(r.prompt)
    tokens = tokens.cuda()
    lens_l = [len(r.prompt) for r in reqs]
    lens = torch.tensor(lens_l, dtype=torch.int32, device="cuda")
    ids = torch.tensor([r.adapter_index for r in reqs], dtype=torch.int32,
                       device="cuda")
    enc = torch.randn(B, P15_ENC_LEN, cfg.d_model, device="cuda",
                      generator=torch.Generator(device="cuda").manual_seed(0)
                      ).to(dtype_of(cfg.dtype))
    stacked = stack_adapters(adapters)
    keys = torch.as_tensor(np.stack([prng.fold_in_host(prng.prng_key(0), i)
                                     for i in range(B)]), dtype=torch.int64,
                           device="cuda")
    temps = torch.full((B,), 0.8, device="cuda")
    prefill, decode = specs.build_prefill_step(cfg), specs.build_decode_step(cfg)

    def served(steps):
        cache = M.init_cache(cfg, B, P15_CACHE, enc_len=P15_ENC_LEN, device="cuda")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        logits, cache = prefill(params, stacked, ids, tokens, lens, cache, enc)
        cur = _sample_rows(logits, keys, torch.zeros_like(lens), temps).to(torch.int32)
        lps = [_log_softmax_at(logits, cur)]
        outs = [cur]
        torch.cuda.synchronize()
        t1 = time.monotonic()
        for t in range(steps):
            logits, cache = decode(params, stacked, ids, cur, cache)
            cur = _sample_rows(logits, keys, torch.full_like(lens, t + 1),
                               temps).to(torch.int32)
            lps.append(_log_softmax_at(logits, cur))
            outs.append(cur)
        torch.cuda.synchronize()
        return (t1 - t0, time.monotonic() - t1, torch.stack(outs, 1).cpu(),
                torch.stack(lps, 1).cpu(), cache, logits)

    served(2)                                      # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    count_all(counters, reset=True)
    prefill_s, decode_s, gen, lps, cache, logits = served(P15_STEPS)
    launches = count_all(counters)
    n_fwd = P15_STEPS + 1
    want = {"gqa_decode": attn_per_step(cfg) * P15_STEPS, "paged_gqa_decode": 0,
            "sgmv": sgmv_per_forward(cfg) * n_fwd,
            "sgmv_cuda": sgmv_per_forward(cfg) * n_fwd,
            "token_logprob_fwd": 0, "token_logprob_bwd": 0}
    if launches != want:
        raise AssertionError(f"phase 15b: launches {launches}, want {want}")
    if not (bool(((gen >= 0) & (gen < cfg.vocab_size)).all())
            and bool(torch.isfinite(lps).all()) and bool((lps <= 0).all())
            and bool(torch.isfinite(logits).all())):
        raise AssertionError("phase 15b: a token outside the vocabulary or a bad logprob")
    for k in ("xk", "xv", "k", "v"):
        if not (bool(torch.isfinite(cache[k]).all()) and bool(cache[k].abs().amax() > 0)):
            raise AssertionError(f"phase 15b: cache {k} empty or non-finite")
    if not torch.equal(cache["pos"].cpu(), torch.tensor(lens_l, dtype=torch.int32)
                       + P15_STEPS):
        raise AssertionError(f"phase 15b: cache pos {cache['pos'].tolist()}")
    pre_f, dec_f = encdec_round_flops(cfg, B, S_p, lens_l, P15_STEPS)
    enc_f = encoder_flops(cfg, B, P15_ENC_LEN)
    wall = prefill_s + decode_s
    rec = dict(arch=cfg.name, rows=B, prompt_bucket=S_p, enc_len=P15_ENC_LEN,
               cache=P15_CACHE, decode_steps=P15_STEPS, prefill_ms=1e3 * prefill_s,
               decode_ms_per_step=1e3 * decode_s / P15_STEPS,
               decode_tokens_per_s=B * P15_STEPS / decode_s, wall_s=wall,
               analytic_flops=pre_f + dec_f, encoder_flops_at_frames=enc_f,
               analytic_share_of_peak=share_of_peak(pre_f + dec_f, wall, peaks),
               prefill_share_with_encoder=share_of_peak(enc_f + pre_f, prefill_s, peaks),
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
               launches=launches, card=card)
    log(f"[15b serve] {cfg.name} through launch.specs: {B} rows on {TENANTS} of "
        f"{len(adapters)} stacked adapters, prompt bucket {S_p}, {P15_ENC_LEN} frames, "
        f"cache {P15_CACHE}: prefill {rec['prefill_ms']:.2f} ms, decode "
        f"{rec['decode_ms_per_step']:.2f} ms/step ({rec['decode_tokens_per_s']:.1f} "
        f"tok/s, the sampler included), {P15_STEPS} steps; analytic FLOPs "
        f"{rec['analytic_flops'] / 1e12:.4f} T over {wall:.4f} s = "
        f"{rec['analytic_share_of_peak']:.5f} of {peaks.flops['bfloat16'] / 1e12:.0f} "
        f"TFLOP/s; the prefill with its encoder at {P15_ENC_LEN} frames "
        f"{rec['prefill_share_with_encoder']:.5f}; peak {rec['peak_mem_gib']:.2f} GiB; "
        f"launches {launches} on {card}")
    rows = [(dict(tokens=list(r.prompt) + gen[i].tolist(), prompt_len=len(r.prompt),
                  gen_logprobs=lps[i].tolist()), r.adapter_index)
            for i, r in enumerate(reqs)]
    return rec, rows, enc


def encdec_train_batch(torch, cfg, rows, seq):
    """A GRPO batch of `rows` rows of `seq` tokens (seeded random ids,
    prompts of 16-128 tokens, completions to the half or more of seq,
    uniform rewards) with N(0, 1) frame embeddings of seq // 4 frames."""
    from repro_torch.models.common import dtype_of
    g = torch.Generator(device="cuda").manual_seed(5)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    return {"tokens": ints(1, cfg.vocab_size, (rows, seq)),
            "prompt_lens": ints(16, 129, (rows,)),
            "total_lens": ints(seq // 2, seq + 1, (rows,)),
            "rewards": torch.rand(rows, generator=g, device="cuda"),
            "enc_embeds": torch.randn(rows, seq // 4, cfg.d_model, generator=g,
                                      device="cuda").to(dtype_of(cfg.dtype))}


def encdec_train(torch, cfg, params, counters, card, peaks):
    """Phase 15 (d) and (e): one LoRA GRPO step through
    launch.specs.build_train_step at ShapeConfig(P15_TRAIN_SEQ,
    P15_TRAIN_ROWS, "train") (GROUP_SIZE groups, one micro-batch, the KL
    term off: token_logprob 1 forward and 1 backward launch, no other
    kernel: one task's adapters are plain products), from the same
    adapter and fresh AdamW state at REPRO_REMAT_BLOCK unset (remat_block 0)
    and at P15_REMAT_BLOCK, after one untimed step. Each: every adapter leaf
    moves, grad_norm > 0, the wall time, analytic.py's train FLOPs over it
    as a share of peak, the peak memory. The two agree in loss and metrics
    within BF16_METRIC_TOL and in the adapter gradient (AdamW's first moment
    after the step, 0.1 x the clipped gradient) within BF16_GRAD_TOL of its
    norm."""
    import math
    import os
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import analytic, specs
    from repro_torch.launch.roofline import share_of_peak
    from repro_torch.launch.serve import make_adapters
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import adamw_init, global_norm
    shape = ShapeConfig("p15_train", P15_TRAIN_SEQ, P15_TRAIN_ROWS, "train")
    batch = encdec_train_batch(torch, cfg, P15_TRAIN_ROWS, P15_TRAIN_SEQ)
    lora = make_adapters(cfg, 1, seed=3, device="cuda", b_scale=B_SCALE)[0]
    flops = analytic.analytic_terms(cfg, shape, 1, 1, 1,
                                    specs.accum_steps(cfg, shape)).flops
    want = dict({k: 0 for k in counters}, token_logprob_fwd=1, token_logprob_bwd=1)
    out = {}
    for blk in (None, 0, P15_REMAT_BLOCK):          # None: the untimed warm-up
        os.environ.pop("REPRO_REMAT_BLOCK", None)
        if blk:
            os.environ["REPRO_REMAT_BLOCK"] = str(blk)
        step = specs.build_train_step(cfg, shape)
        os.environ.pop("REPRO_REMAT_BLOCK", None)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        count_all(counters, reset=True)
        t0 = time.monotonic()
        new, opt, m = step(params, lora, adamw_init(lora), batch)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        launches = count_all(counters)
        if blk is None:
            continue
        m = {k: float(v) for k, v in m.items()}
        la = (launches["token_logprob_fwd"], launches["token_logprob_bwd"])
        moved = [not bool(torch.equal(a, b)) for a, b in zip(tree_leaves(lora),
                                                              tree_leaves(new))]
        # one task's adapters train as plain products (LoraCtx "single"), as
        # in the JAX package: no sgmv launch, no decode attention
        if launches != want or not all(math.isfinite(v) for v in m.values()) \
                or not m["grad_norm"] > 0 or not all(moved):
            raise AssertionError(f"phase 15 train (remat_block {blk}): launches "
                                 f"{launches}, metrics {m}, {sum(moved)} of "
                                 f"{len(moved)} adapter leaves moved")
        rec = dict(remat_block=blk, rows=P15_TRAIN_ROWS, seq=P15_TRAIN_SEQ,
                   enc_len=P15_TRAIN_SEQ // 4, train_ms=1e3 * secs,
                   analytic_flops=flops,
                   analytic_share_of_peak=share_of_peak(flops, secs, peaks),
                   peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                   peak_above_resident_gib=(torch.cuda.max_memory_allocated() - base)
                   / 2 ** 30, launches=launches, card=card,
                   **{k: m[k] for k in ("loss", "pg_loss", "entropy", "ratio_mean",
                                        "clip_frac", "grad_norm")})
        out[blk] = (rec, opt["m"])
        log(f"[15{'d' if blk == 0 else 'e'} train] {cfg.name} LoRA GRPO step through "
            f"launch.specs.build_train_step, remat_block {blk}: {P15_TRAIN_ROWS} rows x "
            f"{P15_TRAIN_SEQ} tokens, {P15_TRAIN_SEQ // 4} frames: {rec['train_ms']:.1f} "
            f"ms, analytic {flops / 1e12:.2f} TFLOP = {rec['analytic_share_of_peak']:.4f} "
            f"of peak; peak memory {rec['peak_mem_gib']:.2f} GiB "
            f"({rec['peak_above_resident_gib']:.2f} above the resident "
            f"{base / 2 ** 30:.2f}); loss {m['loss']:.6f} grad_norm {m['grad_norm']:.6f}; "
            f"token_logprob {la[0]} fwd + {la[1]} bwd on {card}")
    (r0, m0), (r4, m4) = out[0], out[P15_REMAT_BLOCK]
    m_err = max(abs(r0[k] - r4[k]) for k in ("loss", "pg_loss", "entropy",
                                             "ratio_mean", "clip_frac", "grad_norm"))
    g_norm = float(global_norm(m0))
    g_err = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(m0),
                                                          tree_leaves(m4)))
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(m0), tree_leaves(m4)))
    cmp = dict(metric_max_abs_diff=m_err, metric_tol=BF16_METRIC_TOL,
               grad_max_abs_diff=g_err, grad_norm=g_norm,
               grad_tol=BF16_GRAD_TOL * g_norm, same_bits=same)
    log(f"[15e remat] remat_block {P15_REMAT_BLOCK} vs 0: metrics max abs diff "
        f"{m_err:.3e} (tol {BF16_METRIC_TOL}), gradient max abs diff {g_err:.3e} of "
        f"norm {g_norm:.4e} (tol {BF16_GRAD_TOL} x norm), same bits {same}; peak "
        f"memory {r4['peak_mem_gib']:.2f} vs {r0['peak_mem_gib']:.2f} GiB, step "
        f"{r4['train_ms']:.1f} vs {r0['train_ms']:.1f} ms on {card}")
    if m_err > BF16_METRIC_TOL or g_err > BF16_GRAD_TOL * g_norm:
        raise AssertionError(f"phase 15e: remat_block {P15_REMAT_BLOCK} and 0 differ: {cmp}")
    head = encdec_head_layouts(torch, cfg, params, counters, card, shape, batch, lora,
                               r0, m0)
    return dict(steps=[r0, r4], compare=cmp, head_layout=head)


def encdec_head_layouts(torch, cfg, params, counters, card, shape, batch, lora,
                        r_padded, m_padded):
    """Phase 15 (d), the head's layout: the remat_block 0 step again with
    a contiguous copy of the untied head ([d, V] with V = 256206 not a
    multiple of 8) in place of init_params' [:, :V] view of rows padded to
    a multiple of 8, then once more on the padded head, each timed alone.
    The values are equal, so loss, metrics and the first moment must keep
    their bits; token_logprob's backward must load W by TMA in every vocab
    chunk on the padded head, and in none on the contiguous one (its
    cp.async copies; tlp.BWD_W_VECTOR)."""
    from repro_torch.kernels import token_logprob as tlp
    from repro_torch.launch import specs
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    step = specs.build_train_step(cfg, shape)
    heads = {"contiguous": params["lm_head"].contiguous(), "padded": params["lm_head"]}
    out = {}
    for name, w in heads.items():
        gc.collect()
        torch.cuda.synchronize()
        count_all(counters, reset=True)
        n0, v0 = tlp.BWD_CUDA_LAUNCHES.n, tlp.BWD_W_VECTOR.n
        t0 = time.monotonic()
        _, opt, m = step(dict(params, lm_head=w), lora, adamw_init(lora), batch)
        torch.cuda.synchronize()
        secs = time.monotonic() - t0
        chunks = (tlp.BWD_CUDA_LAUNCHES.n - n0 - 1) // 2
        vec = tlp.BWD_W_VECTOR.n - v0
        same = float(m["loss"]) == r_padded["loss"] and all(
            torch.equal(a, b) for a, b in zip(tree_leaves(opt["m"]),
                                              tree_leaves(m_padded)))
        out[name] = dict(train_ms=1e3 * secs, lm_head_stride=list(w.stride()),
                         bwd_chunks=chunks, bwd_w_vector_chunks=vec,
                         same_bits_as_padded=same, launches=count_all(counters))
        if not same or vec != (chunks if name == "padded" else 0):
            raise AssertionError(f"phase 15d head layout {name}: {out[name]}")
    del heads
    c, p = out["contiguous"], out["padded"]
    log(f"[15d head] the same step on a contiguous head (stride {c['lm_head_stride']}, "
        f"token_logprob bwd W by TMA in {c['bwd_w_vector_chunks']} of "
        f"{c['bwd_chunks']} chunks): {c['train_ms']:.1f} ms; on the padded head "
        f"(stride {p['lm_head_stride']}, {p['bwd_w_vector_chunks']} of "
        f"{p['bwd_chunks']}): {p['train_ms']:.1f} ms, after "
        f"{r_padded['train_ms']:.1f}; loss and first moment bit-equal on {card}")
    out["card"] = card
    return out


def encdec_phase(torch, M, counters, card, peaks, gqa, paged, sgmv, tlp, ref, g,
                 R_main, S_p):
    """Phase 15: seamless-m4t-large-v2 at its full published size in bf16
    (random weights from seed 0, drawn on the card layer by layer; adapters
    with b ~ N(0, B_SCALE^2)): (a) the kernels at its shapes, (b) a served
    round through launch.specs, (c) 4 of its rows in fp32 on the card
    against the CPU, (d) one LoRA GRPO step, (e) the same at remat_block
    P15_REMAT_BLOCK."""
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.launch.serve import make_adapters
    t_all = time.monotonic()
    log("[15 kernels] each kernel of the encdec path at seamless's shapes")
    kern = encdec_kernels(torch, gqa, paged, sgmv, tlp, ref, g, R_main, S_p)
    out = {"kernels_s": time.monotonic() - t_all}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(P15_ARCH)
    t0 = time.monotonic()
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    adapters = make_adapters(cfg, specs.NUM_TENANTS, seed=0, device="cuda",
                             b_scale=B_SCALE)
    torch.cuda.synchronize()
    n = sum(t.numel() for t in M.tree_leaves(params))
    log(f"[15 {cfg.name}] encdec: {cfg.encoder_layers} encoder and {cfg.num_layers} "
        f"decoder layers, d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads "
        f"of {cfg.head_dim}, {cfg.mlp_act} MLP of {cfg.d_ff}, V={cfg.vocab_size} "
        f"untied: {n / 1e9:.3f} B parameters "
        f"({sum(t.nbytes for t in M.tree_leaves(params)) / 1e9:.2f} GB bf16) drawn in "
        f"{time.monotonic() - t0:.1f} s; sgmv {sgmv_per_forward(cfg)} launches a "
        f"forward, gqa_decode {attn_per_step(cfg)} a decode step")
    serve, rows, enc = encdec_serve(torch, M, cfg, params, adapters, counters, card,
                                    peaks)
    out["serve"] = serve
    out["check"] = family_tf_check(torch, M, cfg, params, adapters, rows, "15c",
                                   enc=enc)
    del rows, enc
    out["train"] = encdec_train(torch, cfg, params, counters, card, peaks)
    del params, adapters
    gc.collect()
    torch.cuda.empty_cache()
    out["wall_s"] = time.monotonic() - t_all
    runs = out["train"]["steps"] + [out["train"]["head_layout"][n]
                                    for n in ("contiguous", "padded")]
    out["launches"] = {k: serve["launches"][k] + sum(r["launches"][k] for r in runs)
                       for k in counters}
    log(f"[15 encdec] wall {out['wall_s']:.1f} s (kernels {out['kernels_s']:.1f} s); "
        f"launches {out['launches']}")
    return out, kern


# ---------------------------------------------------------------------------
# phase 16: the launch layer's sharding: the dry run on a fake process group
# and the GRPO and decode steps on the host mesh
# ---------------------------------------------------------------------------

# (a) the dry run's cells at published size, in two lanes of one host core
# each, each lane's cells one after another: (lane, arch, shape, mesh, the
# mesh's device type). qwen3-0.6b's train cell runs on a "cuda" and a "cpu"
# mesh: the two records must be equal, leaving out timings, the card and the
# device type. qwen3-32b's train cell (16 micro-batches of 64 layers) is left
# to the CPU sweep.
P16_CELLS = ((0, "qwen3-0.6b", "train_4k", "multipod", "cuda"),
             (0, "qwen3-32b", "decode_32k", "single", "cuda"),
             (0, "zamba2-1.2b", "decode_32k", "single", "cuda"),
             (0, "zamba2-1.2b", "train_4k", "single", "cuda"),
             (1, "qwen3-0.6b", "train_4k", "multipod", "cpu"),
             (1, "deepseek-moe-16b", "train_4k", "single", "cuda"))
P16_CELL_TIMEOUT = 900
HBM_GB = 80.0           # one H100's device memory, against bytes per device
# (b) the host mesh: one GRPO step and one decode step of qwen3-0.6b
P16_TRAIN_ROWS, P16_TRAIN_SEQ = 16, 256
P16_DECODE_ROWS, P16_PROMPT, P16_MAX_LEN = 16, 128, 160


class DryRunLanes:
    """Phase 16 (a)'s cells, each a ``python -m repro_torch.launch.dryrun``
    subprocess on the host's CPU (the meta device: nothing on the card) at
    the lowest priority, one lane a thread that runs its cells one after
    another. Started after the build, so that the cells run beside the card
    phases; ``records`` waits for them. ``stop`` kills what still runs."""

    def __init__(self, out_dir):
        import os
        import subprocess
        import threading
        self.out = Path(out_dir)
        self.procs = []
        self.logs = {}
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")

        def lane(cells):
            for _, arch, shape, mesh, dev in cells:
                key = f"{arch}_{shape}_{mesh}_{dev}"
                p = subprocess.Popen(
                    ["nice", "-n", "19", sys.executable, "-m",
                     "repro_torch.launch.dryrun", "--arch", arch,
                     "--shape", shape, "--mesh", mesh, "--mesh-device", dev, "--out",
                     str(self.out / f"{key}.jsonl")], cwd=str(ROOT), env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                self.procs.append(p)
                try:
                    text, _ = p.communicate(timeout=P16_CELL_TIMEOUT)
                except subprocess.TimeoutExpired:
                    p.kill()
                    text, _ = p.communicate()
                self.logs[key] = (p.returncode, text)

        lanes = sorted({c[0] for c in P16_CELLS})
        self.threads = [threading.Thread(target=lane, daemon=True,
                                         args=([c for c in P16_CELLS if c[0] == n],))
                        for n in lanes]
        self.t0 = time.monotonic()
        for t in self.threads:
            t.start()

    def records(self):
        """{(arch, shape, mesh, device): record} once every cell ended, and
        the seconds waited for them here."""
        t0 = time.monotonic()
        for t in self.threads:
            t.join()
        waited = time.monotonic() - t0
        out = {}
        for _, arch, shape, mesh, dev in P16_CELLS:
            key = f"{arch}_{shape}_{mesh}_{dev}"
            rc, text = self.logs[key]
            path = self.out / f"{key}.jsonl"
            recs = ([json.loads(line) for line in path.read_text().splitlines()]
                    if path.exists() else [])
            if rc != 0 or len(recs) != 1 or not recs[0].get("ok"):
                raise AssertionError(f"phase 16a: dry run {key} exit {rc}, records "
                                     f"{[r.get('error') for r in recs]}: {text[-3000:]}")
            out[(arch, shape, mesh, dev)] = recs[0]
        return out, waited

    def stop(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()


LANES = None            # phase 16 (a)'s dry run, started by main


def dryrun_phase(card):
    """Phase 16 (a): every cell ok; bytes per device under HBM_GB,
    collectives, the dominant term; qwen3-0.6b's "cuda" and "cpu" mesh
    records equal but for timings, the card and the device type."""
    from repro_torch.launch.dryrun import TIMING_FIELDS
    recs, waited = LANES.records()
    out = {"cells": [], "waited_s": waited}
    for (arch, shape, mesh, dev), r in recs.items():
        cell = {k: r[k] for k in (
            "arch", "shape", "mesh", "mesh_device", "chips", "argument_size_in_bytes",
            "temp_size_in_bytes", "temp_by_op", "bytes_per_device", "collectives",
            "collective_bytes_per_chip", "analytic_collective_bytes", "compute_s",
            "memory_s", "collective_s", "dominant", "roofline_frac", "reshards",
            "trace_s", "card")}
        out["cells"].append(cell)
        log(f"[16a dryrun] {arch} {shape} {mesh} ({r['chips']} chips, {dev} mesh): "
            f"{r['bytes_per_device'] / 1e9:.2f} GB a device of {HBM_GB:.0f} "
            f"(arguments {r['argument_size_in_bytes'] / 1e9:.3f}, temporaries "
            f"{r['temp_size_in_bytes'] / 1e9:.3f}); collectives "
            f"{r['collectives']} = {r['collective_bytes_per_chip'] / 1e9:.3f} GB a chip "
            f"(analytic {r['analytic_collective_bytes'] / r['chips'] / 1e9:.3f}); "
            f"dominant {r['dominant']} (compute {r['compute_s']:.3e} s, memory "
            f"{r['memory_s']:.3e} s, collective {r['collective_s']:.3e} s); reshards "
            f"{r['reshards']}; traced in {r['trace_s']} s on {card}")
        if r["bytes_per_device"] >= HBM_GB * 1e9:
            raise AssertionError(f"phase 16a: {arch} {shape} {mesh} needs "
                                 f"{r['bytes_per_device'] / 1e9:.2f} GB a device, "
                                 f"not under {HBM_GB} GB (largest temporaries "
                                 f"{r['temp_by_op']})")
    skip = set(TIMING_FIELDS) | {"card", "mesh_device"}
    a, b = (recs[("qwen3-0.6b", "train_4k", "multipod", d)] for d in ("cuda", "cpu"))
    diff = sorted(k for k in set(a) | set(b) if k not in skip and a.get(k) != b.get(k))
    out["cuda_vs_cpu_mesh_equal"] = not diff
    log(f"[16a dryrun] qwen3-0.6b train_4k multipod: the cuda and cpu meshes' records "
        f"{'equal' if not diff else 'differ in ' + str(diff)}; waited {waited:.1f} s "
        f"for the cells, {time.monotonic() - LANES.t0:.1f} s since they started")
    if diff:
        raise AssertionError(f"phase 16a: cuda and cpu mesh records differ in {diff}")
    return out


def mesh_train_batch(torch, cfg, rows, seq):
    """A GRPO batch of `rows` rows of `seq` tokens (seeded random ids,
    prompts of 16-64 tokens, completions to the half or more of seq,
    uniform rewards)."""
    g = torch.Generator(device="cuda").manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device="cuda", dtype=torch.int32)
    return {"tokens": ints(1, cfg.vocab_size, (rows, seq)),
            "prompt_lens": ints(16, 65, (rows,)),
            "total_lens": ints(seq // 2, seq + 1, (rows,)),
            "rewards": torch.rand(rows, generator=g, device="cuda")}


def host_mesh_phase(torch, M, counters, card):
    """Phase 16 (b): qwen3-0.6b at full width in bf16 (random weights from
    seed 0) through launch.specs' LoRA GRPO step (P16_TRAIN_ROWS rows of
    P16_TRAIN_SEQ tokens, one micro-batch) and one multi-LoRA decode step
    over the dense cache (P16_DECODE_ROWS rows on the stacked adapters, a
    cache prefilled without the mesh), each without a mesh and then on the
    host mesh (launch.mesh.make_host_mesh: a (1, 1) mesh over NCCL, world
    size 1) with params, adapters, optimizer state, batch and cache placed
    by launch.shardings' specs as DTensors, under mesh_context and
    implicit_replication. The kernels take the DTensors through their
    wrappers' boundary (kernels.boundary.on_replicas). The mesh's results
    equal the plain ones bit for bit (loss and metrics, new adapters,
    AdamW's first moment; logits and every cache entry) with the same
    kernel launches; each step timed after an untimed one."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import shardings as sh, specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import make_adapters
    from repro_torch.lora.adapters import stack_adapters
    from repro_torch.models import tree_leaves
    from repro_torch.train.optimizer import adamw_init
    from repro_torch.train.sharding import mesh_context
    cfg = get_config(ARCH)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    lora = make_adapters(cfg, 1, seed=3, device="cuda", b_scale=B_SCALE)[0]
    ads = stack_adapters(make_adapters(cfg, specs.NUM_TENANTS, seed=0, device="cuda",
                                       b_scale=B_SCALE))
    R, S, B = P16_TRAIN_ROWS, P16_TRAIN_SEQ, P16_DECODE_ROWS
    batch = mesh_train_batch(torch, cfg, R, S)
    train = specs.build_train_step(cfg, ShapeConfig("p16_train", S, R, "train"))
    prefill, decode = specs.build_prefill_step(cfg), specs.build_decode_step(cfg)
    g = torch.Generator(device="cuda").manual_seed(8)
    row_ids = (torch.arange(B, device="cuda") % specs.NUM_TENANTS).to(torch.int32)
    toks = torch.randint(1, cfg.vocab_size, (B, P16_PROMPT), generator=g,
                         device="cuda", dtype=torch.int32)
    lens = torch.randint(P16_PROMPT // 2, P16_PROMPT + 1, (B,), generator=g,
                         device="cuda", dtype=torch.int32)
    cur = torch.randint(1, cfg.vocab_size, (B,), generator=g, device="cuda",
                        dtype=torch.int32)
    _, cache0 = prefill(params, ads, row_ids, toks, lens,
                        M.init_cache(cfg, B, P16_MAX_LEN, device="cuda"))

    def whole(t):
        return t.full_tensor() if isinstance(t, DTensor) else t

    def timed(fn, *args):
        """fn(*args) twice (the second timed), with the second's launches."""
        fn(*args)
        torch.cuda.synchronize()
        count_all(counters, reset=True)
        t0 = time.monotonic()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, 1e3 * (time.monotonic() - t0), count_all(counters)

    def clone(tree):
        return {k: v.clone() for k, v in tree.items()}

    plain_train = timed(train, params, lora, adamw_init(lora), batch)
    plain_decode = timed(lambda c: decode(params, ads, row_ids, cur, clone(c)), cache0)
    mesh = make_host_mesh()
    try:
        with mesh_context(mesh), implicit_replication():
            p_in = sh.distribute(params, sh.param_specs(cfg, params, mesh), mesh)
            lspec = sh.lora_specs(cfg, lora, mesh)
            mesh_train = timed(train, p_in, sh.distribute(lora, lspec, mesh),
                               sh.distribute(adamw_init(lora), sh.opt_specs(lspec), mesh),
                               sh.distribute(batch, sh.batch_specs(batch, mesh, R), mesh))
            ads_in = sh.distribute(ads, sh.lora_specs(cfg, ads, mesh, batched=True), mesh)
            rest = sh.distribute({"row_ids": row_ids, "cur": cur},
                                 sh.batch_specs({"row_ids": row_ids, "cur": cur}, mesh, B),
                                 mesh)
            cspec = sh.cache_specs(cfg, cache0, mesh, B)
            mesh_decode = timed(
                lambda c: decode(p_in, ads_in, rest["row_ids"], rest["cur"],
                                 sh.distribute(clone(c), cspec, mesh)), cache0)
            placed = {"params": sum(isinstance(t, DTensor) for t in tree_leaves(p_in)),
                      "cache": sum(isinstance(t, DTensor)
                                   for t in mesh_decode[0][1].values())}
            (new_m, opt_m, met_m), (logits_m, cache_m) = mesh_train[0], mesh_decode[0]
            new_m, mom_m = sh.gather(new_m), sh.gather(opt_m["m"])
            met_m = {k: whole(v) for k, v in met_m.items()}
            logits_m, cache_m = whole(logits_m), sh.gather(cache_m)
    finally:
        dist.destroy_process_group()
    (new_p, opt_p, met_p), (logits_p, cache_p) = plain_train[0], plain_decode[0]
    same = {
        "metrics": all(torch.equal(met_p[k], met_m[k]) for k in met_p),
        "lora": all(torch.equal(a, b) for a, b in zip(tree_leaves(new_p),
                                                       tree_leaves(new_m))),
        "first_moment": all(torch.equal(a, b) for a, b in zip(
            tree_leaves(opt_p["m"]), tree_leaves(mom_m))),
        "logits": bool(torch.equal(logits_p, logits_m)),
        "cache": all(torch.equal(cache_p[k], cache_m[k]) for k in cache_p)}
    out = dict(mesh=list(mesh.shape), placed_dtensors=placed, same_bits=same,
               train=dict(rows=R, seq=S, plain_ms=plain_train[1], mesh_ms=mesh_train[1],
                          plain_launches=plain_train[2], mesh_launches=mesh_train[2],
                          loss=float(met_p["loss"])),
               decode=dict(rows=B, cache_len=P16_MAX_LEN, plain_ms=plain_decode[1],
                           mesh_ms=mesh_decode[1], plain_launches=plain_decode[2],
                           mesh_launches=mesh_decode[2]), card=card)
    log(f"[16b host mesh] {cfg.name} on a {tuple(mesh.shape)} mesh ({placed['params']} "
        f"parameter and {placed['cache']} cache DTensors): GRPO step {R} x {S} "
        f"{mesh_train[1]:.1f} ms vs {plain_train[1]:.1f} ms without the mesh, "
        f"launches {mesh_train[2]} vs {plain_train[2]}; decode step of {B} rows "
        f"{mesh_decode[1]:.2f} ms vs {plain_decode[1]:.2f} ms, launches "
        f"{mesh_decode[2]} vs {plain_decode[2]}; same bits {same} on {card}")
    want_train = dict({k: 0 for k in counters}, token_logprob_fwd=1, token_logprob_bwd=1)
    if plain_train[2] != want_train or mesh_train[2] != plain_train[2] \
            or mesh_decode[2] != plain_decode[2] \
            or plain_decode[2]["gqa_decode"] != cfg.num_layers \
            or plain_decode[2]["sgmv"] != 6 * cfg.num_layers:
        raise AssertionError(f"phase 16b: launches {out}")
    if not all(same.values()) or not placed["params"] or not placed["cache"]:
        raise AssertionError(f"phase 16b: the host mesh's steps differ: {out}")
    out["launches"] = {k: mesh_train[2][k] + mesh_decode[2][k] for k in counters}
    return out


# phase 17: (a) the entry points of repro_torch.launch that stand for the
# JAX package's examples, as subprocesses on the card: (module, arguments,
# the kernels its path must launch); (b) the steady-state sentinel
P17_ENTRY = (("quickstart", ["--steps", "2"],
              ("gqa_decode", "sgmv", "token_logprob_fwd", "token_logprob_bwd")),
             ("serve_multi_lora", ["--tenants", "4"], ("gqa_decode", "sgmv")),
             ("failover_demo", [],
              ("gqa_decode", "sgmv", "token_logprob_fwd", "token_logprob_bwd")),
             ("rl_learning_demo", [],
              ("gqa_decode", "sgmv", "token_logprob_fwd", "token_logprob_bwd")))
P17_TIMEOUT = 300       # seconds an entry point may take
P17_WARM, P17_STEPS = 4, 8   # (b): decode steps of warm-up, then watched


def entry_points_phase(card, entries):
    """Phase 17 (a) and 18 (b): every entry point of `entries` (P17_ENTRY
    and P18_ENTRY) as a subprocess on the card, all started together; each
    must exit 0 and print its kernels' launches with every kernel of its path
    above 0. Returns the record (each one's seconds, launches and what it
    reports; P18_ENTRY's also its output lines)."""
    import os
    import subprocess
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = {}
    t0 = time.monotonic()
    for name, args, _ in entries:
        procs[name] = (subprocess.Popen(
            [sys.executable, "-m", f"repro_torch.launch.{name}", *args],
            cwd=str(ROOT), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), time.monotonic())
    out = {}
    try:
        for name, args, kernels in entries:
            p, started = procs[name]
            try:
                text, _ = p.communicate(timeout=max(1.0, P17_TIMEOUT - (
                    time.monotonic() - started)))
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
                raise AssertionError(f"phase 17a: {name} ran past {P17_TIMEOUT} s: "
                                     f"{text[-2000:]}")
            secs = time.monotonic() - started
            lines = text.splitlines()
            got = [json.loads(x[len("launches "):]) for x in lines
                   if x.startswith("launches ")]
            if p.returncode != 0 or len(got) != 1:
                raise AssertionError(f"phase 17a: {name} exit {p.returncode}: "
                                     f"{text[-3000:]}")
            missing = [k for k in kernels if got[0].get(k, 0) <= 0]
            if missing:
                raise AssertionError(f"phase 17a: {name} launched no {missing}: "
                                     f"{got[0]}")
            rec = dict(args=args, seconds=secs, launches=got[0])
            if name == "quickstart":
                rec["steps"] = [x for x in lines if x.startswith("step ")]
            if name == "failover_demo":
                rec["rows"] = next(x for x in lines if x.startswith("finished:"))
            if name == "rl_learning_demo":
                rec.update(json.loads(next(x for x in lines
                                           if x.startswith("result "))[7:]))
            if name == "multi_tenant_train":
                rec["lines"] = lines
            out[name] = rec
            log(f"[{'18b' if name == 'multi_tenant_train' else '17a'} {name}] "
                f"{' '.join(args) or '(defaults)'}: exit 0 in "
                f"{secs:.1f} s, launches {got[0]}"
                + (f"; SFT loss {rec['sft_loss']:.3f}, reward first5 "
                   f"{rec['first5']:.3f} -> last5 {rec['last5']:.3f}"
                   if name == "rl_learning_demo" else "")
                + (f"; {rec['rows']}" if name == "failover_demo" else ""))
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    out["wall_s"] = time.monotonic() - t0
    out["card"] = card
    return out


def sentinel_phase(torch, M, counters, card):
    """Phase 17 (b): analysis.RecompileSentinel over steady-state continuous
    decode on phase 8's engine (qwen3-0.6b full width, bf16, paged pool, 16
    slots) with 16 rows of CONT_MAX_NEW new tokens: after the refills and
    P17_WARM decode steps, P17_STEPS steps each under
    ``set_sync_debug_mode("warn")`` (``RecompileSentinel.step_syncs``).
    Requires no new launch plan, library load or step-function signature,
    every step a decode step of all 16 rows, and the same synchronizing
    calls in every step but for one upload of the block table in the steps
    that changed it. Returns the record."""
    from collections import Counter

    import numpy as np
    from repro_torch.analysis import RecompileSentinel
    from repro_torch.launch.serve import make_adapters, make_requests, serve_config
    from repro_torch.rollout.engine import ContinuousRolloutEngine

    cfg = serve_config(ARCH, reduce=False)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    adapters = make_adapters(cfg, TENANTS, seed=0, device="cuda", b_scale=B_SCALE)
    eng = ContinuousRolloutEngine(
        cfg, params, max_slots=CONT_SLOTS, max_adapters=TENANTS,
        max_len=CONT_MAX_LEN, paged_kv=True, prefix_cache=False,
        kv_page_size=PAGE, kv_pool_pages=POOL_PAGES, device="cuda")
    for i, a in enumerate(adapters):
        eng.set_adapters(i, a)
    reqs = make_requests(TENANTS, CONT_SLOTS // TENANTS,
                         max_new_tokens=CONT_MAX_NEW, seed=17)
    for i, r in enumerate(reqs):
        r.seed = 1700 + i
        eng.submit(r)
    sent = RecompileSentinel()
    tracked = sent.track_engine(eng)
    for _ in range(200):
        eng.step()
        active = sum(r is not None and r.status == "active" for r in eng._rows)
        if eng.stats.decode_steps >= P17_WARM and active == CONT_SLOTS:
            break
    count_all(counters, reset=True)
    sent.mark()
    steps, changed = [], []
    for _ in range(P17_STEPS):
        before, tbl = eng.stats.decode_steps, eng._tbl_host.copy()
        active = sum(r is not None and r.status == "active" for r in eng._rows)
        _, syncs = sent.step_syncs(eng.step)
        if eng.stats.decode_steps != before + 1 or active != CONT_SLOTS:
            raise AssertionError(f"phase 17b: not a steady step: {active} rows "
                                 f"active, decode steps {before} -> "
                                 f"{eng.stats.decode_steps}")
        steps.append(syncs)
        changed.append(not np.array_equal(tbl, eng._tbl_host))
    launches = count_all(counters)
    new = sent.new_compiles()
    if new:
        raise AssertionError(f"phase 17b: new in steady state: {new} "
                             f"({sent.cache_sizes()})")
    base = [c for c, ch in zip(steps, changed) if not ch]
    if not base or any(c != base[0] for c in base):
        raise AssertionError(f"phase 17b: syncs differ between steps: {steps}")
    base = base[0]
    uploads = Counter()
    for c, ch in zip(steps, changed):
        if ch:
            extra, gone = c - base, base - c
            if gone or sum(extra.values()) != 1:
                raise AssertionError(f"phase 17b: a step with a new block table "
                                     f"synced {dict(c)}, the others {dict(base)}")
            uploads += extra
    if launches["paged_gqa_decode"] != attn_per_step(cfg) * P17_STEPS \
            or launches["sgmv"] != sgmv_per_forward(cfg) * P17_STEPS:
        raise AssertionError(f"phase 17b: launches {launches}")
    rec = dict(tracked=tracked, warm_steps=P17_WARM, steps=P17_STEPS,
               syncs_per_step=sum(base.values()), sync_sources=dict(base),
               table_upload_steps=sum(changed), table_upload_source=dict(uploads),
               cache_sizes=sent.cache_sizes(), launches=launches, card=card)
    log(f"[17b sentinel] {P17_STEPS} steady decode steps of {CONT_SLOTS} rows "
        f"after {P17_WARM}: no new plan, library load or step signature "
        f"({rec['cache_sizes']}); {rec['syncs_per_step']} synchronizing calls a "
        f"step: {dict(base)}; plus the block table's upload in "
        f"{rec['table_upload_steps']} steps: {dict(uploads)}; on {card}")
    eng.shutdown()
    return rec


# phase 18: the port's last gaps against the JAX package. (a) the sampler in
# both threefry layouts; (b) the runtime CLI's paged-pool flags, as a fifth
# subprocess beside P17_ENTRY: 16 slots x 256 tokens = P18_POOL pages of
# P18_PAGE; (c) forward_seq(inputs_embeds=)
P18_ROWS, P18_VOCAB = 16, 151936          # (a): qwen3-0.6b's vocabulary
P18_PAGE, P18_POOL = 32, 128
P18_ENTRY = (("multi_tenant_train",
              ["--preset", ARCH, "--paged-kv", "--kv-page-size", str(P18_PAGE),
               "--kv-pool-pages", str(P18_POOL), "--no-prefix-cache",
               "--no-resume-restore", "--snapshot-budget-bytes", "0",
               "--tasks", "2", "--steps", "1"],
              ("paged_gqa_decode", "sgmv", "token_logprob_fwd",
               "token_logprob_bwd")),)
P18_POOL_LINE = (f"pool: page_size={P18_PAGE} pages={P18_POOL} prefix_cache=off "
                 f"resume_restore=off snapshot_budget_bytes=unlimited")
P18_SEQ = (4, 128)                         # (c): rows x tokens


def sampler_layouts_phase(torch, card):
    """Phase 18 (a): P18_ROWS rows of random fp32 logits at V = P18_VOCAB, a
    key and a counter a row, in each threefry layout: the random bits and
    uniforms drawn on the card bit-equal to the CPU's, ``_sample_rows``' tokens
    equal, and the two layouts' tokens different. Times a sampling call on
    the card in each layout. Returns the record."""
    import numpy as np
    from repro_torch.rollout import prng
    from repro_torch.rollout.prefill import _sample_rows

    g = torch.Generator().manual_seed(18)
    logits = torch.randn(P18_ROWS, P18_VOCAB, generator=g) * 3
    keys = torch.from_numpy(np.stack([prng.fold_in_host(prng.prng_key(1800), i)
                                      for i in range(P18_ROWS)]).astype(np.int64))
    counters = torch.randint(0, 512, (P18_ROWS,), generator=g, dtype=torch.int32)
    temps = torch.full((P18_ROWS,), 0.9)
    on_card = [t.cuda() for t in (logits, keys, counters, temps)]
    rec, tokens = {}, {}
    for flag in (True, False):
        with prng.threefry_partitionable(flag):
            # uniforms lie in [tiny, 1): equal values are equal bits
            same = {name: bool(torch.equal(fn(keys, P18_VOCAB),
                                           fn(on_card[1], P18_VOCAB).cpu()))
                    for name, fn in (("bits", prng.random_bits),
                                     ("uniform", prng.uniform))}
            want = _sample_rows(logits, keys, counters, temps)
            got = _sample_rows(*on_card).cpu()
            ms = bench_ms(_sample_rows, [on_card], iters=20)
        layout = "partitionable" if flag else "legacy"
        if not (all(same.values()) and torch.equal(want, got)):
            raise AssertionError(f"phase 18a ({layout}): card vs CPU bits "
                                 f"{same}, tokens {got.tolist()} vs {want.tolist()}")
        tokens[flag] = got
        rec[layout] = dict(same_bits=same["bits"], same_uniform=same["uniform"],
                           tokens_equal=True, sample_ms=ms)
    rec["layouts_differ"] = int((tokens[True] != tokens[False]).sum())
    if not rec["layouts_differ"]:
        raise AssertionError("phase 18a: both layouts sampled the same tokens")
    if prng.THREEFRY_PARTITIONABLE is not True:
        raise AssertionError("phase 18a: the layout was not restored")
    log(f"[18a sampler] {P18_ROWS} rows x V={P18_VOCAB}, both threefry layouts: "
        f"bits and uniforms on the card bit-equal to the CPU's, tokens equal; "
        f"{rec['layouts_differ']} of {P18_ROWS} tokens differ between the layouts; "
        f"_sample_rows {rec['partitionable']['sample_ms']:.3f} ms (partitionable), "
        f"{rec['legacy']['sample_ms']:.3f} ms (legacy) a call on {card}")
    return rec


def pool_flags_check(rec, card):
    """Phase 18 (b): the record of P18_ENTRY's run (entry_points_phase): the
    pool it asked for printed, every tenant at v1, no prefix hit, and the
    contiguous-cache kernel not launched. Returns the record."""
    lines = rec.pop("lines")
    versions = [int(m.group(1)) for m in (re.match(r"\s+\S+\s+v(\d+):", x)
                                          for x in lines) if m]
    paged = next((x for x in lines if x.startswith("paged KV:")), "")
    hits = re.search(r"prefix_hits=(\d+) ", paged)
    if P18_POOL_LINE not in lines or versions != [1, 1] or not hits \
            or int(hits.group(1)) != 0 or rec["launches"]["gqa_decode"] != 0:
        raise AssertionError(f"phase 18b: pool {P18_POOL_LINE in lines}, "
                             f"versions {versions}, '{paged}', launches "
                             f"{rec['launches']}")
    rec.update(pool=P18_POOL_LINE, versions=versions, paged_kv=paged, card=card)
    log(f"[18b pool flags] {P18_POOL_LINE}; tenants at v{versions}; "
        f"prefix_hits=0; launches {rec['launches']} on {card}")
    return rec


def inputs_embeds_phase(torch, M, counters, card):
    """Phase 18 (c): forward_seq at qwen3-0.6b's full width in bf16, P18_SEQ
    tokens under 4 tenants' adapters (sgmv), once from the ids and once from
    ``inputs_embeds=params["embed"][tokens]``: the same bits. Returns the
    record, with the second call's launches."""
    from repro_torch.launch.serve import make_adapters, serve_config
    from repro_torch.lora.adapters import batched_ctx, stack_adapters

    cfg = serve_config(ARCH, reduce=False)
    params = M.init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    adapters = make_adapters(cfg, TENANTS, seed=0, device="cuda", b_scale=B_SCALE)
    g = torch.Generator(device="cuda").manual_seed(1800)
    B, S = P18_SEQ
    tokens = torch.randint(0, cfg.vocab_size, (B, S), device="cuda", generator=g)
    lora = batched_ctx(stack_adapters(adapters),
                       torch.arange(B, device="cuda", dtype=torch.int32) % TENANTS,
                       cfg)
    with torch.no_grad():
        h_ids = M.forward_seq(params, tokens, cfg, lora)[0]
        count_all(counters, reset=True)
        h_emb = M.forward_seq(params, None, cfg, lora,
                              inputs_embeds=params["embed"][tokens])[0]
        launches = count_all(counters)
    torch.cuda.synchronize()
    if not torch.equal(h_ids, h_emb) or not torch.isfinite(h_emb).all() \
            or launches["sgmv"] != sgmv_per_forward(cfg):
        raise AssertionError(f"phase 18c: equal {torch.equal(h_ids, h_emb)}, "
                             f"max abs diff {(h_ids - h_emb).abs().max().item()}, "
                             f"launches {launches}")
    rec = dict(shape=[B, S, cfg.d_model], dtype=str(h_emb.dtype), same_bits=True,
               launches=launches, card=card)
    log(f"[18c inputs_embeds] {ARCH} full width bf16, {B} x {S} tokens under "
        f"{TENANTS} adapters: forward_seq(inputs_embeds=embed[tokens]) bit-equal "
        f"to forward_seq(tokens); launches {launches} on {card}")
    del params, adapters
    return rec


def main(argv):
    if "--launches-of" in argv:
        # the launches a forward in a served round's profile table, as
        # --profile writes it (serve_profile.txt, of this or an older tree)
        text = Path(argv[argv.index("--launches-of") + 1]).read_text()
        forwards = int(re.match(r"decode steps (\d+)", text).group(1)) + 1
        total, n_sgmv = profile_launches(text)
        print(json.dumps(dict(forwards=forwards, launches=total, sgmv=n_sgmv,
                              per_forward=total / forwards,
                              sgmv_per_forward=n_sgmv / forwards)))
        return 0
    profile_dir = (Path(argv[argv.index("--profile") + 1])
                   if "--profile" in argv else None)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import gqa_decode as gqa
    from repro_torch.kernels import paged_decode as paged
    from repro_torch.kernels import sgmv
    from repro_torch.kernels import token_logprob as tlp
    from repro_torch import models as M
    from repro_torch.launch import roofline
    from repro_torch.launch.serve import (make_adapters, make_requests,
                                          serve_config)
    from repro_torch.rollout.engine import RolloutEngine
    from repro_torch.rollout.prefill import _bucket_len

    t_all = time.monotonic()
    phase_end_s = {}     # seconds from the start at the end of each phase
    torch.backends.cuda.matmul.allow_tf32 = False     # fp32 stays fp32
    torch.backends.cudnn.allow_tf32 = False
    global PEAKS, LANES
    card = roofline.card_line()
    kind = torch.cuda.get_device_name(0)
    PEAKS = roofline.device_peaks()
    log(f"[1 device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
        f"| devices {torch.cuda.device_count()}")

    secs = _build.build_all()
    log(f"[2 build] kernels built in {secs:.2f} s")
    import tempfile
    LANES = DryRunLanes(tempfile.mkdtemp(prefix="dryrun_"))
    for name, text in _build.build_logs().items():
        kernels = ptxas_kernels(text)
        if not kernels:
            log(f"  {name}: {text.strip()[:200]}")
            continue
        regs = [k[1] for k in kernels]
        log(f"  {name}: {len(kernels)} kernels, registers {min(regs)}-{max(regs)}, "
            f"spill stores {sum(k[2] for k in kernels)} bytes in all")
        if name in ("token_logprob", "sgmv"):
            log("    " + ", ".join(f"{k[0]} {k[1]} registers {k[2]} B spilled"
                                   for k in kernels))
            # ptxas's warnings and advisories (a setmaxnreg it ignored, wgmma
            # it serialised)
            for line in text.splitlines():
                if "warning" in line.lower() or "Performance Loss" in line:
                    log(f"    ptxas: {line.strip()[:300]}")
        if name in ("gqa_decode", "paged_decode"):
            # the main path's variants (hd 128, rep 2) and phase 14's (rep 1
            # at hd 128, deepseek-moe's MHA, and at hd 64, zamba2's)
            shown = [k for k in kernels
                     if any(v in k[0] for v in (", 128, 2, ", ", 128, 1, ",
                                                ", 64, 1, ")) or k[2]]
            log("    " + ", ".join(f"{k[0]} {k[1]} registers {k[2]} B spilled"
                                   for k in shown))

    reqs = make_requests(TENANTS, PER_TENANT, max_new_tokens=MAX_NEW, seed=0)
    S_p = _bucket_len(max(len(r.prompt) for r in reqs))
    serve_pos_hi = S_p + MAX_NEW
    g = torch.Generator(device="cuda").manual_seed(1234)
    train_rows = GROUPS * GROUP_SIZE * (-(-(S_p + MAX_NEW) // 8) * 8 - 1)
    counters = {"gqa_decode": gqa.LAUNCHES, "sgmv": sgmv.LAUNCHES,
                "sgmv_cuda": sgmv.CUDA_LAUNCHES,
                "paged_gqa_decode": paged.LAUNCHES,
                "token_logprob_fwd": tlp.FWD_LAUNCHES,
                "token_logprob_bwd": tlp.BWD_LAUNCHES}
    log("[3 kernels] each kernel against its plain version")
    gqa_cases = check_gqa_decode(torch, gqa, ref, g, serve_pos_hi)
    sgmv_cases = check_sgmv(torch, sgmv, ref, g, S_p)
    tlp_fwd_cases, tlp_bwd_cases = check_token_logprob(torch, tlp, ref, g, train_rows)
    paged_cases = check_paged_decode(torch, paged, gqa, ref, g)
    edges = check_decode_edges(torch, gqa, paged, ref, g)
    gqa_cases += [c for c in edges if c["kernel"] == "gqa_decode"]
    paged_cases += [c for c in edges if c["kernel"] == "paged_gqa_decode"]

    phase_end_s["1-3"] = time.monotonic() - t_all

    # -- phase 4: serve ---------------------------------------------------
    cfg = serve_config(ARCH, reduce=False)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = M.init_params(cfg, gen, "cuda")
    adapters = make_adapters(cfg, TENANTS, seed=0, device="cuda", b_scale=B_SCALE)
    warm = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=1, device="cuda")
    warm.generate(make_requests(TENANTS, 1, max_new_tokens=2, seed=1), adapters)
    engine = RolloutEngine(cfg, params, max_len=MAX_LEN, seed=0, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gqa.LAUNCHES.n = 0
    sgmv.LAUNCHES.n = sgmv.CUDA_LAUNCHES.n = 0
    results, stats = engine.generate(reqs, adapters)
    n_gqa, n_sgmv, n_sgmv_cuda = gqa.LAUNCHES.n, sgmv.LAUNCHES.n, sgmv.CUDA_LAUNCHES.n
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    steps = stats.decode_steps
    want_gqa = cfg.num_layers * steps
    want_sgmv = 6 * cfg.num_layers * (steps + 1)
    if (n_gqa, n_sgmv, n_sgmv_cuda) != (want_gqa, want_sgmv, want_sgmv):
        raise AssertionError(f"launch counts gqa_decode {n_gqa} (want {want_gqa}), "
                             f"sgmv {n_sgmv} calls and {n_sgmv_cuda} CUDA launches "
                             f"(want {want_sgmv})")
    B = len(reqs)
    for r, q in zip(results, reqs):
        gen_toks = r["tokens"][r["prompt_len"]:]
        if not (1 <= len(gen_toks) <= q.max_new_tokens):
            raise AssertionError(f"row generated {len(gen_toks)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in gen_toks):
            raise AssertionError("token id outside the vocabulary")
        if not all(np.isfinite(lp) and lp <= 0 for lp in r["gen_logprobs"]):
            raise AssertionError("non-finite or positive logprob")
    decode_tokens = stats.tokens_generated - B
    tok_s = decode_tokens / stats.decode_seconds
    log(f"[4 serve] {ARCH} full size bf16 ({cfg.num_layers} layers, d={cfg.d_model}, "
        f"V={cfg.vocab_size}), {TENANTS} tenants x {PER_TENANT} requests, "
        f"prompt bucket {S_p}, max_len {MAX_LEN}: {steps} decode steps, "
        f"{decode_tokens} decode tokens in {stats.decode_seconds:.3f} s = "
        f"{tok_s:.1f} tok/s ({1e3 * stats.decode_seconds / steps:.2f} ms/step), "
        f"prefill {stats.prefill_seconds:.4f} s, peak memory {peak_gib:.2f} GiB, "
        f"launches gqa_decode {n_gqa} sgmv {n_sgmv} calls, {n_sgmv_cuda} CUDA launches "
        f"(= {cfg.num_layers} x {steps}, 6 x {cfg.num_layers} x {steps + 1}) on {card}")

    if profile_dir is not None:
        profile_serve(torch, cfg, params, adapters, profile_dir)

    phase_end_s["4"] = time.monotonic() - t_all

    # -- phase 5: teacher-forced fp32, card (kernels) vs CPU (plain) --------
    rows = [(results[i], reqs[i].adapter_index)
            for i in range(0, B, B // TF_ROWS)][:TF_ROWS]
    n_sgmv0, n_cuda0 = sgmv.LAUNCHES.n, sgmv.CUDA_LAUNCHES.n
    on_card = teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, "cuda")
    if (sgmv.LAUNCHES.n - n_sgmv0, sgmv.CUDA_LAUNCHES.n - n_cuda0) \
            != (6 * cfg.num_layers,) * 2:
        raise AssertionError("the fp32 card forward did not run the sgmv kernel "
                             "once a projection")
    on_cpu = teacher_forced_logprobs(torch, M, cfg, params, adapters, rows, "cpu")
    tf_err = max(float((a - b).abs().max()) for a, b in zip(on_card, on_cpu))
    served = [torch.tensor(r["gen_logprobs"], dtype=torch.float64) for r, _ in rows]
    bf16_dev = max(float((a - s).abs().max()) for a, s in zip(on_card, served))
    log(f"[5 check] teacher-forced fp32 logprobs of {len(rows)} rows "
        f"({sum(len(a) for a in on_card)} tokens): card vs CPU max abs diff "
        f"{tf_err:.3e} (tol {TF_TOL}); served bf16 vs fp32 max abs diff "
        f"{bf16_dev:.3e}")
    if not tf_err <= TF_TOL:
        raise AssertionError(f"fp32 card vs CPU logprobs differ by {tf_err}")

    phase_end_s["5"] = time.monotonic() - t_all

    # -- phases 6 and 7: GRPO training, then fp32 card vs CPU ---------------
    train, last_tb, start, tc = train_phase(torch, cfg, params, counters, card)
    n_fwd = train["launches"]["token_logprob_fwd"]
    n_bwd = train["launches"]["token_logprob_bwd"]
    if (n_fwd, n_bwd) != (2 * TRAIN_ITERS, TRAIN_ITERS) \
            or not train["launches"]["gqa_decode"] or not train["launches"]["sgmv"]:
        raise AssertionError(f"train phase launches {train['launches']}")
    if profile_dir is not None:
        profile_train(torch, cfg, params, start, last_tb, tc, profile_dir)
    train["check"] = train_check(torch, M, cfg, params, last_tb, start, tc)
    train["check_bf16"] = train_check_bf16(torch, cfg, params, last_tb, start, tc)

    phase_end_s["6-7"] = time.monotonic() - t_all

    # -- phases 8 and 9: continuous engine over the paged pool --------------
    cont, comps = continuous_phase(torch, cfg, params, adapters, counters, card)
    if profile_dir is not None:
        profile_continuous(torch, cfg, params, adapters, profile_dir)
    cont["check"] = paged_check(torch, M, cfg, params, adapters, comps)

    phase_end_s["8-9"] = time.monotonic() - t_all

    # -- phase 10: the runtime, rollout and trainer threads ------------------
    runtime = {run: runtime_phase(torch, cfg, params, counters, card, run)
               for run in RT_RUNS}
    rt_launch = {k: sum(r["launches"][k] for r in runtime.values())
                 for k in counters}
    d0, d = runtime["D0"], runtime["D"]
    log(f"[10 runtime D vs D0] last commit {d['wall_to_last_commit_s']:.2f} s vs "
        f"{d0['wall_to_last_commit_s']:.2f} s; decode ms/step inside train "
        f"{d['decode_step_ms_median_in_train']:.2f} vs "
        f"{d0['decode_step_ms_median_in_train']:.2f}, outside "
        f"{d['decode_step_ms_median_outside_train']:.2f} vs "
        f"{d0['decode_step_ms_median_outside_train']:.2f}; slot occupancy "
        f"{d['summary']['slot_util_pct']:.1f}% vs "
        f"{d0['summary']['slot_util_pct']:.1f}% on {card}")

    phase_end_s["10"] = time.monotonic() - t_all

    # -- phase 11: the copy-on-write prefix cache ----------------------------
    prefix = prefix_phase(torch, cfg, params, adapters, counters, card)
    p11_launch = prefix["shared"]["launches"]

    phase_end_s["11"] = time.monotonic() - t_all

    # -- phase 12: the disaggregated prefill and env stages ------------------
    stages = stage_phase(torch, cfg, params, adapters, counters, card)
    p12_launch = {k: sum(r["launches"][k] for r in stages["modes"].values())
                  for k in counters}

    phase_end_s["12"] = time.monotonic() - t_all

    # -- phase 13: tracing, chaos and restart from a checkpoint --------------
    faults = fault_phase(torch, cfg, params, counters, card, runtime["D"])
    p13_launch = {k: faults["T"]["launches"][k] + faults["R"]["launches"][k]
                  for k in counters}

    phase_end_s["13"] = time.monotonic() - t_all

    # -- phase 14: the moe, ssm and hybrid families at full width ------------
    del params, adapters
    families, fam_kern = family_phase(torch, M, counters, card, gqa, paged, sgmv,
                                      tlp, ref, g, train_rows)
    p14_launch = families["launches"]
    gqa_cases += fam_kern["gqa_decode"]
    paged_cases += fam_kern["paged_gqa_decode"]
    sgmv_cases += fam_kern["sgmv"]
    tlp_fwd_cases += fam_kern["token_logprob_fwd"]
    tlp_bwd_cases += fam_kern["token_logprob_bwd"]

    phase_end_s["14"] = time.monotonic() - t_all

    # -- phase 15: the encdec family through launch.specs --------------------
    encdec, enc_kern = encdec_phase(torch, M, counters, card, PEAKS, gqa, paged, sgmv,
                                    tlp, ref, g, train_rows, S_p)
    p15_launch = encdec["launches"]
    gqa_cases += enc_kern["gqa_decode"]
    sgmv_cases += enc_kern["sgmv"]
    tlp_fwd_cases += enc_kern["token_logprob_fwd"]
    tlp_bwd_cases += enc_kern["token_logprob_bwd"]

    phase_end_s["15"] = time.monotonic() - t_all

    # -- phase 16: the dry run's cells, then the host mesh -------------------
    sharding = {"dryrun": dryrun_phase(card)}
    sharding["host_mesh"] = host_mesh_phase(torch, M, counters, card)
    p16_launch = sharding["host_mesh"]["launches"]

    phase_end_s["16"] = time.monotonic() - t_all

    # -- phase 17: the entry points, then steady-state decode's sentinel -----
    t18 = time.monotonic()
    entries = entry_points_phase(card, P17_ENTRY + P18_ENTRY)
    pool_run = entries.pop("multi_tenant_train")
    p17_launch = {k: sum(e["launches"].get(k, 0) for n, e in entries.items()
                         if isinstance(e, dict) and "launches" in e)
                  for k in counters}
    sentinel = sentinel_phase(torch, M, counters, card)
    for k in counters:
        p17_launch[k] += sentinel["launches"][k]

    phase_end_s["17"] = time.monotonic() - t_all

    # -- phase 18: the sampler's layouts, the pool flags, inputs_embeds -------
    t18a = time.monotonic()
    gaps = {"sampler": sampler_layouts_phase(torch, card)}
    t18c = time.monotonic()
    gaps["pool_flags"] = pool_flags_check(pool_run, card)
    gaps["inputs_embeds"] = inputs_embeds_phase(torch, M, counters, card)
    p18_launch = {k: gaps["pool_flags"]["launches"].get(k, 0)
                  + gaps["inputs_embeds"]["launches"][k] for k in counters}
    gaps["seconds"] = dict(a=t18c - t18a, b=gaps["pool_flags"]["seconds"],
                           c=time.monotonic() - t18c,
                           b_with_17a=entries["wall_s"], since_17a=
                           time.monotonic() - t18)
    log(f"[18] seconds: (a) {gaps['seconds']['a']:.1f}, (b) "
        f"{gaps['seconds']['b']:.1f} beside phase 17 (a)'s four ("
        f"{gaps['seconds']['b_with_17a']:.1f} for all five), (c) "
        f"{gaps['seconds']['c']:.1f} on {card}")

    phase_end_s["18"] = time.monotonic() - t_all
    log("[time] seconds from the start at the end of each phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_end_s.items()))

    print(json.dumps({"serve": dict(
        arch=ARCH, decode_tokens_per_s=tok_s, decode_steps=steps,
        decode_s=stats.decode_seconds, prefill_s=stats.prefill_seconds,
        peak_mem_gib=peak_gib, tf_max_abs_diff=tf_err,
        seconds=time.monotonic() - t_all, build_s=secs, phase_end_s=phase_end_s,
        card=card)}), flush=True)
    print(json.dumps({"train": train}), flush=True)
    print(json.dumps({"continuous": cont}), flush=True)
    print(json.dumps({"runtime": runtime}), flush=True)
    print(json.dumps({"prefix_cache": prefix}), flush=True)
    print(json.dumps({"stages": stages}), flush=True)
    print(json.dumps({"faults": faults}), flush=True)
    print(json.dumps({"families": families}), flush=True)
    print(json.dumps({"encdec": encdec}), flush=True)
    print(json.dumps({"sharding": sharding}), flush=True)
    print(json.dumps({"entry_points": entries, "sentinel": sentinel}), flush=True)
    print(json.dumps({"gaps": gaps}), flush=True)
    fwd_main = next(c for c in tlp_fwd_cases if c["main"])
    gqa_main = next(c for c in gqa_cases if c["main"])
    paged_main = next(c for c in paged_cases if c["main"])
    bwd_main = next(c for c in tlp_bwd_cases if c["main"])
    sgmv_main = next(c for c in sgmv_cases if c["main"])
    print(json.dumps({"kernels": [
        kernel_entry("gqa_decode", "src/repro_torch/kernels/csrc/gqa_decode.cu",
                     "src/repro/kernels/gqa_decode.py:71", gqa_cases,
                     n_gqa + rt_launch["gqa_decode"] + p12_launch["gqa_decode"]
                     + p14_launch["gqa_decode"] + p15_launch["gqa_decode"]
                     + p16_launch["gqa_decode"] + p17_launch["gqa_decode"]
                     + p18_launch["gqa_decode"],
                     dict(launches_by_phase={"serve (4)": n_gqa, **{
                         f"runtime {r} (10)": runtime[r]["launches"]["gqa_decode"]
                         for r in runtime},
                         "stages DED (12)": p12_launch["gqa_decode"],
                         "families (14)": p14_launch["gqa_decode"],
                         "encdec (15)": p15_launch["gqa_decode"],
                         "host mesh (16)": p16_launch["gqa_decode"],
                         "entry points (17)": p17_launch["gqa_decode"],
                         "pool flags and inputs_embeds (18)": p18_launch["gqa_decode"]},
                          launches_per_decode_step=cfg.num_layers,
                          cuda_launches_per_call=gqa_main["cuda_launches_per_call"],
                          plan=gqa_main["plan"])),
        kernel_entry("sgmv", "src/repro_torch/kernels/csrc/sgmv.cu",
                     "src/repro/kernels/sgmv.py:64", sgmv_cases,
                     n_sgmv + cont["launches"]["sgmv"] + rt_launch["sgmv"]
                     + p11_launch["sgmv"] + p12_launch["sgmv"]
                     + p13_launch["sgmv"] + p14_launch["sgmv"] + p15_launch["sgmv"]
                     + p16_launch["sgmv"] + p17_launch["sgmv"]
                     + p18_launch["sgmv"],
                     dict(launches_by_phase={
                         "serve (4)": n_sgmv,
                         "continuous serve (8)": cont["launches"]["sgmv"],
                         **{f"runtime {r} (10)": runtime[r]["launches"]["sgmv"]
                            for r in runtime},
                         "prefix cache (11)": p11_launch["sgmv"],
                         **{f"stages {m} (12)": r["launches"]["sgmv"]
                            for m, r in stages["modes"].items()},
                         **{f"faults {r} (13)": faults[r]["launches"]["sgmv"]
                            for r in ("T", "R")},
                         "families (14)": p14_launch["sgmv"],
                         "encdec (15)": p15_launch["sgmv"],
                         "host mesh (16)": p16_launch["sgmv"],
                         "entry points and sentinel (17)": p17_launch["sgmv"],
                         "pool flags and inputs_embeds (18)": p18_launch["sgmv"]},
                          launches_per_decode_step=6 * cfg.num_layers,
                          cuda_launches_per_call=sgmv_main["cuda_launches_per_call"],
                          plan=sgmv_main["plan"], epilogue="add (sgmv_add_)",
                          sgmv_ms=sgmv_main["a_ms"],
                          sgmv_bound_ms=sgmv_main["a_bound_ms"],
                          sgmv_library_ms=sgmv_main["a_library_ms"])),
        kernel_entry("token_logprob_fwd", "src/repro_torch/kernels/csrc/token_logprob.cu",
                     "src/repro/kernels/token_logprob.py:87", tlp_fwd_cases,
                     n_fwd + rt_launch["token_logprob_fwd"]
                     + p13_launch["token_logprob_fwd"]
                     + p14_launch["token_logprob_fwd"]
                     + p15_launch["token_logprob_fwd"] + p16_launch["token_logprob_fwd"]
                     + p17_launch["token_logprob_fwd"]
                     + p18_launch["token_logprob_fwd"],
                     dict(launches_by_phase={"train (6)": n_fwd, **{
                         f"runtime {r} (10)": runtime[r]["launches"]["token_logprob_fwd"]
                         for r in runtime}, **{
                         f"faults {r} (13)": faults[r]["launches"]["token_logprob_fwd"]
                         for r in ("T", "R")},
                         "families (14)": p14_launch["token_logprob_fwd"],
                         "encdec (15)": p15_launch["token_logprob_fwd"],
                         "host mesh (16)": p16_launch["token_logprob_fwd"],
                         "entry points (17)": p17_launch["token_logprob_fwd"],
                         "pool flags and inputs_embeds (18)": p18_launch["token_logprob_fwd"]},
                          launches_per_train_step="2 in phase 6 (KL on), 1 in phase 10",
                          cuda_launches_per_call=fwd_main["cuda_launches_per_call"],
                          tflops=fwd_main["tflops"], plan=fwd_main["plan"])),
        kernel_entry("token_logprob_bwd", "src/repro_torch/kernels/csrc/token_logprob.cu",
                     "src/repro/kernels/token_logprob.py:87", tlp_bwd_cases,
                     n_bwd + rt_launch["token_logprob_bwd"]
                     + p13_launch["token_logprob_bwd"]
                     + p14_launch["token_logprob_bwd"]
                     + p15_launch["token_logprob_bwd"] + p16_launch["token_logprob_bwd"]
                     + p17_launch["token_logprob_bwd"]
                     + p18_launch["token_logprob_bwd"],
                     dict(launches_by_phase={"train (6)": n_bwd, **{
                         f"runtime {r} (10)": runtime[r]["launches"]["token_logprob_bwd"]
                         for r in runtime}, **{
                         f"faults {r} (13)": faults[r]["launches"]["token_logprob_bwd"]
                         for r in ("T", "R")},
                         "families (14)": p14_launch["token_logprob_bwd"],
                         "encdec (15)": p15_launch["token_logprob_bwd"],
                         "host mesh (16)": p16_launch["token_logprob_bwd"],
                         "entry points (17)": p17_launch["token_logprob_bwd"],
                         "pool flags and inputs_embeds (18)": p18_launch["token_logprob_bwd"]},
                          launches_per_train_step=1,
                          cuda_launches_per_call=bwd_main["cuda_launches_per_call"],
                          tflops=bwd_main["tflops"], plan=bwd_main["plan"],
                          scratch_bytes=bwd_main["scratch_bytes"])),
        kernel_entry("paged_gqa_decode", "src/repro_torch/kernels/csrc/paged_decode.cu",
                     "src/repro/kernels/paged_decode.py:85", paged_cases,
                     cont["launches"]["paged_gqa_decode"]
                     + rt_launch["paged_gqa_decode"]
                     + p11_launch["paged_gqa_decode"]
                     + p12_launch["paged_gqa_decode"]
                     + p13_launch["paged_gqa_decode"]
                     + p14_launch["paged_gqa_decode"]
                     + p17_launch["paged_gqa_decode"]
                     + p18_launch["paged_gqa_decode"],
                     dict(launches_by_phase={
                         "continuous serve (8)": cont["launches"]["paged_gqa_decode"],
                         **{f"runtime {r} (10)": runtime[r]["launches"]["paged_gqa_decode"]
                            for r in runtime},
                         "prefix cache (11)": p11_launch["paged_gqa_decode"],
                         **{f"stages {m} (12)": r["launches"]["paged_gqa_decode"]
                            for m, r in stages["modes"].items() if m != "DED"},
                         **{f"faults {r} (13)": faults[r]["launches"]["paged_gqa_decode"]
                            for r in ("T", "R")},
                         "families (14)": p14_launch["paged_gqa_decode"],
                         "sentinel (17)": p17_launch["paged_gqa_decode"],
                         "pool flags and inputs_embeds (18)": p18_launch["paged_gqa_decode"]},
                          launches_per_decode_step=cfg.num_layers,
                          cuda_launches_per_call=paged_main["cuda_launches_per_call"],
                          plan=paged_main["plan"])),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}),
          flush=True)
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    finally:
        if LANES is not None:
            LANES.stop()
    sys.exit(rc)
