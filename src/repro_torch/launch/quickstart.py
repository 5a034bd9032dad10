"""Quickstart: one tenant's GRPO fine-tuning with LoRA (the port's
counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.quickstart              # qwen3-0.6b, bf16, cuda
    PYTHONPATH=src python -m repro_torch.launch.quickstart --reduced --device cpu --steps 2

Rolls out arithmetic prompts (gsm8k, operands up to 9) in groups, verifies
their rewards, and applies GRPO updates through the same train step the
service uses; prints the reward curve. The default runs ``--arch
qwen3-0.6b`` at its full published size in bf16 on the card, with random
weights from seed 0 and adapters whose ``b`` is drawn from N(0, 0.02²)
(``launch.serve``'s): ``generate`` runs the ``gqa_decode`` and ``sgmv``
kernels, the GRPO step the ``token_logprob`` forward and backward.
``--reduced`` runs the JAX example's own model: the reduced fp32
``granite-3-2b`` with the tokenizer's vocabulary and the adapters
``init_lora`` gives. The last line before "done" gives the kernels'
launches (``kernels.launch_counts``).
"""
from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from repro_torch.envs.tasks import make_env
from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import make_adapters, serve_config
from repro_torch.lora.adapters import init_lora
from repro_torch.models import init_params, tree_leaves
from repro_torch.models.common import resolve_device
from repro_torch.rollout.engine import (RolloutEngine, RolloutRequest,
                                       to_trajectory_batch)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.train_step import (TrainConfig, batch_from_trajectory,
                                          init_opt_state, make_train_step)


def run(cfg, params, adapters, *, steps: int = 8, groups: int = 2,
        group_size: int = 4, device="cuda", log=print):
    """The example's loop on given weights: `steps` rounds of `groups`
    prompts x `group_size` samples (4 new tokens each, temperature 1.0,
    prompts from ``random.Random(0)``), each round's GRPO update applied to
    `adapters` (lr 3e-3). Returns per-step {"reward", "loss", "entropy"}
    and the final adapters. On the card the step uses the ``token_logprob``
    kernel; on the CPU the chunked path, as the JAX example does."""
    dev = resolve_device(device)
    tc = TrainConfig(group_size=group_size, adamw=AdamWConfig(lr=3e-3),
                     use_logprob_kernel=dev.type == "cuda")
    opt = init_opt_state(cfg, tc, params, adapters)
    step = make_train_step(cfg, tc)
    engine = RolloutEngine(cfg, params, max_len=64, seed=0, device=dev)
    env = make_env("gsm8k", max_operand=9)
    rng = random.Random(0)
    out = []
    for v in range(steps):
        reqs = []
        for _ in range(groups):
            prompt, truth = env.sample_prompt(rng)
            for _ in range(group_size):
                reqs.append(RolloutRequest("quickstart", 0, prompt, truth,
                                           env, max_new_tokens=4,
                                           temperature=1.0))
        t0 = time.time()
        results, _ = engine.generate(reqs, [adapters])
        tb = to_trajectory_batch(results, "quickstart", v, group_size,
                                 pad_to=64)
        adapters, opt, m = step(params, adapters, opt,
                                batch_from_trajectory(tb, tc, dev))
        rec = {"reward": float(np.mean(tb.rewards)),
               "loss": float(m["loss"]), "entropy": float(m["entropy"])}
        out.append(rec)
        log(f"step {v:2d}  reward={rec['reward']:.3f}  "
            f"loss={rec['loss']:+.4f}  entropy={rec['entropy']:.2f}  "
            f"({time.time() - t0:.1f}s)")
    return out, adapters


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--group-size", type=int, default=4)
    ap.add_argument("--arch", default=None,
                    help="default qwen3-0.6b; granite-3-2b with --reduced")
    ap.add_argument("--reduced", action="store_true",
                    help="the JAX example's reduced fp32 model")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = args.arch or ("granite-3-2b" if args.reduced else "qwen3-0.6b")
    cfg = serve_config(arch, reduce=args.reduced)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    if args.reduced:
        adapters = init_lora(cfg, gen, dev)
    else:
        adapters = make_adapters(cfg, 1, seed=0, device=dev,
                                 b_scale=0.02)[0]
    print(f"arch={cfg.name} params="
          f"{sum(x.numel() for x in tree_leaves(params)):,} on {dev}")
    run(cfg, params, adapters, steps=args.steps, groups=args.groups,
        group_size=args.group_size, device=dev)
    print("launches " + json.dumps(launch_counts()))
    print("done — the adapters are the tenant's θ^(v); the base never moved.")


if __name__ == "__main__":
    main()
