"""Learning demo (the paper's Fig 1 shape): an SFT warm-up of the base,
then GRPO on one tenant's adapter lifts its verifiable reward (the port's
counterpart of ``examples/rl_learning_demo.py``).

    PYTHONPATH=src python -m repro_torch.launch.rl_learning_demo             # cuda
    PYTHONPATH=src python -m repro_torch.launch.rl_learning_demo --device cpu

It runs the JAX example's model and schedule: the reduced fp32
``granite-3-2b`` with the tokenizer's vocabulary and LoRA rank 8 (alpha
32), random weights from seed 0; 45 SFT steps of the whole base on the
"copy" task (16 rows of 24 tokens, lr 3e-3), then 40 GRPO rounds of 3
prompts x 8 samples (4 new tokens, lr 4e-3). At full width, learning from
random weights does not fit a demo's time. Prints the SFT loss, the reward
every 5 rounds, its first-5 and last-5 means, and, on a line of its own,
the kernels' launches. On the card the GRPO step uses the
``token_logprob`` kernel; the SFT step trains the whole base, which the
kernel's backward does not (it has no ``dW``), so it takes the chunked
path on either device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import random

import numpy as np
import torch

from repro_torch.configs import LoRAConfig
from repro_torch.data import tokenizer as tok
from repro_torch.envs.tasks import make_env
from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import serve_config
from repro_torch.lora.adapters import init_lora
from repro_torch.models import init_params
from repro_torch.models.common import resolve_device
from repro_torch.rollout.engine import (RolloutEngine, RolloutRequest,
                                       to_trajectory_batch)
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.sft import make_sft_step, sft_init
from repro_torch.train.train_step import (TrainConfig, batch_from_trajectory,
                                          init_opt_state, make_train_step)

SFT_STEPS, GRPO_ROUNDS = 45, 40


def demo_config():
    """The example's model: reduced fp32 granite, LoRA rank 8, alpha 32."""
    return dataclasses.replace(serve_config("granite-3-2b", reduce=True),
                               lora=LoRAConfig(rank=8, alpha=32.0))


def build_sft_batch(env, rng, rows, S, device):
    tokens = np.zeros((rows, S), np.int32)
    p_lens = np.zeros((rows,), np.int32)
    t_lens = np.zeros((rows,), np.int32)
    for j in range(rows):
        prompt, truth = env.sample_prompt(rng)
        seq = prompt + tok.encode(truth) + [tok.EOS]
        tokens[j, :len(seq)] = seq
        p_lens[j], t_lens[j] = len(prompt), len(seq)
    return {k: torch.as_tensor(v, device=device)
            for k, v in (("tokens", tokens), ("prompt_lens", p_lens),
                         ("total_lens", t_lens))}


def run(cfg, params, adapters, *, device="cuda", sft_steps=SFT_STEPS,
        rounds=GRPO_ROUNDS, log=print):
    """The example's two stages on given weights (`adapters` the tenant's
    fresh LoRA tree). Returns {"sft_loss", "rewards", "exact",
    "first5", "last5"}."""
    dev = resolve_device(device)
    env = make_env("copy", length=3, alphabet="0123456789")
    rng = random.Random(0)
    sft = make_sft_step(cfg, AdamWConfig(lr=3e-3), trainable="full")
    sopt = sft_init(params)
    for i in range(sft_steps):
        params, sopt, m = sft(None, params, sopt,
                              build_sft_batch(env, rng, 16, 24, dev))
        if i % 50 == 0:
            log(f"sft {i:3d}: loss={float(m['loss']):.3f}")
    sft_loss = float(m["loss"])
    log(f"sft done: loss={sft_loss:.3f} — the base knows the format; "
        f"tenants specialize via LoRA + GRPO:")

    tc = TrainConfig(group_size=8, adamw=AdamWConfig(lr=4e-3),
                     use_logprob_kernel=dev.type == "cuda")
    opt = init_opt_state(cfg, tc, params, adapters)
    step = make_train_step(cfg, tc)
    engine = RolloutEngine(cfg, params, max_len=48, seed=0, device=dev)
    rews, exact = [], []
    for v in range(rounds):
        reqs = []
        for _ in range(3):
            prompt, truth = env.sample_prompt(rng)
            for _ in range(8):
                reqs.append(RolloutRequest("t", 0, prompt, truth, env, 4,
                                           1.0))
        results, _ = engine.generate(reqs, [adapters])
        tb = to_trajectory_batch(results, "t", v, 8, pad_to=48)
        adapters, opt, m = step(params, adapters, opt,
                                batch_from_trajectory(tb, tc, dev))
        rews.append(float(np.mean(tb.rewards)))
        exact.append(float(np.mean(tb.rewards >= 1.0)))
        if v % 5 == 0:
            log(f"grpo v{v:2d}: reward={rews[-1]:.3f} exact={exact[-1]:.2f}")
    a, b = float(np.mean(rews[:5])), float(np.mean(rews[-5:]))
    log(f"\nreward first5={a:.3f} → last5={b:.3f} "
        f"({'improved' if b > a else 'flat'})")
    return {"sft_loss": sft_loss, "rewards": rews, "exact": exact,
            "first5": a, "last5": b}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = demo_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    res = run(cfg, params, init_lora(cfg, gen, dev), device=dev)
    print("result " + json.dumps({k: res[k] for k in
                                  ("sft_loss", "first5", "last5")}))
    print("launches " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
