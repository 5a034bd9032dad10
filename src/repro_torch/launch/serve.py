"""Multi-LoRA serving CLI (the round-fused rollout engine in serve-only mode).

    PYTHONPATH=src python -m repro_torch.launch.serve            # qwen3-0.6b, bf16, cuda
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

The default serves ``--arch qwen3-0.6b`` at its full published size (28
layers, d=1024, V=151936) in bf16 on the card, with random weights from seed
0, 32 new tokens a request and a 256-token cache. ``--reduced`` serves the
tiny same-family config in fp32 with the rollout tokenizer's vocabulary, 6
new tokens and a 64-token cache (the JAX CLI's setting). Prompts come from
the repo's gsm8k environment; token ids the 54-symbol character tokenizer
cannot decode are printed as ``<id>``.
"""
from __future__ import annotations

import argparse
import dataclasses
import random
from typing import List

import torch

from repro_torch.configs import REGISTRY, ModelConfig, reduced
from repro_torch.data import tokenizer as tok
from repro_torch.envs.tasks import make_env
from repro_torch.lora.adapters import init_lora
from repro_torch.models import init_params
from repro_torch.models.common import resolve_device
from repro_torch.rollout.engine import RolloutEngine, RolloutRequest


def serve_config(arch: str, *, reduce: bool) -> ModelConfig:
    cfg = REGISTRY[arch]
    if reduce:
        return dataclasses.replace(reduced(cfg, dtype="float32"),
                                   vocab_size=tok.VOCAB_SIZE)
    return cfg


def make_adapters(cfg: ModelConfig, tenants: int, *, seed: int, device,
                  b_scale: float = 0.0) -> List[dict]:
    """One adapter tree per tenant. ``init_lora`` zeroes every `b`, which
    makes the LoRA delta 0; ``b_scale > 0`` draws `b` from N(0, b_scale²) so
    that each tenant's adapter changes its rows."""
    dev = resolve_device(device)
    out = []
    for t in range(tenants):
        gen = torch.Generator(device=dev).manual_seed(seed + 100 + t)
        tree = init_lora(cfg, gen, dev)
        if b_scale > 0:
            for leaf in tree["layers"].values():
                leaf["b"] = b_scale * torch.randn(
                    leaf["b"].shape, generator=gen, device=dev,
                    dtype=torch.float32).to(leaf["b"].dtype)
        out.append(tree)
    return out


def make_requests(tenants: int, per_tenant: int, *, max_new_tokens: int,
                  seed: int = 0) -> List[RolloutRequest]:
    """`per_tenant` gsm8k requests for each tenant, tenant t on adapter t,
    sampled at temperature 0.8 (the JAX CLI's)."""
    env = make_env("gsm8k")
    rng = random.Random(seed)
    reqs = []
    for t in range(tenants):
        for _ in range(per_tenant):
            prompt, truth = env.sample_prompt(rng)
            reqs.append(RolloutRequest(f"tenant-{t}", t, prompt, truth, env,
                                       max_new_tokens=max_new_tokens,
                                       temperature=0.8))
    return reqs


def render(ids) -> str:
    """Tokenizer text where it can decode, ``<id>`` elsewhere."""
    out = []
    for i in ids:
        i = int(i)
        if i < tok.VOCAB_SIZE:
            out.append(tok.decode_with_specials([i]))
        else:
            out.append(f"<{i}>")
    return "".join(out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family fp32 config with the tokenizer "
                         "vocabulary")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--per-tenant", type=int, default=4)
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = serve_config(args.arch, reduce=args.reduced)
    max_new, max_len = (6, 64) if args.reduced else (32, 256)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    adapters = make_adapters(cfg, args.tenants, seed=0, device=dev)
    engine = RolloutEngine(cfg, params, max_len=max_len, seed=0, device=dev)
    reqs = make_requests(args.tenants, args.per_tenant, max_new_tokens=max_new)
    results, stats = engine.generate(reqs, adapters)
    decoded = sum(len(r["tokens"]) - r["prompt_len"] for r in results)
    print(f"served {len(reqs)} requests for {args.tenants} tenants of "
          f"{cfg.name} ({cfg.num_layers} layers, d={cfg.d_model}, "
          f"V={cfg.vocab_size}, {cfg.dtype}) on {dev} in ONE fused batch: "
          f"{stats.decode_steps} decode steps, {decoded} tokens, prefill "
          f"{stats.prefill_seconds:.3f}s, decode {stats.decode_seconds:.3f}s, "
          f"wall {stats.wall_seconds:.2f}s")
    for r in results:
        print(f"  {r['task_id']:10s} {render(r['tokens'])!r}")
    return results, stats


if __name__ == "__main__":
    main()
