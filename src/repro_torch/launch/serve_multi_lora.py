"""Multi-LoRA batched serving: one fused batch answers prompts for several
tenants' adapters at once (the paper's rollout path, serving only; the
port's counterpart of ``examples/serve_multi_lora.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve_multi_lora --tenants 4
    PYTHONPATH=src python -m repro_torch.launch.serve_multi_lora --reduced --device cpu

The default serves ``--arch qwen3-0.6b`` at its full published size in
bf16 on the card, with random weights from seed 0 and one adapter a
tenant whose ``b`` is drawn from N(0, 0.02²) (``launch.serve``'s): the
decode runs the ``gqa_decode`` kernel, every adapted projection ``sgmv``.
``--reduced`` runs the JAX example's own model, the reduced fp32
``granite-3-2b`` with the tokenizer's vocabulary, and its adapters (as
``init_lora`` gives them). Where the JAX example's ``--use-kernel`` routes
the adapters through the Pallas kernel in interpret mode, the port runs
its kernels whenever the tensors lie on the card. Prints each request's
text and, on a line of its own, the kernels' launches.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.kernels import launch_counts
from repro_torch.launch.serve import (make_adapters, make_requests, render,
                                      serve_config)
from repro_torch.lora.adapters import init_lora
from repro_torch.models import init_params
from repro_torch.models.common import resolve_device
from repro_torch.rollout.engine import RolloutEngine


def serve(cfg, params, adapters, *, per_tenant: int = 2, device="cuda",
          log=print):
    """The example's round on given weights: `per_tenant` gsm8k prompts
    (``random.Random(0)``) for each adapter in `adapters`, 6 new tokens at
    temperature 0.8 (``launch.serve.make_requests``), one fused
    ``generate``. Returns (results, stats)."""
    dev = resolve_device(device)
    engine = RolloutEngine(cfg, params, max_len=64, seed=0, device=dev)
    reqs = make_requests(len(adapters), per_tenant, max_new_tokens=6)
    results, stats = engine.generate(reqs, adapters)
    log(f"served {len(reqs)} requests for {len(adapters)} tenants in ONE "
        f"fused batch: {stats.decode_steps} decode steps, "
        f"{stats.wall_seconds:.2f}s wall")
    for r in results:
        log(f"  {r['task_id']:10s} {render(r['tokens'])!r}")
    return results, stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tenants", type=int, default=4)
    ap.add_argument("--per-tenant", type=int, default=2)
    ap.add_argument("--arch", default=None,
                    help="default qwen3-0.6b; granite-3-2b with --reduced")
    ap.add_argument("--reduced", action="store_true",
                    help="the JAX example's reduced fp32 model")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    arch = args.arch or ("granite-3-2b" if args.reduced else "qwen3-0.6b")
    cfg = serve_config(arch, reduce=args.reduced)
    params = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if args.reduced:
        adapters = [init_lora(cfg, torch.Generator(device=dev).manual_seed(
            100 + t), dev) for t in range(args.tenants)]
    else:
        adapters = make_adapters(cfg, args.tenants, seed=0,
                                 device=dev, b_scale=0.02)
    serve(cfg, params, adapters, per_tenant=args.per_tenant, device=dev)
    print("launches " + json.dumps(launch_counts()))


if __name__ == "__main__":
    main()
