"""AdamW + global-norm clipping over plain parameter trees (port of
``repro.train.optimizer``).

Optimizer state is a plain tree {m, v, step} mirroring the param tree —
exactly the φ_t^(v) the multi-task manager versions per tenant (paper §4.2).
As in the JAX package, moments are fp32, ``step`` is an int32 scalar and
the bias corrections are computed in fp32. Updates return new tensors; the
trees passed in are left as they were.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from repro_torch.models import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    warmup_steps: int = 0


def adamw_init(params) -> Dict[str, Any]:
    def zeros(p):
        return tree_map(lambda t: torch.zeros(t.shape, dtype=torch.float32,
                                              device=t.device), p)
    dev = tree_leaves(params)[0].device
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tree_leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    n = global_norm(grads)
    scale = torch.clamp(max_norm / (n + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), n


def adamw_update(params, grads, state, cfg: AdamWConfig):
    """Returns (new_params, new_state, grad_norm)."""
    if cfg.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    else:
        grads = tree_map(lambda g: g.float(), grads)
        gnorm = global_norm(grads)
    step = state["step"] + 1
    step_f = step.float()
    lr = cfg.lr
    if cfg.warmup_steps:
        lr = lr * torch.clamp(step_f / cfg.warmup_steps, max=1.0)
    b1c = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), step_f)
    b2c = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), step_f)

    def upd(p, g, m, v):
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]))]
    new_p = tree_unflatten(params, [o[0] for o in out])
    new_m = tree_unflatten(params, [o[1] for o in out])
    new_v = tree_unflatten(params, [o[2] for o in out])
    return new_p, {"m": new_m, "v": new_v, "step": step}, gnorm
