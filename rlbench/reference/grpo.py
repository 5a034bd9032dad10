"""Plain reference of the runtime's LoRA GRPO update: group-normalised
advantages, the PPO-clip objective with the decoupled importance weight of
a stale batch, and AdamW with global-norm clipping, in fp32 over one row at
a time. It imports torch alone.

One update over a batch of G-row groups (rows as lists of token ids with
their prompt lengths, loss masks and rewards):
  A_i = (r_i - mean_group) / (std_group + 1e-4), std with ddof 0;
  per completion token, ratio = exp(lp - lp.detach()) (1 in value, the
  policy gradient in grad), obj = min(ratio·A, clip(ratio, 1-ε, 1+ε)·A),
  weighted by ρ = min(exp(lp - lp_behaviour), cap) (cap > 0), lp_behaviour
  the logprobs of the tokens under the adapters that sampled them;
  loss = -Σ obj·mask / Σ mask over the whole batch;
  AdamW: g clipped to global norm 1, m = b1 m + (1-b1) g,
  v = b2 v + (1-b2) g², θ -= lr · (m / (1-b1^t)) / (sqrt(v / (1-b2^t)) + eps).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

Tree = Dict[str, Dict[str, torch.Tensor]]


@dataclass
class Row:
    tokens: List[int]
    prompt_len: int
    mask: List[float]            # loss mask of the completion tokens
    reward: float
    behaviour: Optional[List[float]] = None   # logprobs under the adapters
                                              # that sampled the tokens


@dataclass
class Hyper:
    lr: float = 3e-3
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    clip_norm: float = 1.0
    clip_eps: float = 0.2
    is_cap: float = 2.0
    adv_eps: float = 1e-4


def advantages(rewards: Sequence[float], group: int, eps: float) -> List[float]:
    r = torch.tensor(rewards, dtype=torch.float64).view(-1, group)
    a = (r - r.mean(1, keepdim=True)) / (r.std(1, keepdim=True, unbiased=False) + eps)
    return a.view(-1).tolist()


def tree_map(fn, tree: Tree) -> Tree:
    return {t: {k: fn(v) for k, v in ab.items()} for t, ab in tree.items()}


def leaves(tree: Tree) -> List[torch.Tensor]:
    return [tree[t][k] for t in sorted(tree) for k in ("a", "b")]


def adam_init(params: Tree):
    return {"m": tree_map(torch.zeros_like, params),
            "v": tree_map(torch.zeros_like, params), "step": 0}


def grpo_step(model, params: Tree, opt, rows: Sequence[Row],
              group: int, hp: Hyper, keep: Optional[Sequence[int]] = None):
    """One update of `model` (a reference with ``completion_logprobs``).
    ρ takes each row's behaviour logprobs (``Row.behaviour``: the check
    works them out with the reference under the versions that decoded
    the row). `keep`: the rows the update
    sums over (all by default; a fault drill leaves some out). Returns
    (loss, clipped gradient tree, new params, new optimizer state)."""
    dev = model.w["embed"].device
    adv = advantages([r.reward for r in rows], group, hp.adv_eps)
    idx = list(range(len(rows))) if keep is None else list(keep)
    denom = max(sum(sum(rows[i].mask) for i in idx), 1.0)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    total = 0.0
    for i in idx:
        r = rows[i]
        tok = torch.tensor(r.tokens, dtype=torch.long, device=dev)
        mask = torch.tensor(r.mask, dtype=torch.float32, device=dev)
        beh = None
        if r.behaviour is not None and hp.is_cap > 0:
            beh = torch.tensor(r.behaviour, dtype=torch.float32, device=dev)
        with torch.enable_grad():
            lp = model.completion_logprobs(tok, r.prompt_len, p)
            old = lp.detach()
            ratio = torch.exp(lp - old)
            a = float(adv[i])
            obj = torch.minimum(ratio * a,
                                torch.clamp(ratio, 1 - hp.clip_eps, 1 + hp.clip_eps) * a)
            if hp.is_cap > 0:
                rho = torch.ones_like(old) if beh is None else torch.exp(old - beh)
                obj = torch.clamp(rho, max=hp.is_cap) * obj
            part = -(obj * mask).sum() / denom
            part.backward()
        total += float(part.detach())
    grads = tree_map(lambda t: t.grad.detach().clone(), p)
    gl = leaves(grads)
    norm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in gl)).item()
    scale = min(1.0, hp.clip_norm / (norm + 1e-9)) if hp.clip_norm else 1.0
    grads = tree_map(lambda g: g * scale, grads)
    step = opt["step"] + 1
    b1c, b2c = 1 - hp.b1 ** step, 1 - hp.b2 ** step
    m = {t: {k: hp.b1 * opt["m"][t][k] + (1 - hp.b1) * grads[t][k] for k in ab}
         for t, ab in grads.items()}
    v = {t: {k: hp.b2 * opt["v"][t][k] + (1 - hp.b2) * grads[t][k] ** 2 for k in ab}
         for t, ab in grads.items()}
    new = {t: {k: params[t][k] - hp.lr * (m[t][k] / b1c)
               / (torch.sqrt(v[t][k] / b2c) + hp.eps) for k in ab}
           for t, ab in params.items()}
    return total, grads, new, {"m": m, "v": v, "step": step}
