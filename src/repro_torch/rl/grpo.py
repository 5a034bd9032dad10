"""GRPO (group-relative policy optimization) — the paper's training
algorithm (§5 "Training Algorithm"): critic-free PPO-clip with advantages
normalized within each G-sample group of the same prompt (port of
``repro.rl.grpo``).

The loss operates on token logprobs produced by the model's training
forward; logits→logprob extraction is vocab-chunked (or the fused
``token_logprob`` kernel with ``use_kernel``) so the [B, S, V] softmax is
never materialized in fp32 at large vocab.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels.boundary import is_dtensor
from repro_torch.train.sharding import (constrain, matmul, vocab_gather,
                                        vocab_softmax_stats)


def group_advantages(rewards, group_size: int, eps: float = 1e-4):
    """rewards: [R] with contiguous groups of `group_size`.
    A_i = (r_i - mean_group) / (std_group + eps), std with ddof 0 as
    ``jnp.std``."""
    R = rewards.shape[0]
    # rows split over dp need not split into groups over dp: DTensor does
    # not reshard across the view as GSPMD does, so the rewards (R floats)
    # are replicated first
    rewards = constrain(rewards, None, note="group_rows")
    g = rewards.reshape(R // group_size, group_size)
    mean = g.mean(dim=1, keepdim=True)
    std = g.std(dim=1, keepdim=True, correction=0)
    return ((g - mean) / (std + eps)).reshape(R)


def _chunk_logprobs(h, vocab_w, t, logit_softcap):
    logits = matmul(h, vocab_w.to(h.dtype)).float()
    if logit_softcap:
        logits = torch.tanh(logits / logit_softcap) * logit_softcap
    if is_dtensor(logits):              # vocab-parallel, shard by shard
        lse, ent = vocab_softmax_stats(logits)
        return vocab_gather(logits, t.long()) - lse, ent
    lse = torch.logsumexp(logits, dim=-1)
    tgt = vocab_gather(logits, t.long())
    p = torch.softmax(logits, dim=-1)
    return tgt - lse, lse - (p * logits).sum(-1)


def token_logprobs_chunked(hidden, vocab_w, targets, logit_softcap: float = 0.0,
                           chunk: int = 1024, use_kernel: bool = False):
    """log p(targets | hidden) without materializing [B, S, V] in fp32.

    hidden: [B, S, d]; vocab_w: [d, V]; targets: [B, S] (next-token ids,
    i.e. tokens shifted left). Returns [B, S] float32 logprobs + entropy.
    With ``use_kernel`` the fused ``token_logprob`` kernel computes them
    (its plain version for CPU tensors)."""
    if use_kernel:
        from repro_torch.kernels.ops import token_logprob
        return token_logprob(hidden, vocab_w, targets, logit_softcap)
    B, S, d = hidden.shape
    nchunks = max(1, S // chunk)
    if S % nchunks:
        raise ValueError(f"sequence {S} does not split into {nchunks} chunks")
    cs = S // nchunks
    lps, ents = [], []
    for c in range(nchunks):
        h, t = hidden[:, c * cs:(c + 1) * cs], targets[:, c * cs:(c + 1) * cs]
        if torch.is_grad_enabled():
            # recompute the chunk's [B, chunk, V] fp32 logits in the backward
            # instead of saving them (one extra [chunk,d]x[d,V] matmul)
            lp, ent = checkpoint(_chunk_logprobs, h, vocab_w, t, logit_softcap,
                                 use_reentrant=False)
        else:
            lp, ent = _chunk_logprobs(h, vocab_w, t, logit_softcap)
        lps.append(lp)
        ents.append(ent)
    return torch.cat(lps, dim=1), torch.cat(ents, dim=1)


class GRPOOut(NamedTuple):
    loss: torch.Tensor
    pg_loss: torch.Tensor
    kl: torch.Tensor
    entropy: torch.Tensor
    ratio_mean: torch.Tensor
    clip_frac: torch.Tensor
    is_weight_mean: torch.Tensor   # mean truncated importance weight (1.0
                                   # when the off-policy correction is off)
    is_trunc_frac: torch.Tensor    # fraction of loss tokens whose raw weight
                                   # exceeded is_cap (how hard the cap bites)


def grpo_loss(new_logprobs, old_logprobs, advantages, mask,
              ref_logprobs=None, *, clip_eps: float = 0.2,
              kl_coef: float = 0.0, entropy: Optional[torch.Tensor] = None,
              ent_coef: float = 0.0,
              behavior_logprobs: Optional[torch.Tensor] = None,
              is_cap: float = 0.0) -> GRPOOut:
    """PPO-clip objective with per-group advantages.

    new/old_logprobs: [R, S] token logprobs; advantages: [R] (broadcast over
    tokens, GRPO-style); mask: [R, S] completion mask. ref_logprobs enables
    the k3 KL penalty to the base policy (= adapter-off forward).

    Off-policy correction (bounded-staleness trainer): when the rows were
    generated by a STALE adapter version, `behavior_logprobs` are the
    logprobs recorded at sample time under that behaviour policy μ, and the
    decoupled-PPO factorization applies: the clip ratio stays π_new/π_prox
    (π_prox = the recomputed `old_logprobs`) while a truncated per-token
    importance weight ρ = min(exp(π_prox − μ), is_cap) reweights the clipped
    objective. Both gates (`behavior_logprobs is not None` and `is_cap > 0`)
    must be open; otherwise the loss is the on-policy one.
    """
    dev = new_logprobs.device
    adv = advantages[:, None]
    log_ratio = new_logprobs - old_logprobs
    ratio = torch.exp(log_ratio)
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - clip_eps, 1.0 + clip_eps) * adv
    obj = torch.minimum(unclipped, clipped)
    denom = torch.clamp(mask.sum(), min=1.0)
    if behavior_logprobs is not None and is_cap > 0:
        # ρ is a constant w.r.t. the new policy — pure reweighting, no
        # gradient path through the behaviour correction
        iw_raw = torch.exp(old_logprobs - behavior_logprobs).detach()
        iw = torch.clamp(iw_raw, max=is_cap)
        obj = iw * obj
        is_weight_mean = (iw * mask).sum() / denom
        is_trunc_frac = ((iw_raw > is_cap) * mask).sum() / denom
    else:
        is_weight_mean = torch.ones((), dtype=torch.float32, device=dev)
        is_trunc_frac = torch.zeros((), dtype=torch.float32, device=dev)
    pg = -(obj * mask).sum() / denom

    kl = torch.zeros((), dtype=torch.float32, device=dev)
    if ref_logprobs is not None and kl_coef:
        # k3 estimator: exp(ref-new) - (ref-new) - 1  (nonnegative, unbiased)
        d = ref_logprobs - new_logprobs
        kl = ((torch.exp(d) - d - 1.0) * mask).sum() / denom
    ent = ((entropy * mask).sum() / denom if entropy is not None
           else torch.zeros((), dtype=torch.float32, device=dev))
    loss = pg + kl_coef * kl - ent_coef * ent
    clip_frac = (((ratio - 1.0).abs() > clip_eps) * mask).sum() / denom
    return GRPOOut(loss=loss, pg_loss=pg, kl=kl, entropy=ent,
                   ratio_mean=(ratio * mask).sum() / denom,
                   clip_frac=clip_frac,
                   is_weight_mean=is_weight_mean,
                   is_trunc_frac=is_trunc_frac)
