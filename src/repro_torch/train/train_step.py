"""PolicyUpdate (paper Algorithm 1, line 14): one GRPO update for one task
(port of ``repro.train.train_step``).

``make_train_step`` builds the update used by the training engine. The
paper-faithful mode differentiates ONLY the task's LoRA adapters
(θ_t^(v) → θ_t^(v+1)) against the frozen shared base model; optimizer state
is the task's φ_t^(v). ``trainable="full"`` exists as a baseline.

Where the JAX package takes ``jax.value_and_grad`` of the loss, the port
runs the loss forward with grad on for the trainable leaves and takes
``torch.autograd.grad``; gradient accumulation loops over micro-batches
(``accum_steps``) where the JAX package scans. The policy and reference
logprobs go through the fused ``token_logprob`` kernel (forward and
backward) under ``use_logprob_kernel``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from repro_torch.configs import ModelConfig
from repro_torch.lora.adapters import single_ctx
from repro_torch.models import (forward_seq, tree_leaves, tree_unflatten,
                                vocab_matrix)
from repro_torch.models.common import LoraCtx, resolve_device
from repro_torch.rl.grpo import (group_advantages, grpo_loss,
                                 token_logprobs_chunked)
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .sharding import constrain, fit_split

METRIC_KEYS = ("loss", "pg_loss", "kl", "entropy", "ratio_mean", "clip_frac",
               "aux", "is_weight_mean", "is_trunc_frac")


@dataclass(frozen=True)
class TrainConfig:
    group_size: int = 8
    clip_eps: float = 0.2
    kl_coef: float = 0.0
    ent_coef: float = 0.0
    accum_steps: int = 1
    recompute_old: bool = True       # recompute behavior logprobs under the
                                     # training forward (MoE-drop safe)
    is_cap: float = 0.0              # decoupled-PPO importance-weight cap
                                     # for off-policy (stale) batches:
                                     # ρ = min(exp(old_lp − behavior_lp),
                                     # is_cap) reweights the clipped
                                     # objective. 0 disables the correction
    trainable: str = "lora"          # lora | full
    use_logprob_kernel: bool = False
    adamw: AdamWConfig = field(default_factory=AdamWConfig)


def _completion_mask(prompt_lens, total_lens, S):
    idx = torch.arange(S, device=prompt_lens.device)[None, :]
    lo = (prompt_lens - 1)[:, None]
    hi = (total_lens - 1)[:, None]
    return ((idx >= lo) & (idx < hi)).float()


def _policy_logprobs(params, tokens, cfg: ModelConfig,
                     lora: Optional[LoraCtx], tc: TrainConfig,
                     enc_embeds=None):
    """Token logprobs [R, S-1] for predicting tokens[:, 1:] (+ entropy,
    aux); encdec's rows come with their frontend embeddings."""
    h, _, aux = forward_seq(params, tokens, cfg, lora, None,
                            enc_embeds=enc_embeds)
    vocab_w = vocab_matrix(params, cfg)
    if cfg.tie_embeddings:
        # tied: embed.T is d-sharded; reshard to V-sharded ONCE per
        # micro-batch (one all-to-all of the table) so the LSE/gather run
        # vocab-parallel instead of all-gathering the matrix per chunk
        vocab_w = constrain(vocab_w, None, "tp")
    lp, ent = token_logprobs_chunked(h[:, :-1], vocab_w, tokens[:, 1:],
                                     cfg.logit_softcap,
                                     use_kernel=tc.use_logprob_kernel)
    return lp, ent, aux


def make_loss_fn(cfg: ModelConfig, tc: TrainConfig):
    """loss_fn(trainable_tree, base_params, batch) -> (loss, metrics)."""

    def loss_fn(trainable_tree, base_params, batch):
        if tc.trainable == "lora":
            params = base_params
            lora = single_ctx(trainable_tree, cfg)
        else:
            params = trainable_tree
            lora = None
        tokens = batch["tokens"]
        R, S = tokens.shape
        if R % tc.group_size:
            raise ValueError(f"{R} rows do not form groups of {tc.group_size}")
        mask = _completion_mask(batch["prompt_lens"], batch["total_lens"],
                                S)[:, :S - 1]
        if "loss_mask" in batch:  # env/tool-provided tokens carry no loss
            mask = mask * batch["loss_mask"][:, :S - 1]
        adv = group_advantages(batch["rewards"], tc.group_size)

        enc = batch.get("enc_embeds")
        new_lp, ent, aux = _policy_logprobs(params, tokens, cfg, lora, tc,
                                            enc)
        if tc.recompute_old or "behavior_logprobs" not in batch:
            old_lp = new_lp.detach()
        else:
            old_lp = batch["behavior_logprobs"]
        ref_lp = None
        if tc.kl_coef:
            with torch.no_grad():
                ref_lp, _, _ = _policy_logprobs(params, tokens, cfg, None, tc,
                                                enc)
        # off-policy correction: the behaviour logprobs recorded at sample
        # time enter ONLY as the truncated importance weight; the clip ratio
        # stays anchored to the recomputed (proximal) old_lp
        behavior = batch.get("behavior_logprobs") if tc.is_cap > 0 else None
        out = grpo_loss(new_lp, old_lp, adv, mask, ref_lp,
                        clip_eps=tc.clip_eps, kl_coef=tc.kl_coef,
                        entropy=ent, ent_coef=tc.ent_coef,
                        behavior_logprobs=behavior, is_cap=tc.is_cap)
        loss = out.loss + 0.01 * aux          # MoE load-balance aux
        metrics = {"loss": out.loss, "pg_loss": out.pg_loss, "kl": out.kl,
                   "entropy": out.entropy, "ratio_mean": out.ratio_mean,
                   "clip_frac": out.clip_frac, "aux": aux,
                   "is_weight_mean": out.is_weight_mean,
                   "is_trunc_frac": out.is_trunc_frac}
        return loss, metrics

    return loss_fn


def value_and_grad(loss_fn, tree, *args):
    """(loss, aux, grads) of ``loss_fn(tree, *args) -> (loss, aux)`` with
    respect to every tensor leaf of `tree` (the counterpart of
    ``jax.value_and_grad(..., has_aux=True)``). Leaves are detached copies
    that require grad, so the caller's tensors are untouched."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    with torch.enable_grad():
        loss, aux = loss_fn(tree_unflatten(tree, leaves), *args)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    aux = {k: v.detach() for k, v in aux.items()}
    return loss.detach(), aux, tree_unflatten(tree, grads)


def make_grad_fn(cfg: ModelConfig, tc: TrainConfig):
    """grad_fn(base_params, trainable_tree, batch) -> (metrics, grads): the
    loss and grads of one step before the optimizer, micro-batches
    averaged."""
    loss_fn = make_loss_fn(cfg, tc)

    def grad_fn(base_params, trainable, batch):
        A = tc.accum_steps
        if A == 1:
            _, metrics, grads = value_and_grad(loss_fn, trainable, base_params,
                                               batch)
            return metrics, grads
        R = batch["tokens"].shape[0]
        if R % A:
            raise ValueError(f"{R} rows do not split into {A} micro-batches")
        n = R // A
        # rows split over more ranks than a micro-batch has rows are made
        # whole first (DTensor cannot fold them back after a matmul)
        batch = {k: fit_split(v, 0, n, note="micro_rows")
                 for k, v in batch.items()}
        g_acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device)
                 for t in tree_leaves(trainable)]
        m_acc = {k: 0.0 for k in METRIC_KEYS}
        for i in range(A):
            mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
            _, m, g = value_and_grad(loss_fn, trainable, base_params, mb)
            g_acc = [a + b.float() for a, b in zip(g_acc, tree_leaves(g))]
            m_acc = {k: m_acc[k] + m[k] for k in METRIC_KEYS}
        grads = tree_unflatten(trainable, [g / A for g in g_acc])
        return {k: v / A for k, v in m_acc.items()}, grads

    return grad_fn


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """Returns train_step(base_params, lora, opt_state, batch) ->
    (new_lora, new_opt_state, metrics). batch keys (tensors on the device
    the parameters live on):
      tokens [R, S] int32, prompt_lens [R], total_lens [R], rewards [R],
      loss_mask [R, S] (optional), behavior_logprobs [R, S-1] (optional),
      enc_embeds [R, S_enc, d] (encdec only).
    R = num_groups * tc.group_size; groups contiguous. With
    trainable="full" the base parameters are updated and returned in place
    of the adapters."""
    grad_fn = make_grad_fn(cfg, tc)

    def train_step(base_params, lora_tree, opt_state, batch):
        trainable = lora_tree if tc.trainable == "lora" else base_params
        metrics, grads = grad_fn(base_params, trainable, batch)
        with torch.no_grad():
            new_trainable, new_opt, gnorm = adamw_update(trainable, grads,
                                                         opt_state, tc.adamw)
        metrics["grad_norm"] = gnorm
        metrics["reward_mean"] = batch["rewards"].mean()
        return new_trainable, new_opt, metrics

    return train_step


def init_opt_state(cfg: ModelConfig, tc: TrainConfig, base_params, lora_tree):
    return adamw_init(lora_tree if tc.trainable == "lora" else base_params)


def batch_from_trajectory(tb, tc: TrainConfig,
                          device="cuda") -> Dict[str, torch.Tensor]:
    """A ``TrajectoryBatch`` as the step's batch on `device`, built as the
    JAX runtime's trainer builds it: the loss mask when the batch carries
    one, the behaviour logprobs only when the importance weight is on."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    batch = {"tokens": t(tb.tokens, torch.int32),
             "prompt_lens": t(tb.prompt_lens, torch.int32),
             "total_lens": t(tb.total_lens, torch.int32),
             "rewards": t(tb.rewards, torch.float32)}
    if "loss_mask" in tb.meta:
        batch["loss_mask"] = t(tb.meta["loss_mask"], torch.float32)
    if tc.is_cap > 0 and tb.behavior_logprobs is not None:
        batch["behavior_logprobs"] = t(tb.behavior_logprobs, torch.float32)
    return batch
