"""Supervised warmup (SFT) — teacher-forced cross-entropy on verified
answers (port of ``repro.train.sft``). RLVR assumes a pretrained base
policy (the paper fine-tunes Qwen3); base models here are random-init, so
examples and tests warm the base up on the task format first, then GRPO
lifts the verifiable reward — the same two-stage shape as the paper's
pipeline."""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.lora.adapters import single_ctx
from repro_torch.models import forward_seq, vocab_matrix
from repro_torch.rl.grpo import token_logprobs_chunked
from .optimizer import AdamWConfig, adamw_init, adamw_update
from .train_step import _completion_mask, value_and_grad


def make_sft_step(cfg: ModelConfig, adamw: AdamWConfig,
                  trainable: str = "full"):
    """SFT on (tokens, loss positions). trainable: full | lora.
    sft_step(base_params, tree, opt_state, batch) -> (tree, opt_state,
    {"loss", "grad_norm"})."""

    def loss_fn(tree, base_params, batch):
        if trainable == "lora":
            params, lora = base_params, single_ctx(tree, cfg)
        else:
            params, lora = tree, None
        tokens = batch["tokens"]
        S = tokens.shape[1]
        h, _, _ = forward_seq(params, tokens, cfg, lora, None)
        lp, _ = token_logprobs_chunked(h[:, :-1], vocab_matrix(params, cfg),
                                       tokens[:, 1:], cfg.logit_softcap)
        mask = _completion_mask(batch["prompt_lens"], batch["total_lens"],
                                S - 1)
        loss = -(lp * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        return loss, {}

    def sft_step(base_params, tree, opt_state, batch):
        loss, _, grads = value_and_grad(loss_fn, tree, base_params, batch)
        with torch.no_grad():
            tree, opt_state, gnorm = adamw_update(tree, grads, opt_state, adamw)
        return tree, opt_state, {"loss": loss, "grad_norm": gnorm}

    return sft_step


def sft_init(params_or_lora):
    return adamw_init(params_or_lora)
