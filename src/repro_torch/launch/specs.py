"""Input shapes and step builders for every (arch × shape) cell (port of
``repro.launch.specs``).

The shape trees are tensors on the meta device, where the JAX package has
``jax.ShapeDtypeStruct``s from ``jax.eval_shape``: params, LoRA adapters,
optimizer state and caches come from the port's own init functions on
``device="meta"``, which draw nothing and allocate nothing, so even
nemotron-4-340b's tree costs no memory.

Serving cells (prefill/decode) are multi-LoRA with NUM_TENANTS adapters and
per-row task ids — the paper's §4.5 rollout configuration. The train cell is
the paper-faithful LoRA GRPO PolicyUpdate (single task, frozen base).

Modality frontends are stubs: seamless (audio) cells take precomputed frame
embeddings [B, S_enc, d] (S_enc = S // 4); chameleon (vlm) consumes VQ image
tokens as ordinary ids. These step builders are how the port serves the
encdec family, which the rollout engines refuse (``rollout.engine``'s
``refuse_encdec``).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict

import torch

from repro_torch.configs import ModelConfig, ShapeConfig
from repro_torch.lora.adapters import batched_ctx, init_lora, stack_adapters
from repro_torch.models import (decode_step, forward_seq, init_cache,
                                init_params, lm_logits)
from repro_torch.models.common import dtype_of
from repro_torch.train.optimizer import AdamWConfig, adamw_init
from repro_torch.train.train_step import TrainConfig, make_train_step

NUM_TENANTS = 8          # multi-LoRA tenants in serving cells
GROUP_SIZE = 8           # GRPO group size in the train cell

# per-arch gradient-accumulation (microbatch) so remat-stored layer inputs
# fit HBM at train_4k; key: rows per microbatch (the JAX package's values)
MICRO_ROWS = {
    "nemotron-4-340b": 8, "qwen1.5-110b": 16, "dbrx-132b": 16,
    "chameleon-34b": 16, "gemma2-27b": 16, "qwen3-32b": 16, "qwen3-14b": 32,
    "deepseek-moe-16b": 32,
}
DEFAULT_MICRO_ROWS = 32

_META = torch.device("meta")


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def eval_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """Shape trees for params / single-task LoRA / stacked multi-LoRA / opt,
    on the meta device."""
    params = init_params(cfg, None, _META)
    lora = init_lora(cfg, None, _META)
    lora_stacked = stack_adapters([init_lora(cfg, None, _META)
                                   for _ in range(NUM_TENANTS)])
    return {"params": params, "lora": lora, "lora_stacked": lora_stacked,
            "opt": adamw_init(lora)}


def accum_steps(cfg: ModelConfig, shape: ShapeConfig) -> int:
    rows = int(os.environ.get("REPRO_MICRO_ROWS", 0)) or \
        MICRO_ROWS.get(cfg.name, DEFAULT_MICRO_ROWS)
    return max(1, shape.global_batch // rows)


def maybe_remat_block(cfg: ModelConfig) -> ModelConfig:
    """Apply the REPRO_REMAT_BLOCK knob (two-level remat, see
    ``models.forward_seq``)."""
    blk = int(os.environ.get("REPRO_REMAT_BLOCK", 0))
    return dataclasses.replace(cfg, remat_block=blk) if blk else cfg


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    R, S = shape.global_batch, shape.seq_len
    b = {"tokens": _spec((R, S), torch.int32),
         "prompt_lens": _spec((R,), torch.int32),
         "total_lens": _spec((R,), torch.int32),
         "rewards": _spec((R,), torch.float32)}
    if cfg.family == "encdec":
        b["enc_embeds"] = _spec((R, S // 4, cfg.d_model), dtype_of(cfg.dtype))
    return b


def serve_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    enc_len = S // 4 if cfg.family == "encdec" else 0
    out = {"cache": init_cache(cfg, B, S, enc_len=enc_len, device=_META),
           "row_ids": _spec((B,), torch.int32)}
    if shape.kind == "prefill":
        out["tokens"] = _spec((B, S), torch.int32)
        out["prompt_lens"] = _spec((B,), torch.int32)
        if cfg.family == "encdec":
            out["enc_embeds"] = _spec((B, enc_len, cfg.d_model),
                                      dtype_of(cfg.dtype))
    else:
        out["cur_tokens"] = _spec((B,), torch.int32)
    return out


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def build_train_step(cfg: ModelConfig, shape: ShapeConfig, *,
                     use_logprob_kernel: bool = True):
    """The LoRA GRPO step of the train cell: ``make_train_step(base_params,
    lora, opt_state, batch)`` at GROUP_SIZE and the cell's micro-batching,
    under REPRO_REMAT_BLOCK. The policy logprobs go through the fused
    ``token_logprob`` kernel, forward and backward (its plain version on the
    CPU), where the JAX package's step takes its chunked path: ``jax.grad``
    cannot pass through its Pallas kernel (ROADMAP §3). The two agree.
    ``use_logprob_kernel=False`` takes the chunked path (the dry run's: on
    the meta device no kernel launches, and it is the path the JAX
    package's dry run lowers)."""
    cfg = maybe_remat_block(cfg)
    tc = TrainConfig(group_size=GROUP_SIZE,
                     accum_steps=accum_steps(cfg, shape),
                     use_logprob_kernel=use_logprob_kernel,
                     adamw=AdamWConfig())
    return make_train_step(cfg, tc)


def build_prefill_step(cfg: ModelConfig):
    """prefill_step(params, adapters, row_ids, tokens, prompt_lens, cache,
    enc_embeds=None) -> (logits at each row's last prompt token [B, V],
    cache): a multi-LoRA prefill (``adapters`` task-stacked, ``row_ids`` [B]
    int32) that writes the cache in place (encdec's cross-attention memory
    too) and sets its ``pos`` to the prompt lengths."""
    @torch.no_grad()
    def prefill_step(params, adapters, row_ids, tokens, prompt_lens, cache,
                     enc_embeds=None):
        lora = batched_ctx(adapters, row_ids, cfg)
        h, cache, _ = forward_seq(params, tokens, cfg, lora, cache,
                                  enc_embeds=enc_embeds)
        cache = dict(cache, pos=prompt_lens.to(torch.int32))
        rows = torch.arange(h.shape[0], device=h.device)
        last = h[rows, prompt_lens.long() - 1]
        return lm_logits(last, params, cfg), cache
    return prefill_step


def build_decode_step(cfg: ModelConfig):
    """serve_step(params, adapters, row_ids, cur_tokens, cache) -> (logits
    [B, V], cache): one multi-LoRA decode step over the dense cache."""
    @torch.no_grad()
    def serve_step(params, adapters, row_ids, cur_tokens, cache):
        lora = batched_ctx(adapters, row_ids, cfg)
        return decode_step(params, cur_tokens, cache, cfg, lora)
    return serve_step
