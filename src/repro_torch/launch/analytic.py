"""Analytic roofline model — exact algorithmic FLOPs / HBM bytes /
collective bytes per (arch × shape × mesh) step.

WHY ANALYTIC: XLA's HloCostAnalysis visits `while` bodies ONCE — measured
on this box: a 40-layer lax.scan model reports the same flops as a 4-layer
one (experiment recorded in EXPERIMENTS.md §Roofline). Our production
stacks scan over layers, microbatches, query chunks and vocab chunks, so
raw cost_analysis() under-counts train cells by 1–2 orders of magnitude.
The roofline terms are therefore derived from the model/sharding structure
(known exactly); the compiled artifact remains the source for:
proof-of-compile, memory_analysis(), the collective op inventory, and
cross-validation on small unrolled variants where cost_analysis is exact.

A copy of ``repro.launch.analytic``, which holds no JAX: the port keeps its
own so that it imports nothing of the JAX package; only the import of the
configs differs. ``launch.roofline`` turns these FLOPs into shares of the
card's peak.

Conventions:
- 2 FLOPs per MAC (consistent with MODEL_FLOPS = 6·N·D).
- collective_bytes is Σ over chips of bytes moved through each chip
  (ring algorithms): AR = 2·T_local·(g−1)/g, AG/RS/A2A = T_local·(g−1)/g,
  where T_local is the per-chip shard. The roofline then divides by
  (chips × link_bw), i.e. per-chip traffic / per-chip link bandwidth.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import ModelConfig, ShapeConfig

BF16 = 2
F32 = 4


# ---------------------------------------------------------------------------
# forward FLOPs per token (model structure, exact)
# ---------------------------------------------------------------------------

def _layer_matmul_params(cfg: ModelConfig, kind: str) -> float:
    """Active matmul weights touched per token in one layer of `kind`."""
    d = cfg.d_model
    attn = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    n_mats = 3 if cfg.mlp_act == "swiglu" else 2
    if kind == "dense":
        return attn + n_mats * d * cfg.d_ff
    if kind == "moe":
        m = cfg.moe
        act = (m.top_k + m.num_shared) * n_mats * d * m.expert_d_ff
        return attn + act + d * m.num_experts            # + router
    if kind in ("mamba", "mamba+attn"):
        s = cfg.ssm
        d_in = s.d_inner(d)
        nh = s.num_heads(d)
        base = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh) + d_in * d
        if kind == "mamba+attn":
            base += attn + n_mats * d * cfg.d_ff         # shared block
        return base
    raise ValueError(kind)


def fwd_flops_per_token(cfg: ModelConfig, ctx_len: float,
                        seq_mode: bool) -> float:
    """Forward FLOPs per token at (average) context ctx_len.
    seq_mode=True → sequence processing (train/prefill, SSD chunked);
    False → single-token decode (recurrent SSM step)."""
    total = 0.0
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        total += 2.0 * _layer_matmul_params(cfg, kind)
        if kind in ("dense", "moe") and cfg.num_heads:
            eff = ctx_len
            if cfg.sliding_window and not cfg.is_global_attn_layer(i):
                eff = min(ctx_len, cfg.sliding_window)
            total += 4.0 * eff * cfg.num_heads * cfg.head_dim
        elif kind == "mamba+attn":
            total += 4.0 * ctx_len * cfg.num_heads * cfg.head_dim
        if kind in ("mamba", "mamba+attn"):
            s = cfg.ssm
            nh = s.num_heads(cfg.d_model)
            state = 6.0 * nh * s.head_dim * s.state_dim   # update + output
            intra = (4.0 * s.chunk_size * nh * s.head_dim
                     if seq_mode else 0.0)                # SSD diag block
            total += state + intra
    if cfg.family == "encdec":
        # encoder over S/4 frames amortized per decoder token + cross-attn
        enc_per_tok = 0.25 * cfg.encoder_layers * (
            2.0 * _layer_matmul_params(cfg, "dense")
            + 4.0 * (ctx_len * 0.25) * cfg.num_heads * cfg.head_dim)
        xattn = cfg.num_layers * (
            2.0 * 2 * cfg.d_model * (cfg.q_dim + cfg.kv_dim)
            + 4.0 * (ctx_len * 0.25) * cfg.num_heads * cfg.head_dim)
        total += enc_per_tok + xattn
    total += 2.0 * cfg.d_model * cfg.vocab_size           # logits
    return total


# ---------------------------------------------------------------------------
# per-step analytic terms
# ---------------------------------------------------------------------------

@dataclass
class AnalyticTerms:
    flops: float
    hbm_bytes: float
    collective_bytes: float
    notes: str = ""

    def as_dict(self):
        return {"analytic_flops": self.flops,
                "analytic_hbm_bytes": self.hbm_bytes,
                "analytic_collective_bytes": self.collective_bytes,
                "analytic_notes": self.notes}


def _n_attn_layers(cfg: ModelConfig) -> int:
    return cfg._num_attn_layers()


def analytic_terms(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                   dp: int, tp: int, accum: int = 1,
                   vocab_parallel_loss: bool = False) -> AnalyticTerms:
    """Terms for the *implemented* schedule (see shardings.py)."""
    B, S = shape.global_batch, shape.seq_len
    P = cfg.param_count() * BF16
    d, V = cfg.d_model, cfg.vocab_size
    kv = B * (S * cfg.state_bytes_per_token(BF16)
              + cfg.state_bytes_fixed(BF16))

    def ar_per_chip(t_local, g):
        return 2.0 * t_local * (g - 1) / g if g > 1 else 0.0

    def ag_per_chip(t_local_out, g):
        return t_local_out * (g - 1) / g if g > 1 else 0.0

    if shape.kind == "decode":
        tokens = float(B)
        f = fwd_flops_per_token(cfg, S, seq_mode=False) * tokens
        hbm = P + kv + tokens * d * BF16 * 8 * cfg.num_layers / 8
        # TP activation reductions: 2 per layer over the (tiny) token batch
        t_local = max(tokens / dp, 1) * d * BF16
        per_chip = 2 * cfg.num_layers * ar_per_chip(t_local, tp)
        # seq-sharded KV decode (kv_heads % tp != 0): partial-softmax combine
        if cfg.num_kv_heads and cfg.num_kv_heads % tp != 0:
            per_chip += _n_attn_layers(cfg) * ar_per_chip(
                max(tokens / dp, 1) * cfg.q_dim * F32, tp)
        coll = per_chip * chips
        return AnalyticTerms(f, hbm, coll,
                             "decode: HBM = params + KV; one step")

    if shape.kind == "prefill":
        tokens = float(B) * S
        f = fwd_flops_per_token(cfg, S / 2, seq_mode=True) * tokens
        act = tokens * d * BF16 * 8 * cfg.num_layers / 8
        hbm = P + kv + act
        t_local = tokens / dp * d * BF16
        per_chip = 2 * cfg.num_layers * ar_per_chip(t_local, tp)
        coll = per_chip * chips
        return AnalyticTerms(f, hbm, coll, "prefill: avg ctx S/2")

    # train (LoRA GRPO): fwd + remat-refwd + dgrad; frozen-base wgrads skipped
    tokens = float(B) * S
    f = 3.0 * fwd_flops_per_token(cfg, S / 2, seq_mode=True) * tokens
    act = tokens * d * BF16 * (2 + 10) * cfg.num_layers / 8
    hbm = 3.0 * P * accum + act          # weights stream 3× per microbatch
    t_local = tokens / dp * d * BF16
    per_chip = 2 * cfg.num_layers * ar_per_chip(t_local, tp) * 2   # fwd+bwd
    # FSDP all-gather of tp-sharded weights per microbatch, fwd + bwd
    per_chip += 2 * accum * ag_per_chip(P / tp, dp)
    # loss-side vocab matmul. UNTIED archs are structurally vocab-parallel
    # (lm_head V-sharded: LSE/target psums are [tokens]-sized). TIED archs
    # reuse embed.T, which is d-sharded → baseline all-gathers the vocab
    # matrix per microbatch; the vocab-parallel iteration (§Perf B1)
    # reshards it once per micro (all-to-all, ~P_vocab/tp per chip).
    if not cfg.tie_embeddings or vocab_parallel_loss:
        per_chip += ar_per_chip(tokens / dp * F32, tp) * 2
        if vocab_parallel_loss and cfg.tie_embeddings:
            per_chip += accum * (d * V * BF16 / tp) * (tp - 1) / tp  # a2a
    else:
        per_chip += accum * ag_per_chip(d * V * BF16 / tp * (tp - 1), tp)
    # LoRA grad all-reduce over dp (adapters are tiny)
    lora_bytes = 4e6 * F32
    per_chip += ar_per_chip(lora_bytes, dp)
    coll = per_chip * chips
    return AnalyticTerms(f, hbm, coll,
                         "train: 3×fwd (fwd+remat+dgrad); LoRA-only wgrads")
