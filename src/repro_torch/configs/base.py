"""Configuration system for the MARLaaS reproduction framework.

Every selectable architecture is described by a frozen ``ModelConfig``; input
shapes by ``ShapeConfig``. Configs are *data* — model code interprets them.

Conventions
-----------
- ``family`` selects the block stack:
    dense   — uniform decoder-only transformer
    moe     — decoder-only with (shared + routed) MoE MLPs
    ssm     — attention-free Mamba2 (SSD) stack
    hybrid  — Mamba2 backbone with a single *shared* attention block applied
              every ``hybrid_attn_every`` layers (Zamba2 style)
    encdec  — encoder-decoder transformer (seamless backbone; stub frontend)
    vlm     — decoder-only, early-fusion (VQ image tokens are ordinary ids)
- All per-layer weights are stacked on a leading layer axis (the JAX
  package scans over it; the port loops over it).

A copy of ``repro.configs.base``: the port keeps its own so that it imports nothing
of the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int            # routed experts
    top_k: int
    num_shared: int = 0         # always-on shared experts (fused into one MLP)
    expert_d_ff: int = 0        # per-expert hidden size (fine-grained MoE)
    capacity_factor: float = 1.25
    router_noise: float = 0.0


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 128        # N
    head_dim: int = 64          # P
    expand: int = 2             # d_inner = expand * d_model
    n_groups: int = 1           # B/C groups (shared across heads)
    conv_width: int = 4
    chunk_size: int = 256       # SSD chunk length (training/prefill)
    dt_min: float = 0.001
    dt_max: float = 0.1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def num_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # which projections receive adapters
    targets: Tuple[str, ...] = ("attn_q", "attn_k", "attn_v", "attn_o",
                                "mlp_in", "mlp_out")
    dtype: str = "float32"

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int = 0          # 0 for attention-free stacks
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0               # dense MLP hidden (0 for pure-MoE / ssm)
    vocab_size: int = 32000

    # --- attention variants ---
    qkv_bias: bool = False                  # qwen1.5
    qk_norm: bool = False                   # chameleon
    attn_softcap: float = 0.0               # gemma2 (tanh softcap on scores)
    logit_softcap: float = 0.0              # gemma2 (tanh softcap on lm logits)
    sliding_window: int = 0                 # gemma2 local layers
    local_global_period: int = 0            # gemma2: every Nth layer is global
    rope_theta: float = 10000.0

    # --- MLP variants ---
    mlp_act: str = "swiglu"                 # swiglu | squared_relu | gelu

    # --- MoE ---
    moe: Optional[MoEConfig] = None

    # --- SSM / hybrid ---
    ssm: Optional[SSMConfig] = None
    hybrid_attn_every: int = 0              # zamba2: shared attn every N blocks

    # --- enc-dec ---
    encoder_layers: int = 0                 # seamless: separate encoder stack
    frontend: str = ""                      # "audio" | "vision" | "" (stub kind)

    # --- misc ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    scan_layers: bool = True                # lax.scan over the layer stack
    remat: bool = True                      # checkpoint each scan body
    remat_block: int = 0                    # >0: two-level remat — outer scan
                                            # over L/remat_block blocks stores
                                            # only block inputs (deep stacks)

    lora: LoRAConfig = field(default_factory=LoRAConfig)

    # ------------------------------------------------------------------
    def __post_init__(self):
        if self.num_heads and not self.head_dim:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """True if decode state does NOT grow with a dense global KV cache."""
        return self.family in ("ssm", "hybrid")

    def layer_kind(self, i: int) -> str:
        """Block kind at depth i (used by heterogeneous stacks)."""
        if self.family == "ssm":
            return "mamba"
        if self.family == "hybrid":
            k = self.hybrid_attn_every
            return "mamba+attn" if (k and (i + 1) % k == 0) else "mamba"
        if self.family == "moe":
            return "moe"
        return "dense"

    def is_global_attn_layer(self, i: int) -> bool:
        """Gemma2-style alternation: layer i uses global (non-windowed) attn."""
        if not self.local_global_period:
            return True
        return (i % self.local_global_period) == (self.local_global_period - 1)

    # --- memory model used by KV-cache-aware admission (paper §4.3) -----
    def state_bytes_per_token(self, dtype_bytes: int = 2) -> int:
        """Per-token, per-sequence KV bytes (attention archs)."""
        n_attn = self._num_attn_layers()
        return 2 * n_attn * self.kv_dim * dtype_bytes

    def state_bytes_fixed(self, dtype_bytes: int = 2) -> int:
        """Sequence-length-independent state (SSM recurrent state + conv)."""
        if self.ssm is None:
            return 0
        s = self.ssm
        d_in = s.d_inner(self.d_model)
        n_heads = s.num_heads(self.d_model)
        n_ssm = self._num_ssm_layers()
        ssm_state = n_heads * s.head_dim * s.state_dim
        conv_state = (d_in + 2 * s.n_groups * s.state_dim) * s.conv_width
        return n_ssm * (ssm_state + conv_state) * dtype_bytes

    def _num_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            k = self.hybrid_attn_every
            return (self.num_layers // k) if k else 0
        if self.family == "encdec":
            # decoder self-attn + cross-attn caches
            return 2 * self.num_layers
        return self.num_layers

    def _num_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.num_layers
        if self.family == "hybrid":
            return self.num_layers
        return 0

    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D roofline checks)."""
        d = self.d_model
        emb = self.vocab_size * d
        total = emb if self.tie_embeddings else 2 * emb
        dec_layers = self.num_layers

        def attn_params() -> int:
            p = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
            if self.qkv_bias:
                p += self.q_dim + 2 * self.kv_dim
            return p

        def dense_mlp(ff: int) -> int:
            n_mats = 3 if self.mlp_act == "swiglu" else 2
            return n_mats * d * ff

        def mamba_params() -> int:
            s = self.ssm
            d_in = s.d_inner(d)
            nh = s.num_heads(d)
            conv_dim = d_in + 2 * s.n_groups * s.state_dim
            in_proj = d * (2 * d_in + 2 * s.n_groups * s.state_dim + nh)
            return (in_proj + conv_dim * s.conv_width + 2 * nh
                    + d_in + d_in * d)

        for i in range(dec_layers):
            kind = self.layer_kind(i)
            total += 2 * d  # pre-norms
            if kind == "dense":
                total += attn_params() + dense_mlp(self.d_ff)
            elif kind == "moe":
                m = self.moe
                total += attn_params()
                total += m.num_experts * dense_mlp(m.expert_d_ff)
                total += m.num_shared * dense_mlp(m.expert_d_ff)
                total += d * m.num_experts  # router
            elif kind in ("mamba", "mamba+attn"):
                total += mamba_params()
        if self.family == "hybrid" and self.hybrid_attn_every:
            # ONE shared attention(+MLP) block, counted once
            total += attn_params() + dense_mlp(self.d_ff) + 2 * d
        if self.family == "encdec":
            for _ in range(self.encoder_layers):
                total += attn_params() + dense_mlp(self.d_ff) + 2 * d
            # decoder cross-attention
            total += dec_layers * attn_params()
        return total

    def active_param_count(self) -> int:
        """Activated params per token (MoE: shared + top_k routed only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        full = self.param_count()
        n_mats = 3 if self.mlp_act == "swiglu" else 2
        per_expert = n_mats * self.d_model * m.expert_d_ff
        inactive = self.num_layers * (m.num_experts - m.top_k) * per_expert
        return full - inactive


@dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape × step-kind) cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # train | prefill | decode
    # decode: seq_len is the KV-cache length; one new token is generated.


TRAIN_4K = ShapeConfig("train_4k", 4096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524288, 1, "decode")

LM_SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)


def shapes_for(cfg: ModelConfig) -> Tuple[ShapeConfig, ...]:
    """Applicable shape cells for an architecture.

    ``long_500k`` requires sub-quadratic decode state; pure full-attention
    archs (incl. gemma2, whose *global* layers are dense attention) skip it —
    see DESIGN.md §5.
    """
    out = []
    for s in LM_SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return tuple(out)


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    base = dict(
        num_layers=2,
        d_model=64,
        num_heads=4 if cfg.num_heads else 0,
        num_kv_heads=min(cfg.num_kv_heads, 2) if cfg.num_kv_heads else 0,
        head_dim=16 if cfg.num_heads else 0,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        scan_layers=cfg.scan_layers,
        remat=False,
    )
    if cfg.moe is not None:
        base["moe"] = MoEConfig(num_experts=4, top_k=2,
                                num_shared=min(cfg.moe.num_shared, 1),
                                expert_d_ff=64)
    if cfg.ssm is not None:
        base["ssm"] = SSMConfig(state_dim=16, head_dim=16, expand=2,
                                n_groups=1, conv_width=4, chunk_size=32)
    if cfg.family == "hybrid":
        base["hybrid_attn_every"] = 2
        base["num_heads"] = 4
        base["num_kv_heads"] = 4
        base["head_dim"] = 16  # must be d_inner-compatible? attn is on d_model
        base["d_ff"] = 128
    if cfg.family == "encdec":
        base["encoder_layers"] = 2
    if cfg.local_global_period:
        base["local_global_period"] = 2
        base["sliding_window"] = 16
    base["lora"] = LoRAConfig(rank=4, alpha=8.0, targets=cfg.lora.targets)
    base.update(overrides)
    return dataclasses.replace(cfg, **base)
