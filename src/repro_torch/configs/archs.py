"""The 10 assigned architectures (exact public configs) + the paper's own
Qwen3 models used in MARLaaS's experiments.

Sources are cited per entry; `[...; tier]` follows the assignment sheet.

A copy of ``repro.configs.archs``: the port keeps its own so that it imports nothing
of the JAX package.
"""
from __future__ import annotations

from .base import LoRAConfig, MoEConfig, ModelConfig, SSMConfig

# --------------------------------------------------------------------------
# Assigned pool (10 archs)
# --------------------------------------------------------------------------

GRANITE_3_2B = ModelConfig(
    # [hf:ibm-granite/granite-3.0-2b-base; hf]
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=49155, mlp_act="swiglu", rope_theta=10000.0,
)

QWEN15_110B = ModelConfig(
    # [hf:Qwen/Qwen1.5-*; hf] — QKV bias
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=49152, vocab_size=152064, mlp_act="swiglu", qkv_bias=True,
    rope_theta=1000000.0, tie_embeddings=False,
)

NEMOTRON_4_340B = ModelConfig(
    # [arXiv:2402.16819; unverified] — squared-ReLU MLP (no gating)
    name="nemotron-4-340b", family="dense",
    num_layers=96, d_model=18432, num_heads=96, num_kv_heads=8, head_dim=192,
    d_ff=73728, vocab_size=256000, mlp_act="squared_relu",
    tie_embeddings=False,
)

GEMMA2_27B = ModelConfig(
    # [arXiv:2408.00118; hf] — local/global alternation + logit softcaps
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000, mlp_act="swiglu",
    attn_softcap=50.0, logit_softcap=30.0,
    sliding_window=4096, local_global_period=2,
)

ZAMBA2_1P2B = ModelConfig(
    # [arXiv:2411.15242; hf] — Mamba2 backbone + ONE shared attn(+MLP) block.
    # The shared block carries per-invocation LoRA in the original — the same
    # mechanism MARLaaS uses for tenancy (see DESIGN.md §5).
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000, mlp_act="swiglu",
    ssm=SSMConfig(state_dim=64, head_dim=64, expand=2, n_groups=1),
    hybrid_attn_every=6,
)

DEEPSEEK_MOE_16B = ModelConfig(
    # [arXiv:2401.06066; hf] — fine-grained MoE: 2 shared + 64 routed top-6.
    # (We apply MoE at every layer; HF layer-0-dense detail noted in DESIGN.)
    name="deepseek-moe-16b", family="moe",
    num_layers=28, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=102400, mlp_act="swiglu", tie_embeddings=False,
    moe=MoEConfig(num_experts=64, top_k=6, num_shared=2, expert_d_ff=1408),
)

DBRX_132B = ModelConfig(
    # [hf:databricks/dbrx-base; unverified] — 16 experts top-4
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8, head_dim=128,
    d_ff=0, vocab_size=100352, mlp_act="swiglu",
    moe=MoEConfig(num_experts=16, top_k=4, num_shared=0, expert_d_ff=10752),
    rope_theta=500000.0, tie_embeddings=False,
)

MAMBA2_780M = ModelConfig(
    # [arXiv:2405.21060; unverified] — pure SSD stack, attention-free
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0, head_dim=0,
    d_ff=0, vocab_size=50280,
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, n_groups=1),
    lora=LoRAConfig(targets=("ssm_in", "ssm_out")),
)

SEAMLESS_M4T_LARGE_V2 = ModelConfig(
    # [arXiv:2308.11596; hf] — enc-dec backbone; audio frontend is a stub
    # (input_specs() provides precomputed frame embeddings).
    name="seamless-m4t-large-v2", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=8192, vocab_size=256206, mlp_act="gelu",
    encoder_layers=24, frontend="audio", tie_embeddings=False,
)

CHAMELEON_34B = ModelConfig(
    # [arXiv:2405.09818; unverified] — early-fusion; VQ image tokens are
    # ordinary ids in the 65536 vocab; qk-norm per the paper.
    name="chameleon-34b", family="vlm",
    num_layers=48, d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=22016, vocab_size=65536, mlp_act="swiglu", qk_norm=True,
    frontend="vision", tie_embeddings=False,
)

# --------------------------------------------------------------------------
# The paper's own base models (MARLaaS §5: Qwen3-0.6B / 14B / 32B)
# --------------------------------------------------------------------------

QWEN3_0P6B = ModelConfig(
    name="qwen3-0.6b", family="dense",
    num_layers=28, d_model=1024, num_heads=16, num_kv_heads=8, head_dim=128,
    d_ff=3072, vocab_size=151936, mlp_act="swiglu", qk_norm=True,
    rope_theta=1000000.0,
)

QWEN3_14B = ModelConfig(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab_size=151936, mlp_act="swiglu", qk_norm=True,
    rope_theta=1000000.0, tie_embeddings=False,
)

QWEN3_32B = ModelConfig(
    name="qwen3-32b", family="dense",
    num_layers=64, d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
    d_ff=25600, vocab_size=151936, mlp_act="swiglu", qk_norm=True,
    rope_theta=1000000.0, tie_embeddings=False,
)

ASSIGNED = (
    GRANITE_3_2B, QWEN15_110B, NEMOTRON_4_340B, GEMMA2_27B, ZAMBA2_1P2B,
    DEEPSEEK_MOE_16B, DBRX_132B, MAMBA2_780M, SEAMLESS_M4T_LARGE_V2,
    CHAMELEON_34B,
)

PAPER_MODELS = (QWEN3_0P6B, QWEN3_14B, QWEN3_32B)

REGISTRY = {c.name: c for c in ASSIGNED + PAPER_MODELS}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]
