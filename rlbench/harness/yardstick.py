"""The benchmark's yardstick: the card's peaks and the operations and bytes
of the work it measures, frozen here so that a change to the program cannot
move them.

The FLOP arithmetic is a copy of the dense branch of
``repro_torch.launch.analytic`` (``_layer_matmul_params``,
``fwd_flops_per_token``: 2 FLOPs a multiply-add, 4·ctx·H·hd of attention a
token and layer, the logits); ``tests/test_rlbench_yardstick.py`` holds the
two equal at the cells' shapes. The peaks are NVIDIA's data sheet for the
H100 SXM, dense rates without sparsity: 989e12 FLOP/s in bf16, 3.35e12 B/s
of HBM3.

A kernel's bound time is the larger of its operations over the FLOP peak and
its bytes over the bandwidth peak, at the shapes of each call; each input
byte is counted once and each output byte once, whatever the kernel reads
again. Where the bytes a call needs depend on data the host does not hold
(which adapter slots a prefill's rows use), the count takes the least they
can be, so that a share of the bound is never overstated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

PEAK_FLOPS_BF16 = 989e12        # H100 SXM, dense bf16 (data sheet)
PEAK_HBM_BYTES = 3.35e12        # H100 SXM, HBM3 (data sheet)

BF16 = 2
F32 = 4


@dataclass(frozen=True)
class Shape:
    """The widths of a dense decoder as the configuration file states them."""
    layers: int
    d: int
    heads: int
    kv_heads: int
    head_dim: int
    ff: int
    vocab: int
    lora_rank: int
    lora_targets: Tuple[str, ...]

    @property
    def q_dim(self) -> int:
        return self.heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.kv_heads * self.head_dim

    def target_dims(self, target: str) -> Tuple[int, int]:
        """(d_in, d_out) of an adapted projection."""
        return {"attn_q": (self.d, self.q_dim),
                "attn_k": (self.d, self.kv_dim),
                "attn_v": (self.d, self.kv_dim),
                "attn_o": (self.q_dim, self.d),
                "mlp_in": (self.d, 2 * self.ff),
                "mlp_out": (self.ff, self.d)}[target]


def layer_matmul_params(s: Shape) -> float:
    """Matmul weights a token touches in one dense swiglu layer."""
    attn = s.d * s.q_dim + 2 * s.d * s.kv_dim + s.q_dim * s.d
    return attn + 3 * s.d * s.ff


def fwd_flops_per_token(s: Shape, ctx_len: float) -> float:
    """Forward FLOPs of one token at context `ctx_len`, logits included."""
    per_layer = 2.0 * layer_matmul_params(s) + 4.0 * ctx_len * s.heads * s.head_dim
    return s.layers * per_layer + 2.0 * s.d * s.vocab


def lora_flops_per_token(s: Shape) -> float:
    """Forward FLOPs of one token through the adapters of every layer."""
    return s.layers * sum(2.0 * s.lora_rank * (a + b) for a, b in
                          (s.target_dims(t) for t in s.lora_targets))


def decode_flops(s: Shape, rows: int, ctx_sum: float) -> float:
    """One decode step: `rows` tokens whose contexts sum to `ctx_sum`."""
    base = fwd_flops_per_token(s, 0.0) + lora_flops_per_token(s)
    return rows * base + ctx_sum * s.layers * 4.0 * s.heads * s.head_dim


def seq_flops(s: Shape, start: int, end: int) -> float:
    """Forward FLOPs of positions [start, end) of one sequence, each at its
    own causal context (position p attends over p + 1 keys)."""
    n = end - start
    if n <= 0:
        return 0.0
    ctx_sum = (start + end + 1) * n / 2.0
    base = fwd_flops_per_token(s, 0.0) + lora_flops_per_token(s)
    return n * base + ctx_sum * s.layers * 4.0 * s.heads * s.head_dim


def train_flops(s: Shape, lengths: Sequence[int]) -> float:
    """A LoRA GRPO step over rows of these lengths: the forward, the
    backward to the activations through the frozen base (as many FLOPs as
    the forward), and the adapters' weight gradients (as many as their
    forward). Recomputed operations are not counted."""
    total = 0.0
    for n in lengths:
        total += 2.0 * seq_flops(s, 0, n) + n * lora_flops_per_token(s)
    return total


def bound_s(flops: float, nbytes: float) -> float:
    """Least time the card could take for this work."""
    return max(flops / PEAK_FLOPS_BF16, nbytes / PEAK_HBM_BYTES)


# -- the kernels -------------------------------------------------------------

def paged_decode_cost(s: Shape, keys: float, rows: int) -> Tuple[float, float]:
    """One layer's paged GQA decode over `rows` queries that read `keys`
    cached positions in all (each row its own): (FLOPs, bytes). Each key's
    K and V are read once for its row's kv head group; q is read and the
    output written once."""
    flops = 4.0 * keys * s.heads * s.head_dim
    nbytes = (2.0 * keys * s.kv_heads * s.head_dim * BF16
              + 2.0 * rows * s.heads * s.head_dim * BF16)
    return flops, nbytes


def sgmv_cost(rows: int, d_in: int, d_out: int, rank: int,
              slots_used: int) -> Tuple[float, float]:
    """One in-place multi-LoRA add y += s·(x a) b over `rows` bf16 rows:
    (FLOPs, bytes). x read once, y read and written once, the fp32 adapters
    of the slots the rows use read once."""
    flops = 2.0 * rows * rank * (d_in + d_out) + rows * d_out
    nbytes = (rows * d_in * BF16 + 2.0 * rows * d_out * BF16
              + slots_used * rank * (d_in + d_out) * F32)
    return flops, nbytes


def token_logprob_fwd_cost(n: int, d: int, v: int) -> Tuple[float, float]:
    """The fused logprob forward over n rows: logits n·d·V multiply-adds;
    reads h (bf16), W (bf16) and the targets, writes logprob, entropy and
    the log-sum-exp (fp32)."""
    flops = 2.0 * n * d * v
    nbytes = n * d * BF16 + d * v * BF16 + n * 4 + 3.0 * n * F32
    return flops, nbytes
