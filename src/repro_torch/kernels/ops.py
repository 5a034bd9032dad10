"""Public wrappers around the kernels — the API surface the model layers call
(port of ``repro.kernels.ops``). Each launches its CUDA kernel for tensors on
the card and runs its plain version for tensors on the CPU."""
from __future__ import annotations

import torch

from .gqa_decode import gqa_decode as _gqa_decode
from .paged_decode import paged_gqa_decode as _paged_gqa_decode
from .sgmv import sgmv as _sgmv
from .token_logprob import token_logprob_flat


def sgmv(rows, a, b, ids):
    """Multi-LoRA delta for a batch of rows: rows[i] @ a[g] @ b[g].
    rows: [R, d]; a: [T, d, r]; b: [T, r, dout]; ids: [R]. -> [R, dout]"""
    return _sgmv(rows, a, b, ids)


def gqa_decode(q, cache_k, cache_v, pos, *, softcap=0.0, window=0):
    """Flash-decode GQA attention over a KV cache (one query token/row)."""
    return _gqa_decode(q, cache_k, cache_v, pos, softcap=softcap,
                       window=window)


def paged_gqa_decode(q, kp, vp, tbl, pos, *, softcap=0.0, window=0):
    """Flash-decode GQA attention over the shared page pool through a block
    table (one query token/row)."""
    return _paged_gqa_decode(q, kp, vp, tbl, pos, softcap=softcap,
                             window=window)


def token_logprob(hidden, vocab_w, targets, softcap: float = 0.0):
    """Fused logprob+entropy. hidden: [B, S, d]; vocab_w: [d, V];
    targets: [B, S]. Returns (logprob [B, S], entropy [B, S]) fp32,
    differentiable in hidden."""
    B, S, d = hidden.shape
    lp, ent = token_logprob_flat(hidden.reshape(B * S, d).contiguous(),
                                 vocab_w,
                                 targets.reshape(B * S).to(torch.int32)
                                 .contiguous(), softcap=softcap)
    return lp.reshape(B, S), ent.reshape(B, S)
