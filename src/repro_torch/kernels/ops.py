"""Public wrappers around the kernels — the API surface the model layers call
(port of ``repro.kernels.ops``). Each launches its CUDA kernel for tensors on
the card and runs its plain version for tensors on the CPU."""
from __future__ import annotations

from .gqa_decode import gqa_decode as _gqa_decode
from .sgmv import sgmv as _sgmv


def sgmv(rows, a, b, ids):
    """Multi-LoRA delta for a batch of rows: rows[i] @ a[g] @ b[g].
    rows: [R, d]; a: [T, d, r]; b: [T, r, dout]; ids: [R]. -> [R, dout]"""
    return _sgmv(rows, a, b, ids)


def gqa_decode(q, cache_k, cache_v, pos, *, softcap=0.0, window=0):
    """Flash-decode GQA attention over a KV cache (one query token/row)."""
    return _gqa_decode(q, cache_k, cache_v, pos, softcap=softcap,
                       window=window)
