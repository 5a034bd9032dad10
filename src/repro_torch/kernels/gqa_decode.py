"""GQA flash-decode: single-token attention over a contiguous KV cache, the
per-step memory-bound core of rollout decode (port of
``repro.kernels.gqa_decode``).

On the card, ``gqa_decode`` launches the hand-written CUDA kernel
``csrc/gqa_decode.cu``; for tensors on the CPU it runs the plain version
``gqa_decode_ref`` (``kernels/ref.py``). There is no other route: a CUDA
tensor the kernel does not take raises.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import gqa_decode_ref

__all__ = ["gqa_decode", "gqa_decode_ref", "LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_REPS = (1, 2, 4, 8)

LAUNCHES = _build.LaunchCount()


def _check(q, cache_k, cache_v, pos):
    if any(t.device != q.device for t in (cache_k, cache_v, pos)):
        raise ValueError("gqa_decode: q, caches and pos must share the card")
    if q.dtype not in _DTYPE_CODE or cache_k.dtype != q.dtype \
            or cache_v.dtype != q.dtype:
        raise ValueError(f"gqa_decode: q/cache dtypes {q.dtype}, "
                         f"{cache_k.dtype}, {cache_v.dtype}: the kernel takes "
                         f"one of float32 / bfloat16 for all three")
    if pos.dtype != torch.int32:
        raise ValueError(f"gqa_decode: pos must be int32, got {pos.dtype}")
    B, H, hd = q.shape
    if cache_k.dim() != 4 or cache_k.shape != cache_v.shape \
            or cache_k.shape[0] != B or cache_k.shape[3] != hd \
            or pos.shape != (B,):
        raise ValueError(f"gqa_decode: shapes q {tuple(q.shape)}, cache "
                         f"{tuple(cache_k.shape)}/{tuple(cache_v.shape)}, pos "
                         f"{tuple(pos.shape)} do not fit [B,H,hd] / "
                         f"[B,S,KVH,hd] / [B]")
    KVH = cache_k.shape[2]
    if hd not in _HEAD_DIMS or H % KVH or H // KVH not in _REPS:
        raise ValueError(f"gqa_decode: head_dim {hd} (takes {_HEAD_DIMS}) and "
                         f"H/KVH = {H}/{KVH} (takes ratios {_REPS})")
    for name, t in (("q", q), ("cache_k", cache_k), ("cache_v", cache_v),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"gqa_decode: {name} must be contiguous")
        if name != "pos" and t.data_ptr() % 16:    # rows load as vectors
            raise ValueError(f"gqa_decode: {name} must be 16-byte aligned")


def gqa_decode(q, cache_k, cache_v, pos, *, softcap: float = 0.0,
               window: int = 0):
    """q: [B, H, hd]; cache_k/v: [B, S, KVH, hd]; pos: [B] valid lengths
    (including the just-written token, >= 1). Returns [B, H, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return gqa_decode_ref(q, cache_k, cache_v, pos, softcap=softcap,
                              window=window)
    if not q.is_cuda:
        raise ValueError(f"gqa_decode: no kernel for device {q.device}")
    _check(q, cache_k, cache_v, pos)
    B, H, hd = q.shape
    S, KVH = cache_k.shape[1], cache_k.shape[2]
    out = torch.empty_like(q)
    lib = _build.library("gqa_decode")
    err = lib.gqa_decode_launch(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), B, S, KVH, H, hd, _DTYPE_CODE[q.dtype],
        float(softcap), int(window), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "gqa_decode")
    LAUNCHES.n += 1
    return out
