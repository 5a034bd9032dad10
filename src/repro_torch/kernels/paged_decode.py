"""Paged GQA flash-decode: single-token attention over the shared KV page
pool, read through per-row block tables (port of
``repro.kernels.paged_decode``).

On the card, ``paged_gqa_decode`` launches the hand-written CUDA kernel
``csrc/paged_decode.cu``, which splits each row's pages over blocks as
``gqa_decode.decode_plan`` cuts them; for tensors on the CPU it runs the
plain version ``paged_gqa_decode_ref`` (``kernels/ref.py``: gather the
pages, then dense attention). There is no other route: a CUDA tensor the
kernel does not take raises.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from .boundary import is_dtensor, on_replicas, plain
from .gqa_decode import _ptr, decode_plan, merge_scratch
from .ref import paged_gqa_decode_ref

__all__ = ["paged_gqa_decode", "paged_gqa_decode_ref", "LAUNCHES",
           "CUDA_LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_REPS = (1, 2, 4, 8)

# calls that launched the kernel, and the CUDA kernels those calls launched
# (as the C launcher counts them: one a call)
LAUNCHES = _build.LaunchCount()
CUDA_LAUNCHES = _build.LaunchCount()


def _check(q, kp, vp, tbl, pos):
    if any(t.device != q.device for t in (kp, vp, tbl, pos)):
        raise ValueError("paged_gqa_decode: q, pools, table and pos must "
                         "share the card")
    if q.dtype not in _DTYPE_CODE or kp.dtype != q.dtype \
            or vp.dtype != q.dtype:
        raise ValueError(f"paged_gqa_decode: q/pool dtypes {q.dtype}, "
                         f"{kp.dtype}, {vp.dtype}: the kernel takes one of "
                         f"float32 / bfloat16 for all three")
    if tbl.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"paged_gqa_decode: tbl and pos must be int32, got "
                         f"{tbl.dtype}, {pos.dtype}")
    B, H, hd = q.shape
    if kp.dim() != 4 or kp.shape != vp.shape or kp.shape[3] != hd \
            or tbl.dim() != 2 or tbl.shape[0] != B or pos.shape != (B,):
        raise ValueError(f"paged_gqa_decode: shapes q {tuple(q.shape)}, pool "
                         f"{tuple(kp.shape)}/{tuple(vp.shape)}, tbl "
                         f"{tuple(tbl.shape)}, pos {tuple(pos.shape)} do not "
                         f"fit [B,H,hd] / [n_pages+1,page,KVH,hd] / "
                         f"[B,max_pages] / [B]")
    KVH = kp.shape[2]
    if hd not in _HEAD_DIMS or H % KVH or H // KVH not in _REPS:
        raise ValueError(f"paged_gqa_decode: head_dim {hd} (takes "
                         f"{_HEAD_DIMS}) and H/KVH = {H}/{KVH} (takes ratios "
                         f"{_REPS})")
    if not 0 < tbl.shape[1] * kp.shape[1] < 2 ** 31:    # int32 key indices
        raise ValueError(f"paged_gqa_decode: {tbl.shape[1]} pages of "
                         f"{kp.shape[1]} a row; the kernel takes 1 to 2**31 - 1 "
                         f"keys a row")
    for name, t in (("q", q), ("kp", kp), ("vp", vp), ("tbl", tbl),
                    ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"paged_gqa_decode: {name} must be contiguous")
        if name in ("q", "kp", "vp") and t.data_ptr() % 16:
            raise ValueError(f"paged_gqa_decode: {name} must be 16-byte "
                             f"aligned")                # rows load as vectors


def paged_gqa_decode(q, kp, vp, tbl, pos, *, softcap: float = 0.0,
                     window: int = 0):
    # step: decode attention; tensors=q,kp,vp,tbl,pos
    """q: [B, H, hd]; kp/vp: [n_pages+1, page, KVH, hd] (one layer's pool;
    the last page is scratch); tbl: [B, max_pages] int32 physical page ids;
    pos: [B] valid lengths (including the just-written token, >= 1).
    Returns [B, H, hd] in q's dtype. DTensors on the card go through
    ``boundary.on_replicas``."""
    if plain(q):
        return paged_gqa_decode_ref(q, kp, vp, tbl, pos, softcap=softcap,
                                    window=window)
    if is_dtensor(q):
        return on_replicas(paged_gqa_decode, q, kp, vp, tbl, pos,
                           softcap=softcap, window=window)
    if not q.is_cuda:
        raise ValueError(f"paged_gqa_decode: no kernel for device {q.device}")
    _check(q, kp, vp, tbl, pos)
    B, H, hd = q.shape
    n_total, page, KVH = kp.shape[0], kp.shape[1], kp.shape[2]
    max_pages = tbl.shape[1]
    plan = decode_plan(B, KVH, max_pages * page, page, H=H, hd=hd,
                       window=int(window))
    part, tickets = merge_scratch(plan, q)
    out = torch.empty_like(q)
    launched = ctypes.c_int(0)
    err = _build.library("paged_decode").paged_decode_launch(
        q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tbl.data_ptr(),
        pos.data_ptr(), out.data_ptr(), _ptr(part), _ptr(tickets), B, n_total,
        page, max_pages, KVH, H, hd, _DTYPE_CODE[q.dtype], float(softcap),
        int(window), plan.chunk, plan.splits, plan.warps,
        torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.addressof(launched))
    CUDA_LAUNCHES.add(launched.value)
    _build.check(err, "paged_gqa_decode")
    LAUNCHES.add(1)
    return out
