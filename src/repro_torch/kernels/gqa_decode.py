"""GQA flash-decode: single-token attention over a contiguous KV cache, the
per-step memory-bound core of rollout decode (port of
``repro.kernels.gqa_decode``).

On the card, ``gqa_decode`` launches the hand-written CUDA kernel
``csrc/gqa_decode.cu``, which splits each row's keys over blocks as
``decode_plan`` cuts them; for tensors on the CPU it runs the plain version
``gqa_decode_ref`` (``kernels/ref.py``). There is no other route: a CUDA
tensor the kernel does not take raises. ``decode_plan`` and the merge
tickets serve ``paged_decode.py`` too.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from . import _build
from .boundary import heads_parallel, is_dtensor, on_replicas, plain
from .ref import gqa_decode_ref

__all__ = ["gqa_decode", "gqa_decode_ref", "decode_plan", "DecodePlan",
           "LAUNCHES", "CUDA_LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (16, 32, 64, 128, 256)
_REPS = (1, 2, 4, 8)
# the plan: blocks of (row, kv head, split) to aim for, about sixteen a SM
# of an H100's 132 (when pos spreads over the capacity about half of them
# are live); a chunk takes at least _MIN_CHUNK keys (below that, blocks that
# only find they are empty and the merge of more partials cost more than
# they save: chip_smoke.py phase 3 times the plan's chunk beside half and
# twice it), a multiple of _KEY_UNIT (and of the page), and at most
# _MAX_CHUNK_PAGES pages (kMaxChunkPages in decode_common.cuh: the table
# entries a block stages)
_TARGET_BLOCKS = 16 * 132
_MIN_CHUNK = 128
# a plan of at most _FEW_BLOCKS blocks (about four a SM; short caches) gives
# each block 8 warps instead of 4, where rep * hd <= 1024 lets their fold fit
# (decode_common.cuh's warps_fit): with few live blocks an SM holds one or
# two, and its keys go faster with twice the warps; with many, 4-warp blocks
# pack the SMs better
_FEW_BLOCKS = 4 * 132
_KEY_UNIT = 16
_MAX_CHUNK_PAGES = 256

# calls that launched the kernel, and the CUDA kernels those calls launched
# (as the C launcher counts them: one a call)
LAUNCHES = _build.LaunchCount()
CUDA_LAUNCHES = _build.LaunchCount()


class DecodePlan(NamedTuple):
    """How a decode kernel cuts each row's keys (see ``decode_plan``)."""
    chunk: int          # keys a block takes; a whole number of pages
    splits: int         # blocks per (row, kv head), the grid's first dimension
    grid: tuple         # (splits, KVH, B)
    scratch_bytes: int  # fp32 (m, l, acc[hd]) of every split; 0 with one split
    warps: int          # warps a block: 4, or 8 for few blocks


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, KVH: int, capacity: int, page: int = 1, *,
                H: int, hd: int, window: int = 0) -> DecodePlan:
    """The decode kernels' split over keys, from static shapes only (never
    ``pos``: reading it would sync the host every step). ``capacity`` is S
    for the contiguous cache and max_pages * page for the pool (``page`` 1
    for the contiguous cache). A row's live keys are cut into chunks of
    ``chunk`` keys counted from the page that holds the first; block s of
    (row, kv head) takes the s-th and exits at once past the last. The chunk
    is cut small enough that B x KVH x splits reaches _TARGET_BLOCKS over
    the keys a row can hold (the window, if smaller than the capacity), but
    not below _MIN_CHUNK keys; with a window a row touches at most
    cdiv(window + page - 1, chunk) chunks. Blocks have 8 warps where the
    plan has few of them (_FEW_BLOCKS), else 4."""
    capacity = max(capacity, 1)
    length = min(capacity, window) if window > 0 else capacity
    unit = math.lcm(page, _KEY_UNIT)
    want = -(-_TARGET_BLOCKS // max(1, B * KVH))
    chunk = max(_MIN_CHUNK, -(-length // want))
    chunk = min(-(-chunk // unit) * unit, _MAX_CHUNK_PAGES * page,
                -(-capacity // unit) * unit)
    splits = -(-capacity // chunk)
    if window > 0:
        splits = min(splits, -(-(window + page - 1) // chunk))
    scratch = B * H * splits * (hd + 2) * 4 if splits > 1 else 0
    few = B * KVH * splits <= _FEW_BLOCKS and (H // max(KVH, 1)) * hd <= 1024
    return DecodePlan(chunk, splits, (splits, KVH, B), scratch, 8 if few else 4)


# per card: int32 merge tickets, one per (row, kv head). Every launch
# leaves them 0 (the block that takes a row's last ticket resets it), so they
# are zeroed once, outside any CUDA-graph capture; a buffer outgrown stays
# alive for the graphs that captured it. Launches on one card run one after
# another on the caller's stream, as the port issues them; two streams that
# decode at once on one card would share the tickets.
_TICKETS: dict = {}
_OUTGROWN: list = []


def merge_scratch(plan: DecodePlan, q):
    """(partials, tickets) for a launch of ``plan`` on q's card: fp32
    scratch from ``torch.empty`` and the card's tickets, or (None, None)
    with one split."""
    if plan.splits == 1:
        return None, None
    part = torch.empty(plan.scratch_bytes // 4, dtype=torch.float32,
                       device=q.device)
    n = plan.grid[1] * plan.grid[2]
    t = _TICKETS.get(q.device)
    if t is None or t.numel() < n:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode kernels: call once at this batch size "
                               "before capturing a CUDA graph (the merge "
                               "tickets are zeroed outside the capture)")
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros(max(n, 4096), dtype=torch.int32, device=q.device)
        _TICKETS[q.device] = t
    return part, t


def _ptr(t):
    return None if t is None else t.data_ptr()


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
    DTensors on the card go through ``boundary.on_replicas``; on the CPU and
    the meta device through ``boundary.heads_parallel``."""
    if plain(q):
        if is_dtensor(q):
            return heads_parallel(gqa_decode_ref, q, cache_k, cache_v, pos,
                                  softcap=softcap, window=window)
        return gqa_decode_ref(q, cache_k, cache_v, pos, softcap=softcap,
                              window=window)
    if is_dtensor(q):
        return on_replicas(gqa_decode, q, cache_k, cache_v, pos,
                           softcap=softcap, window=window)
    if not q.is_cuda:
        raise ValueError(f"gqa_decode: no kernel for device {q.device}")
    _check(q, cache_k, cache_v, pos)
    B, H, hd = q.shape
    S, KVH = cache_k.shape[1], cache_k.shape[2]
    plan = decode_plan(B, KVH, S, 1, H=H, hd=hd, window=int(window))
    part, tickets = merge_scratch(plan, q)
    out = torch.empty_like(q)
    launched = ctypes.c_int(0)
    err = _build.library("gqa_decode").gqa_decode_launch(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), _ptr(part), _ptr(tickets), B, S, KVH, H, hd,
        _DTYPE_CODE[q.dtype], float(softcap), int(window), plan.chunk,
        plan.splits, plan.warps,
        torch.cuda.current_stream(q.device).cuda_stream,
        ctypes.addressof(launched))
    CUDA_LAUNCHES.add(launched.value)
    _build.check(err, "gqa_decode")
    LAUNCHES.add(1)
    return out
