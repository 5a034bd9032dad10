"""Fused token logprob + entropy over the vocabulary, without storing the
[tokens, V] logits — the GRPO trainer's hot spot at 150k vocabularies (port
of ``repro.kernels.token_logprob``, with the backward the TPU kernel lacks).

``token_logprob_flat(h, w, targets, softcap)`` returns fp32 (logprob,
entropy) per row and is differentiable in ``h``. On the card it is a
``torch.autograd.Function`` over the hand-written CUDA kernels of
``csrc/token_logprob.cu``: the forward kernel (bf16: the logits product on
the warp-specialised wgmma mainloop with an online-softmax epilogue, over
the vocab slices ``forward_plan`` cuts; fp32: an FMA kernel), plus a merge
launch over the slices, and the backward kernels for ``dh`` (bf16: two
products per vocab chunk on the same mainloop, as ``backward_plan`` cuts
the work; fp32: one FMA kernel; either ends with a reduce launch). In bf16
W's tiles come by TMA or by the kernel's copies, as ``w_feed`` picks from
its address and strides. W is the frozen
base: a ``w`` that requires grad raises on the card (``dW`` is not written
yet). For tensors on the CPU it runs the plain version
``token_logprob_ref`` (``kernels/ref.py``) under torch autograd, which
differentiates both. A CUDA tensor the kernels do not take raises.
``token_logprob_fwd`` and ``token_logprob_bwd`` are the two kernels'
wrappers (plain versions on the CPU).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from . import _build
from .boundary import is_dtensor, on_replicas, plain
from .ref import (token_logprob_bwd_ref, token_logprob_ref,
                  token_logprob_stats_ref)

__all__ = ["token_logprob_flat", "token_logprob_fwd", "token_logprob_bwd",
           "token_logprob_ref", "token_logprob_bwd_ref", "backward_plan",
           "forward_plan", "FWD_LAUNCHES", "BWD_LAUNCHES",
           "FWD_CUDA_LAUNCHES", "BWD_CUDA_LAUNCHES", "FWD_W_VECTOR",
           "BWD_W_VECTOR", "WFeed", "w_feed"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# the fp32 kernels' row blocks and vocab tiles (as in the .cu)
_BM_FWD, _BM_F32_BWD, _BN = 64, 32, 64
_FWD_TARGET_BLOCKS = 528     # about four fp32 forward blocks per SM of an H100
_F32_BWD_TARGET_BLOCKS = 264  # about two fp32 backward blocks per SM
# the bf16 products: 128 x 128 tiles, K-steps of 64, one block of 225 KB
# shared memory per SM on 132 SMs (as in the .cu)
_TILE, _TK, _MM_SLOTS = 128, 64, 132
_MIN_SLICE_TILES = 4         # bf16 forward: vocab tiles a slice walks, at least
_BLOCK_TILES = 2             # a block's set-up, ring fill and partials, in tiles
# a few rows do not fill the card with any split (W's bytes bound them);
# past 16 pieces more partials only lengthen the final sum
_MAX_SPLITS = 16
SCRATCH_LIMIT = 128 << 20    # the bf16 backward's dz chunk + fp32 partials
_ALLOC_ROUND = 2 << 20       # the CUDA caching allocator's rounding of a large
                             # block: each of the two may take this much more

# calls that launched the forward kernel (each also launches its merge), and
# calls that launched the backward kernels (bf16: two products per vocab
# chunk; each call ends with a reduce launch)
FWD_LAUNCHES = _build.LaunchCount()
BWD_LAUNCHES = _build.LaunchCount()
# the CUDA kernels those calls launched, as the C launchers count them
FWD_CUDA_LAUNCHES = _build.LaunchCount()
BWD_CUDA_LAUNCHES = _build.LaunchCount()
# the vocab chunks whose W tiles those calls loaded by TMA or 16-byte copies,
# as the C launchers report them (a forward and an fp32 backward have one
# chunk, a bf16 backward one a pair of products; in bf16, w_feed's width 16);
# the others load W by narrower copies or element by element
FWD_W_VECTOR = _build.LaunchCount()
BWD_W_VECTOR = _build.LaunchCount()


def vocab_split(R: int, V: int, bm: int, target_blocks: int):
    """(slices, tiles per slice) of the fp32 kernels: the vocabulary's
    64-column tiles cut into enough slices that row blocks x slices covers
    the card."""
    n_tiles = -(-V // _BN)
    row_blocks = max(1, -(-R // bm))
    want = max(1, min(n_tiles, -(-target_blocks // row_blocks)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ForwardPlan(NamedTuple):
    """How the bf16 forward cuts the vocabulary (see ``forward_plan``)."""
    vsplit: int         # vocab slices, the grid's second dimension
    slice_tiles: int    # 128-column tiles per slice (the last may have fewer)


@functools.lru_cache(maxsize=64)
def forward_plan(R: int, V: int) -> ForwardPlan:
    """The bf16 forward's grid: 128-row tiles x ``vsplit`` slices of
    ``slice_tiles`` 128-column vocab tiles, each block walking its slice.
    Blocks run in waves of the card's block slots (one a SM), and a block's
    time is about its slice's tiles and a fixed start (_BLOCK_TILES), so a
    split costs about waves x (slice_tiles + _BLOCK_TILES). The plan is the
    cheapest split, the fewest slices among equals (fewer partials to
    merge), with at least _MIN_SLICE_TILES tiles a slice where the
    vocabulary has them."""
    n_tiles = _cdiv(V, _TILE)
    row_tiles = max(1, _cdiv(R, _TILE))
    best = None
    for per in range(min(_MIN_SLICE_TILES, n_tiles), n_tiles + 1):
        vsplit = _cdiv(n_tiles, per)
        key = (_cdiv(row_tiles * vsplit, _MM_SLOTS) * (per + _BLOCK_TILES),
               vsplit)
        if best is None or key < best[0]:
            best = (key, ForwardPlan(vsplit, per))
    return best[1]


class BackwardPlan(NamedTuple):
    """How the bf16 backward cuts its work (see ``backward_plan``)."""
    vc: int             # vocab columns per chunk, a multiple of the tile
    splits: int         # K pieces of the dz @ W^T product per chunk
    piece: int          # columns per K piece, a multiple of the K-step
    scratch_bytes: int  # the [R, vc] bf16 dz chunk + [splits, R, d] fp32


def backward_plan(R: int, d: int, V: int) -> BackwardPlan:
    """The bf16 backward's tiling. The vocabulary is cut into chunks of
    ``vc`` columns (the last may be shorter); per chunk, product 1 covers
    the chunk in 128-column tiles (its blocks walk them as
    ``forward_plan(R, vc)`` cuts a vocabulary of vc columns), and product 2
    (``dz @ W^T``) splits its K,
    the chunk's columns, into ``splits`` pieces of ``piece`` columns, so
    that its (row tiles x d tiles) output tiles times ``splits`` about fill
    the card's block slots without a second wave. ``vc`` is as large as the
    scratch limit allows, then evened out over the chunks. The scratch stays
    under SCRATCH_LIMIT wherever one fp32 partial (R * d * 4 bytes) and one
    128-column dz chunk fit under it, as the allocator rounds the two
    buffers' blocks."""
    rows = max(R, 1)
    tiles = _cdiv(rows, _TILE) * _cdiv(d, _TILE)
    splits = max(1, min(_MAX_SPLITS, _MM_SLOTS // tiles))
    part = splits * R * d * 4
    room = max(_TILE, (SCRATCH_LIMIT - part - 2 * _ALLOC_ROUND) // (2 * rows)
               // _TILE * _TILE)
    n_chunks = _cdiv(V, room)
    vc = _cdiv(_cdiv(V, n_chunks), _TILE) * _TILE
    piece = _cdiv(_cdiv(vc, splits), _TK) * _TK
    return BackwardPlan(vc, splits, piece, R * vc * 2 + part)


class WFeed(NamedTuple):
    """How the bf16 kernels bring W's tiles to shared memory (``w_feed``)."""
    route: str   # "tma", "cp.async" (the kernel's copies) or "loads" (2-byte)
    width: int   # bytes every copy moves: 16, 8, 4 or 2 (element loads)
    major: str   # "k" or "v": W's dimension that is contiguous (the smaller
                 # stride), along which a tile's 16-byte units run


def _pow2_align(x: int) -> int:
    """The largest power of two up to 16 that divides x."""
    return 16 if x % 16 == 0 else x & -x


def w_feed(ptr: int, shape, strides) -> WFeed:
    """W's route into the bf16 kernels, from its address, shape [d, V] and
    strides (elements) alone, as the C launchers check it: TMA where one
    stride is 1, the other a multiple of 16 bytes and no shorter than the
    contiguous extent, and the base 16-byte aligned; else the producer's
    cp.async copies, every one as wide as both the base and the row stride
    allow (``width``, 4 bytes at the least), and 2-byte loads where rows
    are only 2-byte aligned or no stride is 1 (a strided view, which only
    the forward takes)."""
    d, V = shape
    ws_k, ws_v = strides
    major = "k" if ws_k <= ws_v else "v"
    if ws_k != 1 and ws_v != 1:
        return WFeed("loads", 2, major)
    other, extent = (ws_v, d) if ws_k == 1 else (ws_k, V)
    row_bytes = 2 * other
    if ptr % 16 == 0 and row_bytes % 16 == 0 and other >= extent:
        return WFeed("tma", 16, major)
    width = min(_pow2_align(ptr), _pow2_align(row_bytes))
    return WFeed("cp.async", width, major) if width >= 4 \
        else WFeed("loads", 2, major)


def _w_tma(w) -> int:
    return int(w_feed(w.data_ptr(), tuple(w.shape), w.stride()).route == "tma")


def _check(h, w, targets):
    if w.device != h.device or targets.device != h.device:
        raise ValueError("token_logprob: h, w and targets must share the card")
    if h.dtype not in _DTYPE_CODE or w.dtype != h.dtype:
        raise ValueError(f"token_logprob: h {h.dtype}, w {w.dtype}; the kernel "
                         f"takes float32 or bfloat16 for both")
    if targets.dtype != torch.int32:
        raise ValueError(f"token_logprob: targets must be int32, got "
                         f"{targets.dtype}")
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[1] \
            or targets.shape != (h.shape[0],):
        raise ValueError(f"token_logprob: shapes h {tuple(h.shape)}, w "
                         f"{tuple(w.shape)}, targets {tuple(targets.shape)} do "
                         f"not fit [R,d] / [d,V] / [R]")
    if not h.is_contiguous() or not targets.is_contiguous():
        raise ValueError("token_logprob: h and targets must be contiguous")
    if min(w.stride()) < 1:
        raise ValueError(f"token_logprob: w strides {w.stride()} must be "
                         f"positive")
    # a host read of the card's data; skipped while a CUDA graph records
    if not torch.cuda.is_current_stream_capturing() and targets.numel() \
            and bool(((targets < 0) | (targets >= w.shape[1])).any()):
        raise ValueError(f"token_logprob: targets outside [0, {w.shape[1]})")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def token_logprob_fwd(h, w, targets, softcap: float = 0.0):
    """The forward kernel: (logprob, entropy, lse), each [R] fp32.
    h: [R, d] contiguous; w: [d, V] with any positive strides (the tied
    embedding's transpose is read in place); targets: [R] int32. CPU
    tensors take the plain version."""
    if plain(h):
        return token_logprob_stats_ref(h, w, targets, softcap)
    _check(h, w, targets)
    R, d = h.shape
    V = w.shape[1]
    if h.dtype == torch.bfloat16:
        vsplit, per = forward_plan(R, V)
    else:
        vsplit, per = vocab_split(R, V, _BM_FWD, _FWD_TARGET_BLOCKS)
    part = torch.empty((vsplit, R, 4), dtype=torch.float32, device=h.device)
    lp, ent, lse = (torch.empty((R,), dtype=torch.float32, device=h.device)
                    for _ in range(3))
    launched, w_vector = ctypes.c_int(0), ctypes.c_int(0)
    err = _build.library("token_logprob").token_logprob_fwd_launch(
        h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
        lp.data_ptr(), ent.data_ptr(), lse.data_ptr(), R, d, V,
        w.stride(0), w.stride(1), vsplit, per, float(softcap),
        _DTYPE_CODE[h.dtype], _w_tma(w) if h.dtype == torch.bfloat16 else 0,
        _stream(h), ctypes.addressof(launched), ctypes.addressof(w_vector))
    FWD_CUDA_LAUNCHES.add(launched.value)
    FWD_W_VECTOR.add(w_vector.value)
    _build.check(err, "token_logprob forward")
    FWD_LAUNCHES.add(1)
    return lp, ent, lse


def token_logprob_bwd(h, w, targets, lse, ent, g_lp, g_ent,
                      softcap: float = 0.0):
    """The backward kernel: dh [R, d] in h's dtype, from the forward's lse
    and entropy and the upstream grads g_lp, g_ent ([R] fp32 each). CPU
    tensors take the plain version."""
    if plain(h):
        return token_logprob_bwd_ref(h, w, targets, lse, ent, g_lp, g_ent,
                                     softcap)
    _check(h, w, targets)
    R, d = h.shape
    V = w.shape[1]
    f32 = [t.float().contiguous() for t in (lse, ent, g_lp, g_ent)]
    if any(t.shape != (R,) or t.device != h.device for t in f32):
        raise ValueError("token_logprob: lse, ent, g_lp and g_ent must be [R] "
                         "on h's card")
    lib = _build.library("token_logprob")
    dh = torch.empty_like(h)
    launched, w_vector = ctypes.c_int(0), ctypes.c_int(0)
    if h.dtype == torch.bfloat16:
        if 1 not in w.stride():
            raise ValueError(f"token_logprob: the bf16 backward reads w with "
                             f"its k or its v contiguous; strides "
                             f"{w.stride()}")
        plan = backward_plan(R, d, V)
        dz = torch.empty((R, plan.vc), dtype=torch.bfloat16, device=h.device)
        part = torch.empty((plan.splits, R, d), dtype=torch.float32,
                           device=h.device)
        err = lib.token_logprob_bwd_bf16_launch(
            h.data_ptr(), w.data_ptr(), targets.data_ptr(),
            *(t.data_ptr() for t in f32), dz.data_ptr(), part.data_ptr(),
            dh.data_ptr(), R, d, V, w.stride(0), w.stride(1), plan.vc,
            plan.splits, plan.piece, forward_plan(R, plan.vc).slice_tiles,
            float(softcap), _w_tma(w), _stream(h),
            ctypes.addressof(launched), ctypes.addressof(w_vector))
    else:
        vsplit, per = vocab_split(R, V, _BM_F32_BWD, _F32_BWD_TARGET_BLOCKS)
        dpart = torch.empty((vsplit, R, d), dtype=torch.float32,
                            device=h.device)
        err = lib.token_logprob_bwd_f32_launch(
            h.data_ptr(), w.data_ptr(), targets.data_ptr(),
            *(t.data_ptr() for t in f32), dpart.data_ptr(), dh.data_ptr(), R,
            d, V, w.stride(0), w.stride(1), vsplit, per, float(softcap),
            _stream(h), ctypes.addressof(launched), ctypes.addressof(w_vector))
    BWD_CUDA_LAUNCHES.add(launched.value)
    BWD_W_VECTOR.add(w_vector.value)
    _build.check(err, "token_logprob backward")
    BWD_LAUNCHES.add(1)
    return dh


class _TokenLogprob(torch.autograd.Function):
    """The kernels as an autograd node: grads flow to h only. (For CPU
    tensors its forward and backward are the plain versions, which lets
    the tests check the node's wiring.)"""

    @staticmethod
    def forward(ctx, h, w, targets, softcap):
        lp, ent, lse = token_logprob_fwd(h, w, targets, softcap)
        ctx.save_for_backward(h, w, targets, lse, ent)
        ctx.softcap = softcap
        return lp, ent

    @staticmethod
    def backward(ctx, g_lp, g_ent):
        h, w, targets, lse, ent = ctx.saved_tensors
        dh = None
        if ctx.needs_input_grad[0]:
            dh = token_logprob_bwd(h, w, targets, lse, ent, g_lp, g_ent,
                                   ctx.softcap)
        return dh, None, None, None


def token_logprob_flat(h, w, targets, softcap: float = 0.0):
    """h: [R, d]; w: [d, V]; targets: [R] int32 in [0, V).
    Returns (logprob [R], entropy [R]) float32, differentiable in h.
    DTensors on the card go through ``boundary.on_replicas``."""
    if plain(h):
        return token_logprob_ref(h, w, targets, softcap)
    if is_dtensor(h):
        return on_replicas(token_logprob_flat, h, w, targets, softcap)
    if not h.is_cuda:
        raise ValueError(f"token_logprob: no kernel for device {h.device}")
    if w.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "token_logprob: the card's backward computes dh only; w requires "
            "grad (trainable='full') and dW has no kernel yet")
    return _TokenLogprob.apply(h, w, targets, float(softcap))
