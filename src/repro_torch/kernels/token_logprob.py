"""Fused token logprob + entropy over the vocabulary, without storing the
[tokens, V] logits — the GRPO trainer's hot spot at 150k vocabularies (port
of ``repro.kernels.token_logprob``, with the backward the TPU kernel lacks).

``token_logprob_flat(h, w, targets, softcap)`` returns fp32 (logprob,
entropy) per row and is differentiable in ``h``. On the card it is a
``torch.autograd.Function`` over the hand-written CUDA kernels of
``csrc/token_logprob.cu``: the forward kernel (plus a merge launch over the
vocab slices) and the backward kernel for ``dh`` (plus a reduce launch). W
is the frozen base: a ``w`` that requires grad raises on the card (``dW`` is
not written yet). For tensors on the CPU it runs the plain version
``token_logprob_ref`` (``kernels/ref.py``) under torch autograd, which
differentiates both. A CUDA tensor the kernels do not take raises.
``token_logprob_fwd`` and ``token_logprob_bwd`` are the two kernels'
wrappers (plain versions on the CPU).
"""
from __future__ import annotations

import torch

from . import _build
from .ref import (token_logprob_bwd_ref, token_logprob_ref,
                  token_logprob_stats_ref)

__all__ = ["token_logprob_flat", "token_logprob_fwd", "token_logprob_bwd",
           "token_logprob_ref", "token_logprob_bwd_ref", "FWD_LAUNCHES",
           "BWD_LAUNCHES"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_BM_FWD, _BM_BWD, _BN, _BK, _DCH = 64, 32, 64, 32, 1024   # as in the .cu
_FWD_TARGET_BLOCKS = 528     # about four forward blocks per SM of an H100
_BWD_TARGET_BLOCKS = 264     # about two backward blocks per SM (~150 KB each)

# calls that launched the forward kernel (each also launches its merge), and
# calls that launched the backward kernel (each also launches its reduce)
FWD_LAUNCHES = _build.LaunchCount()
BWD_LAUNCHES = _build.LaunchCount()


def vocab_split(R: int, V: int, bm: int, target_blocks: int):
    """(slices, tiles per slice): the vocabulary's 64-column tiles cut into
    enough slices that row blocks x slices covers the card."""
    n_tiles = -(-V // _BN)
    row_blocks = max(1, -(-R // bm))
    want = max(1, min(n_tiles, -(-target_blocks // row_blocks)))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


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
    if h.device.type == "cpu":
        return token_logprob_stats_ref(h, w, targets, softcap)
    _check(h, w, targets)
    R, d = h.shape
    V = w.shape[1]
    vsplit, per = vocab_split(R, V, _BM_FWD, _FWD_TARGET_BLOCKS)
    part = torch.empty((vsplit, R, 4), dtype=torch.float32, device=h.device)
    lp, ent, lse = (torch.empty((R,), dtype=torch.float32, device=h.device)
                    for _ in range(3))
    err = _build.library("token_logprob").token_logprob_fwd_launch(
        h.data_ptr(), w.data_ptr(), targets.data_ptr(), part.data_ptr(),
        lp.data_ptr(), ent.data_ptr(), lse.data_ptr(), R, d, V,
        w.stride(0), w.stride(1), vsplit, per, float(softcap),
        _DTYPE_CODE[h.dtype], _stream(h))
    _build.check(err, "token_logprob forward")
    FWD_LAUNCHES.n += 1
    return lp, ent, lse


def token_logprob_bwd(h, w, targets, lse, ent, g_lp, g_ent,
                      softcap: float = 0.0):
    """The backward kernel: dh [R, d] in h's dtype, from the forward's lse
    and entropy and the upstream grads g_lp, g_ent ([R] fp32 each). CPU
    tensors take the plain version."""
    if h.device.type == "cpu":
        return token_logprob_bwd_ref(h, w, targets, lse, ent, g_lp, g_ent,
                                     softcap)
    _check(h, w, targets)
    R, d = h.shape
    V = w.shape[1]
    f32 = [t.float().contiguous() for t in (lse, ent, g_lp, g_ent)]
    if any(t.shape != (R,) or t.device != h.device for t in f32):
        raise ValueError("token_logprob: lse, ent, g_lp and g_ent must be [R] "
                         "on h's card")
    vsplit, per = vocab_split(R, V, _BM_BWD, _BWD_TARGET_BLOCKS)
    dch = min(_DCH, -(-d // _BK) * _BK)
    dpart = torch.empty((vsplit, R, d), dtype=torch.float32, device=h.device)
    dh = torch.empty_like(h)
    err = _build.library("token_logprob").token_logprob_bwd_launch(
        h.data_ptr(), w.data_ptr(), targets.data_ptr(),
        *(t.data_ptr() for t in f32), dpart.data_ptr(), dh.data_ptr(), R, d,
        V, w.stride(0), w.stride(1), vsplit, per, dch, float(softcap),
        _DTYPE_CODE[h.dtype], _stream(h))
    _build.check(err, "token_logprob backward")
    BWD_LAUNCHES.n += 1
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
    Returns (logprob [R], entropy [R]) float32, differentiable in h."""
    if h.device.type == "cpu":
        return token_logprob_ref(h, w, targets, softcap)
    if not h.is_cuda:
        raise ValueError(f"token_logprob: no kernel for device {h.device}")
    if w.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "token_logprob: the card's backward computes dh only; w requires "
            "grad (trainable='full') and dW has no kernel yet")
    return _TokenLogprob.apply(h, w, targets, float(softcap))
