"""SGMV — multi-LoRA grouped matmul, the rollout hot spot of multi-tenant
serving (paper §4.5; port of ``repro.kernels.sgmv``).

``sgmv(rows, a, b, ids)`` computes ``y[i] = rows[i] @ a[ids[i]] @ b[ids[i]]``
in fp32. On the card it launches the hand-written CUDA kernel
``csrc/sgmv.cu`` (a shrink launch and an expand launch, each row gathering
its own adapter by id); for tensors on the CPU it runs the plain version
``sgmv_ref`` (``kernels/ref.py``). A CUDA tensor the kernel does not take
raises. The caller applies the LoRA scaling and the cast.
"""
from __future__ import annotations

import torch

from . import _build
from .ref import sgmv_ref

__all__ = ["sgmv", "sgmv_ref", "LAUNCHES", "split_for"]

_X_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_TARGET_BLOCKS = 264          # about two blocks per SM of an H100

# calls that launched the kernels; each is a shrink and an expand launch
LAUNCHES = _build.LaunchCount()


def split_for(R: int, d: int) -> int:
    """How many slices the shrink launch cuts the d axis into: enough
    blocks to cover the card when rows are few, slices of at least 64."""
    if R <= 0:
        return 1
    return max(1, min(-(-_TARGET_BLOCKS // R), -(-d // 64)))


def _check(rows, a, b, ids):
    if any(t.device != rows.device for t in (a, b, ids)):
        raise ValueError("sgmv: rows, a, b and ids must share the card")
    if rows.dtype not in _X_DTYPE_CODE:
        raise ValueError(f"sgmv: rows dtype {rows.dtype}; the kernel takes "
                         f"float32 or bfloat16")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"sgmv: adapters must be float32, got {a.dtype}, "
                         f"{b.dtype}")
    if ids.dtype != torch.int32:
        raise ValueError(f"sgmv: ids must be int32, got {ids.dtype}")
    R, d = rows.shape
    if a.dim() != 3 or b.dim() != 3 or a.shape[1] != d \
            or b.shape[:2] != (a.shape[0], a.shape[2]) or ids.shape != (R,):
        raise ValueError(f"sgmv: shapes rows {tuple(rows.shape)}, a "
                         f"{tuple(a.shape)}, b {tuple(b.shape)}, ids "
                         f"{tuple(ids.shape)} do not fit [R,d] / [T,d,r] / "
                         f"[T,r,dout] / [R]")
    r, dout = a.shape[2], b.shape[2]
    if r % 4 or r > 256 or dout % 4:
        raise ValueError(f"sgmv: rank {r} must be a multiple of 4 up to 256 "
                         f"and dout {dout} a multiple of 4")
    for name, t in (("rows", rows), ("a", a), ("b", b), ("ids", ids)):
        if not t.is_contiguous():
            raise ValueError(f"sgmv: {name} must be contiguous")
    if a.data_ptr() % 16 or b.data_ptr() % 16:     # read as float4
        raise ValueError("sgmv: a and b must be 16-byte aligned")


def sgmv(rows, a, b, ids):
    """rows: [R, d]; a: [T, d, r]; b: [T, r, dout]; ids: [R] in [0, T).
    Returns [R, dout] float32."""
    if rows.device.type == "cpu":
        return sgmv_ref(rows, a, b, ids)
    if not rows.is_cuda:
        raise ValueError(f"sgmv: no kernel for device {rows.device}")
    _check(rows, a, b, ids)
    R, d = rows.shape
    r, dout = a.shape[2], b.shape[2]
    ks = split_for(R, d)
    h_part = torch.empty((ks, R, r), dtype=torch.float32, device=rows.device)
    y = torch.empty((R, dout), dtype=torch.float32, device=rows.device)
    lib = _build.library("sgmv")
    err = lib.sgmv_launch(
        rows.data_ptr(), a.data_ptr(), b.data_ptr(), ids.data_ptr(),
        h_part.data_ptr(), y.data_ptr(), R, d, r, dout, ks,
        _X_DTYPE_CODE[rows.dtype],
        torch.cuda.current_stream(rows.device).cuda_stream)
    _build.check(err, "sgmv")
    LAUNCHES.n += 1
    return y
