"""Batched multi-LoRA application (paper §4.5): one forward pass serves rows
belonging to *different* tenants, each with its own adapter (port of
``repro.lora.multilora``).

`multi_lora_delta` computes   y[i] += s · (x[i] @ A[g_i]) @ B[g_i]
for per-row task ids g. Two code paths, chosen by where the tensors lie:

- on the card: the hand-written SGMV kernel (kernels/sgmv), each row
  gathering its own adapter;
- on the CPU: ``multi_lora_delta_ref``, masked accumulation over tasks —
  O(T) dense matmuls, exact, the oracle the tests hold the port to.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ops import sgmv


def multi_lora_delta(x, a, b, row_task_ids, scaling: float):
    """x: [B, d] or [B, S, d]; a: [T, d, r]; b: [T, r, dout]; ids: [B]."""
    if x.device.type == "cpu":
        return multi_lora_delta_ref(x, a, b, row_task_ids, scaling)
    x3 = x[:, None, :] if x.dim() == 2 else x
    B, S, d = x3.shape
    rows = x3.reshape(B * S, d)
    ids = row_task_ids.to(torch.int32)
    if S > 1:
        ids = torch.repeat_interleave(ids, S)
    out = sgmv(rows.contiguous(), a, b, ids)
    out = out.reshape(B, S, -1) * scaling
    return (out[:, 0] if x.dim() == 2 else out).to(x.dtype)


def multi_lora_delta_ref(x, a, b, row_task_ids, scaling: float):
    """Masked-accumulation oracle. Exact; O(T) matmuls."""
    T = a.shape[0]
    xf = x.float()
    out = None
    for t in range(T):
        h = (xf @ a[t].float()) @ b[t].float()
        mask = (row_task_ids == t).float()
        mask = mask.reshape(mask.shape + (1,) * (x.dim() - 1))
        contrib = h * mask
        out = contrib if out is None else out + contrib
    return (out * scaling).to(x.dtype)
