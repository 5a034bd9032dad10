"""Shared building blocks: device and dtype helpers, RMSNorm, RoPE,
projections (port of ``repro.models.common``).

Parameters are plain dicts of tensors with per-layer weights stacked on a
leading layer axis, the same tree as the JAX package, so that
``repro_torch.bridge`` carries weights over leaf for leaf.

LoRA hook: every linear projection funnels through :func:`proj`, which takes
an optional ``LoraCtx`` — single-task adapters or batched multi-LoRA rows
(paper §4.5), see ``repro_torch.lora``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.lora.multilora import multi_lora_delta

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default of every
    entry point) raises when no card is present: the port never falls back
    to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def synchronize(device: torch.device):
    """Wait for queued device work, so that a host clock read after it
    measures the work and not its enqueue."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    w = torch.randn((vocab, d), generator=gen, device=device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def rmsnorm(x, weight, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * (1.0 + weight.float())).to(dt)
    # (1 + w): gemma-style zero-centered scale; init weight to 0.


def rmsnorm_init(d: int, dtype, device):
    return torch.zeros((d,), dtype=dtype, device=device)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float32) / head_dim))


def rope_tables(positions, head_dim: int, theta: float):
    """(sin, cos) of the rotary angles, [..., S, 1, hd/2] each, for
    positions broadcastable to [..., S]. Every layer of a forward shares
    them, so the model computes them once per call: the frequencies come
    from the host (numpy, as in the JAX package), and a copy from pageable
    host memory waits for the stream, so once per layer would stall the
    host behind the device at every layer."""
    freqs = torch.from_numpy(rope_freqs(head_dim, theta)).to(positions.device)
    angles = positions[..., None].float() * freqs             # [..., S, hd/2]
    return torch.sin(angles)[..., None, :], torch.cos(angles)[..., None, :]


def apply_rope(x, positions, theta: float, tables=None):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]; `tables`:
    ``rope_tables(positions, hd, theta)`` when the caller has them."""
    sin, cos = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# the LoRA-aware projection seam
# ---------------------------------------------------------------------------

class LoraCtx:
    """Carries adapter state through a forward pass.

    mode = "off"     — no adapters (base model / reference policy)
    mode = "single"  — one task's adapters (training, single-task rollout)
    mode = "batched" — stacked [T, ...] adapters + per-row task ids
                       (multi-LoRA cross-task rollout, paper §4.5)

    Unlike the JAX package there is no ``use_kernel`` switch: the batched
    delta launches the SGMV kernel whenever its tensors lie on the card.
    """

    def __init__(self, mode: str, tree=None, row_task_ids=None,
                 scaling: float = 1.0):
        self.mode = mode
        self.tree = tree            # {target: {"a": ..., "b": ...}} (stacked L)
        self.row_task_ids = row_task_ids
        self.scaling = scaling

    def at_layer(self, layer_tree):
        """Return a shallow ctx bound to one layer's adapter slices."""
        return LoraCtx(self.mode, layer_tree, self.row_task_ids, self.scaling)

    def delta(self, x, name: str):
        """LoRA contribution for projection `name`, or None."""
        if self.mode == "off" or self.tree is None or name not in self.tree:
            return None
        a = self.tree[name]["a"]
        b = self.tree[name]["b"]
        if self.mode == "single":
            h = x.to(a.dtype) @ a                # [..., r]
            return (self.scaling * (h @ b)).to(x.dtype)
        # batched multi-LoRA: a [T, d, r], b [T, r, dout]; rows carry task ids
        return multi_lora_delta(x, a, b, self.row_task_ids, self.scaling)


def proj(x, w, b=None, *, lora: Optional[LoraCtx] = None, name: str = ""):
    """y = x @ w (+ b) (+ lora delta). x: [..., d_in], w: [d_in, d_out]."""
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    if lora is not None:
        d = lora.delta(x, name)
        if d is not None:
            y = y + d.to(y.dtype)
    return y


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x
