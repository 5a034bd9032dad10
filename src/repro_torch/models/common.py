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

from repro_torch.kernels.boundary import is_dtensor, plain
from repro_torch.kernels.sgmv import check_adapters, sgmv_add_, sgmv_table
from repro_torch.lora.multilora import multi_lora_delta
from repro_torch.train.sharding import matmul, settle_partial

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

def _draw(fn, shape, gen, device):
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.float32, device=device)
    return fn(shape, generator=gen, device=device, dtype=torch.float32)


def randn(shape, gen: Optional[torch.Generator], device):
    """fp32 N(0, 1) draws from `gen` on `device`. On the meta device (the
    shape trees of ``launch.specs``) nothing is drawn or allocated, and
    `gen` may be None; every other device needs its generator."""
    return _draw(torch.randn, shape, gen, device)


def rand(shape, gen: Optional[torch.Generator], device):
    """fp32 U[0, 1) draws, as ``randn``."""
    return _draw(torch.rand, shape, gen, device)


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype, device,
               scale: float = None):
    scale = scale if scale is not None else 1.0 / np.sqrt(d_in)
    return (randn((d_in, d_out), gen, device) * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype, device):
    return (randn((vocab, d), gen, device) * 0.02).to(dtype)


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
    A batched ctx on the card checks its adapters once, when it is built,
    and builds the rows' segment table once a forward (per rows-per-sequence
    S) on first use; the layer ctxs of ``at_layer`` share both.
    """

    def __init__(self, mode: str, tree=None, row_task_ids=None,
                 scaling: float = 1.0, *, _tables=None):
        self.mode = mode
        self.tree = tree            # {target: {"a": ..., "b": ...}} (stacked L)
        self.row_task_ids = row_task_ids
        self.scaling = scaling
        self._tables = _tables      # S -> SgmvTable, shared with layer ctxs
        if mode == "batched" and _tables is None:
            self._tables = {}
            for pair in _adapter_pairs(tree):
                if pair["a"].is_cuda and not is_dtensor(pair["a"]):
                    check_adapters(pair["a"], pair["b"])

    def at_layer(self, layer_tree):
        """Return a shallow ctx bound to one layer's adapter slices."""
        return LoraCtx(self.mode, layer_tree, self.row_task_ids, self.scaling,
                       _tables=self._tables)

    def delta(self, x, name: str):
        """LoRA contribution for projection `name`, or None."""
        if self.mode == "off" or self.tree is None or name not in self.tree:
            return None
        a = self.tree[name]["a"]
        b = self.tree[name]["b"]
        if self.mode == "single":
            h = matmul(x.to(a.dtype), a)                 # [..., r]
            return (self.scaling * matmul(h, b)).to(x.dtype)
        # batched multi-LoRA: a [T, d, r], b [T, r, dout]; rows carry task ids
        return multi_lora_delta(x, a, b, self.row_task_ids, self.scaling)

    def add_delta(self, y, x, name: str):
        """y plus the LoRA contribution for projection `name`. A batched ctx
        on the card adds it into y in place, in one SGMV launch
        (``sgmv_add_``: what ``y + delta(x).to(y.dtype)`` gives, to the
        bit); every other case returns ``y + delta(x).to(y.dtype)``."""
        if self.mode == "off" or self.tree is None or name not in self.tree:
            return y
        if self.mode == "batched" and not plain(x):
            a, b = self.tree[name]["a"], self.tree[name]["b"]
            S = x.shape[1] if x.dim() == 3 else 1
            table = self._tables.get(S)
            if table is None:
                ids = self.row_task_ids
                if is_dtensor(ids):
                    ids = ids.full_tensor()
                table = self._tables[S] = sgmv_table(ids, a.shape[0], S)
            # DTensor adapters are checked in their replicas, each call
            return sgmv_add_(y, x.contiguous(), a, b, table, self.scaling,
                             checked=not is_dtensor(a))
        return y + self.delta(x, name).to(y.dtype)


def _adapter_pairs(tree):
    """Every {"a", "b"} node of an adapter tree."""
    if not isinstance(tree, dict):
        return []
    if "a" in tree and "b" in tree:
        return [tree]
    return [p for v in tree.values() for p in _adapter_pairs(v)]


def proj(x, w, b=None, *, lora: Optional[LoraCtx] = None, name: str = ""):
    """y = x @ w (+ b) (+ lora delta). x: [..., d_in], w: [d_in, d_out].
    Over DTensors the product's pending sums are reduced first
    (``sharding.settle_partial``); ``sharding.matmul`` is ``@`` on plain
    tensors."""
    y = settle_partial(matmul(x, w.to(x.dtype)), x, note="proj_partial")
    if b is not None:
        y = y + b.to(y.dtype)
    if lora is not None:
        y = lora.add_delta(y, x, name)
    return y


def softcap(x, cap: float):
    return torch.tanh(x / cap) * cap if cap else x
