"""Fine-grained Mixture-of-Experts (deepseek-moe, dbrx); port of
``repro.models.moe``.

Dispatch as in the JAX package: the (token, expert) assignments are sorted by
expert id (a stable sort, so that the rank inside an expert, which decides
which assignment is dropped at capacity, is the JAX package's), gathered
into a dense [E, C, d] buffer of capacity C, and one batched matmul runs all
experts (the JAX package's grouped einsum, here ``torch.bmm``).

The combine is gathered, not scattered: each token reads back its own
``top_k`` slots and sums them in ascending expert id, the order in which the
JAX package's scatter-add visits a token's assignments. A scatter-add
(``index_add_``) would add them with atomics on the card, in an order that
changes from call to call, and so would the bits.

Capacity is batch-global: with ``capacity_factor`` too small, whether one
row's token is dropped depends on the other rows of the batch. ``live``
(decode: the lanes that advance) keeps a frozen or empty lane's assignments
out of the buffers, so that a live token's drop never depends on what such a
lane holds. The JAX package routes every lane; on the paged pool an empty
lane reads the scratch page, which racing duplicate writes fill differently
from run to run on the card, and a live token's drops, and so its stream,
would follow (ROADMAP §3). With nothing dropped the two agree.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig, MoEConfig
from .common import LoraCtx, dense_init
from .mlp import MLPParams, mlp_apply, mlp_init


class MoEParams(NamedTuple):
    router: torch.Tensor                 # [d, E]
    w_in: torch.Tensor                   # [E, d, ff (x2 for swiglu)]
    w_out: torch.Tensor                  # [E, ff, d]
    shared: Optional[MLPParams]          # fused shared experts (or None)


def moe_init(gen: torch.Generator, cfg: ModelConfig, dtype, device) -> MoEParams:
    """Random weights with the JAX package's shapes and scales. Each
    expert's matrices are drawn in fp32 one expert at a time and stored in
    ``dtype``, so that a full-size layer never holds an fp32 copy."""
    m = cfg.moe
    d, ff, E = cfg.d_model, m.expert_d_ff, m.num_experts
    in_cols = 2 * ff if cfg.mlp_act == "swiglu" else ff
    w_in = torch.empty((E, d, in_cols), dtype=dtype, device=device)
    w_out = torch.empty((E, ff, d), dtype=dtype, device=device)
    for e in range(E):
        w_in[e] = torch.randn((d, in_cols), generator=gen, device=device,
                              dtype=torch.float32) * (1.0 / np.sqrt(d))
        w_out[e] = torch.randn((ff, d), generator=gen, device=device,
                               dtype=torch.float32) * (1.0 / np.sqrt(ff))
    shared = (mlp_init(gen, d, m.num_shared * ff, cfg.mlp_act, dtype, device)
              if m.num_shared else None)
    return MoEParams(router=dense_init(gen, d, E, dtype, device, scale=0.02),
                     w_in=w_in, w_out=w_out, shared=shared)


def _expert_capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(n_tokens * m.top_k * m.capacity_factor / m.num_experts) + 1
    return max(8, -(-c // 8) * 8)  # round up to 8


def route(x_flat, router_w, m: MoEConfig):
    """Returns (weights [T,k], expert_ids [T,k], router_probs [T,E])."""
    logits = x_flat.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)
    w, ids = torch.topk(probs, m.top_k, dim=-1)
    w = w / w.sum(dim=-1, keepdim=True)                      # renormalise
    return w, ids, probs


def dispatch(ids, m: MoEConfig, T: int, live=None):
    """The capacity dispatch of assignments ``ids`` [T, k]: (slot [T, k] of
    each assignment in the flattened [E*C] buffer, keep [T, k] False where
    it was dropped, src [E*C] the token filling each buffer row, -1 for
    none, C). A token with ``live`` [T] False takes no capacity: its
    assignments go to a null expert E, sorted last and never kept. Integer
    work only; no gradient flows here."""
    k, E = m.top_k, m.num_experts
    A = T * k
    if live is not None:
        ids = torch.where(live[:, None], ids, E)
    flat_ids = ids.reshape(A)
    order = torch.argsort(flat_ids, stable=True)             # sort by expert
    sorted_e = flat_ids[order]
    C = _expert_capacity(T, m)
    # rank of each assignment within its expert (positions in sorted order)
    ar = torch.arange(A, device=ids.device)
    in_e_rank = ar - torch.searchsorted(sorted_e, sorted_e, side="left")
    keep_s = in_e_rank < C                                   # capacity drop
    if live is not None:
        keep_s &= sorted_e < E
    slot_s = sorted_e * C + in_e_rank
    slot = torch.empty_like(slot_s)
    keep = torch.empty_like(keep_s)
    slot[order], keep[order] = slot_s, keep_s                # back to [T*k]
    src = torch.full((E * C,), -1, dtype=torch.long, device=ids.device)
    src[slot_s[keep_s]] = order[keep_s] // k
    return slot.reshape(T, k), keep.reshape(T, k), src, C


class DropCount:
    """Assignments dropped at capacity, counted on the device while
    ``on`` (no host sync inside a forward); ``total()`` reads the sum."""

    def __init__(self):
        self.on = False
        self._parts = []

    def add(self, n):
        self._parts.append(n)

    def reset(self, on: bool = True):
        self.on, self._parts = on, []

    def total(self) -> int:
        return int(sum(int(t) for t in self._parts))


DROPS = DropCount()


def moe_apply(x, p: MoEParams, cfg: ModelConfig,
              lora: Optional[LoraCtx] = None, live=None):
    """x: [B, S, d] -> ([B, S, d], aux). Sorted-gather grouped expert
    matmul, then the fixed-order combine (module docstring). ``live``
    [B, S] or [B] (S = 1) bool: tokens that take expert capacity (all when
    None); the others get the shared experts' output only."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xf = x.reshape(T, d)
    w, ids, probs = route(xf, p.router, m)                   # [T,k]
    if live is not None:
        live = live.reshape(T)
    slot, keep, src, C = dispatch(ids, m, T, live)
    if DROPS.on:                       # no launch when nobody counts
        dropped = ~keep if live is None else ~keep & live[:, None]
        DROPS.add(dropped.sum())

    buf = xf[src.clamp(min=0)] * (src >= 0)[:, None].to(x.dtype)
    buf = buf.reshape(m.num_experts, C, d)
    h = torch.bmm(buf, p.w_in.to(x.dtype))                   # [E, C, ff']
    if cfg.mlp_act == "swiglu":
        g, u = h.chunk(2, dim=-1)
        h = F.silu(g) * u
    elif cfg.mlp_act == "squared_relu":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    out_buf = torch.bmm(h, p.w_out.to(x.dtype)).reshape(m.num_experts * C, d)

    # combine: each token's kept slots, weighted, summed in ascending
    # expert id (the JAX scatter-add's order for a token)
    kord = torch.argsort(ids, dim=1, stable=True)
    slot_o = slot.gather(1, kord)
    keep_o = keep.gather(1, kord)
    a_w = w.gather(1, kord).to(x.dtype)
    y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
    for j in range(m.top_k):
        vals = out_buf[slot_o[:, j].clamp(max=m.num_experts * C - 1)]
        vals = torch.where(keep_o[:, j:j + 1], vals, torch.zeros_like(vals))
        y = y + vals * a_w[:, j:j + 1]

    y = y.reshape(B, S, d)
    if p.shared is not None:
        # [B, S, d] kept, so that batched multi-LoRA row ids line up
        y = y + mlp_apply(x, p.shared, cfg.mlp_act, lora=lora, prefix="mlp")
    return y, load_balance_loss(probs, ids, m)


def load_balance_loss(probs, ids, m: MoEConfig):
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    E = m.num_experts
    f = F.one_hot(ids, E).float().sum(1).mean(0)
    P = probs.mean(0)
    return E * torch.sum(f / m.top_k * P)
