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
from repro_torch.kernels.boundary import is_dtensor, on_replicas
from repro_torch.train.sharding import (constrain, count_reshard, fit_split,
                                        grad_in_layout)
from .common import LoraCtx, dense_init, randn
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
        w_in[e] = randn((d, in_cols), gen, device) * (1.0 / np.sqrt(d))
        w_out[e] = randn((ff, d), gen, device) * (1.0 / np.sqrt(ff))
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
    work only; no gradient flows here. Under a mesh (DTensor ids) every
    rank computes the whole dispatch from the replicated ids
    (``boundary.on_replicas``): DTensor has no sharding rule for its sorted
    search."""
    if is_dtensor(ids):
        return on_replicas(dispatch, ids, m, T, live)
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
    # drops park on one dummy row past the buffer (no mask-sized index, so
    # that the meta device's shape-only run takes it too)
    src = torch.full((E * C + 1,), -1, dtype=torch.long, device=ids.device)
    src[torch.where(keep_s, slot_s, E * C)] = order // k
    return slot.reshape(T, k), keep.reshape(T, k), src[:E * C], C


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
    xf = grad_in_layout(x.reshape(T, d))
    w, ids, probs = route(xf, p.router, m)                   # [T,k]
    if live is not None:
        live = live.reshape(T)
    slot, keep, src, C = dispatch(ids, m, T, live)
    if DROPS.on:                       # no launch when nobody counts
        dropped = ~keep if live is None else ~keep & live[:, None]
        DROPS.add(dropped.sum())

    ep = _expert_parallel(xf, m.num_experts)
    if ep is not None:
        buf = _dispatch_local(xf, src, C, ep)
    else:
        buf = xf[src.clamp(min=0)] * (src >= 0)[:, None].to(x.dtype)
        buf = buf.reshape(m.num_experts, C, d)
        buf = constrain(buf, "tp", None, None)    # expert-parallel dispatch
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
    if ep is not None:
        y = _combine_local(out_buf, slot_o, keep_o, a_w, C, ep)
    else:
        y = torch.zeros((T, d), dtype=x.dtype, device=x.device)
        for j in range(m.top_k):
            vals = out_buf[slot_o[:, j].clamp(max=m.num_experts * C - 1)]
            vals = torch.where(keep_o[:, j:j + 1], vals,
                               torch.zeros_like(vals))
            y = y + vals * a_w[:, j:j + 1]

    # over DTensors: rows split over more ranks than B rows divide are
    # made whole first, and the gradients come back in the forward's layout
    y = grad_in_layout(fit_split(y, 0, B, note="micro_rows").reshape(B, S, d))
    if p.shared is not None:
        # [B, S, d] kept, so that batched multi-LoRA row ids line up
        y = y + mlp_apply(x, p.shared, cfg.mlp_act, lora=lora, prefix="mlp")
    return y, load_balance_loss(probs, ids, m)


class _EP(NamedTuple):
    """The expert-parallel layout of one MoE layer over DTensors: the
    buffer's placements (experts split as ``constrain(buf, "tp", None,
    None)`` splits them), the token rows' placements (split over the other
    mesh dims where they divide evenly, else whole), and this rank's
    experts [e0, e0 + el) and rows [r0, r0 + rl)."""
    mesh: object
    buf_plc: tuple
    row_plc: tuple
    e0: int
    el: int
    r0: int
    rl: int


def _expert_parallel(xf, E: int) -> Optional[_EP]:
    """The layout for `xf` [T, d] when it is a DTensor on the current mesh
    and the experts split evenly; None otherwise (a plain tensor, no mesh:
    the gathered path then runs as it is)."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.train.sharding import named_sharding
    ns = named_sharding("tp", None, None)
    if not is_dtensor(xf) or ns is None or ns[0] != xf.device_mesh:
        return None
    mesh, buf_plc = ns
    coord = mesh.get_coordinate()
    e_split = r_split = 1
    e_idx = r_idx = 0
    for i, b in enumerate(buf_plc):
        if b.is_shard(0):
            e_idx = e_idx * mesh.size(i) + coord[i]
            e_split *= mesh.size(i)
        else:
            r_idx = r_idx * mesh.size(i) + coord[i]
            r_split *= mesh.size(i)
    T = xf.shape[0]
    if e_split == 1 or E % e_split:
        return None
    if T % r_split:                      # rows whole on every rank
        r_idx, r_split = 0, 1
    row_plc = tuple(Shard(0) if not b.is_shard(0) and r_split > 1
                    else Replicate() for b in buf_plc)
    el, rl = E // e_split, T // r_split
    return _EP(mesh, tuple(buf_plc), row_plc, e_idx * el, el, r_idx * rl,
               rl)


def _dispatch_local(xf, src, C: int, ep: _EP):
    """``xf[src]`` (zero rows where src < 0) as [E, C, d] in the expert-split
    placement, each rank gathering only its own experts' slots from the
    rows gathered whole. DTensor's own plan for the gather replicates the
    whole [E*C, d] buffer, and its gradient, on every rank (torch 2.11: 108
    GB a device for deepseek-moe-16b train_4k, ROADMAP §3); GSPMD keeps
    both split as the constraint asks. The gradient of the gathered rows is
    a partial sum over the expert split, whole elsewhere."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    count_reshard("moe_local")
    mesh = ep.mesh
    whole = [Replicate()] * mesh.ndim
    grad_plc = [Partial() if b.is_shard(0) else Replicate()
                for b in ep.buf_plc]
    rows = xf.redistribute(mesh, whole).to_local(grad_placements=grad_plc)
    if is_dtensor(src):
        src = src.redistribute(mesh, whole).to_local()
    E = src.shape[0] // C
    mine = src.reshape(E, C)[ep.e0:ep.e0 + ep.el]
    loc = rows[mine.clamp(min=0)] * (mine >= 0)[..., None].to(rows.dtype)
    d = rows.shape[1]
    return DTensor.from_local(loc, mesh, ep.buf_plc, run_check=False,
                              shape=(E, C, d), stride=(C * d, d, 1))


def _combine_local(out_buf, slot_o, keep_o, a_w, C: int, ep: _EP):
    """The combine of ``moe_apply`` over DTensors: each rank sums, for its
    own rows, the weighted outputs of its own experts' slots (in ascending
    expert id), and the partial sums are reduced over the expert split, so
    that no rank holds the whole [E*C, d] output buffer."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = ep.mesh
    whole = [Replicate()] * mesh.ndim
    flat_plc = ep.buf_plc          # [E*C, d]: experts' slots on dim 0 alike
    # the gradients of this rank's pieces: its rows' share of the experts'
    # outputs (partial over the row split), and its experts' share of the
    # rows' weights (partial over the expert split)
    ob = out_buf.redistribute(mesh, flat_plc).to_local(grad_placements=[
        Partial() if r.is_shard(0) else b
        for b, r in zip(flat_plc, ep.row_plc)])
    part_plc = [Partial() if b.is_shard(0) else r
                for b, r in zip(flat_plc, ep.row_plc)]

    def rows_of(t, grad=False):
        if is_dtensor(t):
            t = t.redistribute(mesh, ep.row_plc)
            return t.to_local(grad_placements=part_plc if grad else None)
        return t[ep.r0:ep.r0 + ep.rl]

    def replicated_rows(t):
        if is_dtensor(t):
            t = t.redistribute(mesh, whole).to_local()
        return t[ep.r0:ep.r0 + ep.rl]

    slot_l, keep_l = replicated_rows(slot_o), replicated_rows(keep_o)
    a_l = rows_of(a_w, grad=True)
    n = ep.el * C
    y = torch.zeros((ep.rl, ob.shape[1]), dtype=ob.dtype, device=ob.device)
    for j in range(slot_l.shape[1]):
        s = slot_l[:, j] - ep.e0 * C
        inside = keep_l[:, j] & (s >= 0) & (s < n)
        vals = ob[s.clamp(0, n - 1)]
        vals = torch.where(inside[:, None], vals, torch.zeros_like(vals))
        y = y + vals * a_l[:, j:j + 1]
    T, d = a_w.shape[0], ob.shape[1]
    y = DTensor.from_local(y, mesh, part_plc, run_check=False, shape=(T, d),
                           stride=(d, 1))
    return y.redistribute(mesh, ep.row_plc)


def load_balance_loss(probs, ids, m: MoEConfig):
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    E = m.num_experts
    f = F.one_hot(ids, E).float().sum(1).mean(0)
    P = probs.mean(0)
    return E * torch.sum(f / m.top_k * P)
