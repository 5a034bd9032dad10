"""Logical-axis sharding helpers (port of ``repro.train.sharding``).

Models annotate activations with *logical* axes ("dp", "tp", "sp"); the
launcher installs a mesh (a ``torch.distributed.device_mesh.DeviceMesh``)
and logical→physical rules, and an annotation becomes a DTensor
``redistribute``. Outside a mesh context, and on plain tensors, annotations
are no-ops, so the same model code runs single-device tests, the host mesh
and the fake-process-group dry run unchanged.

A spec (``PartitionSpec``, ``P``) has the JAX ``PartitionSpec``'s form: one
entry per tensor dim, each None, a mesh axis name or a tuple of names
(major to minor). ``placements`` turns it into DTensor placements, one per
mesh dim. Nothing here touches ``torch.distributed`` until it is given a
DTensor.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.kernels.boundary import is_dtensor

_TLS = threading.local()

# default logical→physical rules (single-pod); launcher overrides for multi-pod
DEFAULT_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "dp": ("data",),         # batch / fsdp axis
    "tp": ("model",),        # tensor / expert axis
    "sp": ("model",),        # sequence axis for sharded long-KV decode
    None: None,
}

MULTIPOD_RULES: Dict[str, Union[str, Tuple[str, ...], None]] = {
    "dp": ("pod", "data"),
    "tp": ("model",),
    "sp": ("model",),
    None: None,
}


def _entry(e):
    """A spec entry in normal form, as JAX's PartitionSpec keeps it: no
    axis (an empty tuple) is None, one axis is its name."""
    if isinstance(e, (tuple, list)):
        e = tuple(e)
        return None if not e else (e[0] if len(e) == 1 else e)
    return e


class PartitionSpec(tuple):
    """A tensor's sharding over mesh axes, one entry per leading tensor dim
    (trailing dims left out are replicated): None, an axis name, or a tuple
    of names that split the dim together, major first."""

    def __new__(cls, *entries):
        return super().__new__(cls, (_entry(e) for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def _state():
    if not hasattr(_TLS, "mesh"):
        _TLS.mesh = None
        _TLS.rules = DEFAULT_RULES
        _TLS.reshards = {}
    return _TLS


@contextlib.contextmanager
def mesh_context(mesh, rules=None):
    """Install `mesh` (or None) and its rules for this thread: the multi-pod
    rules when the mesh has a "pod" axis, else the default ones. The
    context's reshards (``constrain(..., note=)``) start at none."""
    st = _state()
    prev = (st.mesh, st.rules, st.reshards)
    st.mesh = mesh
    st.rules = rules or (MULTIPOD_RULES if (
        mesh is not None and "pod" in mesh.mesh_dim_names) else DEFAULT_RULES)
    st.reshards = {}
    try:
        yield
    finally:
        st.mesh, st.rules, st.reshards = prev


def reshard_log() -> Dict[str, int]:
    """{note: count} of the noted constraints that moved data in this
    thread's mesh context."""
    return dict(_state().reshards)


def current_mesh():
    return _state().mesh


def resolve(*logical) -> P:
    rules = _state().rules
    phys = []
    for ax in logical:
        if ax is None:
            phys.append(None)
        elif isinstance(ax, (tuple, list)):
            flat = []
            for a in ax:
                r = rules.get(a, None)
                if r is None:
                    continue
                flat.extend([r] if isinstance(r, str) else list(r))
            phys.append(tuple(flat) if flat else None)
        else:
            r = rules.get(ax, None)
            if r is None:
                phys.append(None)
            elif isinstance(r, str):
                phys.append(r)
            else:
                phys.append(r if len(r) > 1 else r[0])
    return P(*phys)


def axis_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a DeviceMesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def placements(spec, mesh) -> tuple:
    """The DTensor placements of `spec` on `mesh`: Shard(i) on each mesh
    dim that tensor dim i is split over, Replicate on the others. A dim
    split over several axes takes them major to minor, as in JAX; DTensor
    splits over mesh dims in mesh order, so the spec's axes must come in
    the mesh's order (the rules' ("pod", "data") does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {dim} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec} uses axis {names[i]} twice")
            out[i] = Shard(dim)
    return tuple(out)


def constrain(x, *logical, note: Optional[str] = None):
    """Redistribute a DTensor to the logical axes' placements on the
    current mesh; `x` itself with no mesh or for a plain tensor. `note`
    names a reshard that the port adds where DTensor refuses what GSPMD
    does on its own; each one that changes the placements is counted
    (``reshard_log``)."""
    mesh = current_mesh()
    if mesh is None or not is_dtensor(x):
        return x
    plc = placements(resolve(*logical), mesh)
    if note is not None and tuple(x.placements) != plc:
        count_reshard(note)
    return x.redistribute(mesh, plc)


def named_sharding(*logical) -> Optional[tuple]:
    """(mesh, placements) of the logical axes, or None with no mesh."""
    mesh = current_mesh()
    if mesh is None:
        return None
    return mesh, placements(resolve(*logical), mesh)


def count_reshard(name: str):
    """Count one reshard of the kind `name` that the port adds where
    DTensor refuses what GSPMD does on its own (``reshard_log``)."""
    log = _state().reshards
    log[name] = log.get(name, 0) + 1


def fit_split(x, dim: int, lead: int, *, note: str):
    """x ready for a view that splits tensor dim `dim` into (`lead`, ...):
    a DTensor split over that dim more ways than `lead` divides (8 kv heads
    of a dim split 16 ways) is made whole there first, its other placements
    kept; GSPMD reshards across such a view by itself, DTensor refuses it.
    `x` itself otherwise."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    mesh = x.device_mesh
    k = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            k *= mesh.size(i)
    if lead % k == 0:
        return x
    count_reshard(note)
    return x.redistribute(mesh, [Replicate() if p.is_shard(dim) else p
                                 for p in x.placements])


def reduce_pending(x, *, note: str):
    """A DTensor with its pending (Partial) sums reduced, its other
    placements kept; `x` itself otherwise. For a result that DTensor
    cannot carry through the next op while still pending (a gather from a
    vocab-sharded matrix, then an index into it)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    from torch.distributed.tensor import Replicate
    count_reshard(note)
    return x.redistribute(x.device_mesh, [Replicate() if p.is_partial()
                                          else p for p in x.placements])


def shard_offset(x, dim: int) -> int:
    """The global index of the first entry of this rank's shard of DTensor
    `x` along tensor dim `dim` (even shards, as the specs keep them)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    k = 0
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            k = k * mesh.size(i) + coord[i]
    return k * x.to_local().shape[dim]


def settle_partial(y, x, *, note: str):
    """A matmul's DTensor result `y` with its pending sums (Partial, where
    the contraction dim of the input `x` was split) reduced: scattered over
    the dim `x` was split over on that mesh dim when it is not the
    contraction dim, else replicated. `y` itself when nothing is pending.
    torch 2.11's DTensor otherwise picks, for the next add of a sharded
    tensor, a plan that needs Shard → Partial, which it cannot run."""
    if not is_dtensor(y) or not any(p.is_partial() for p in y.placements):
        return y
    from torch.distributed.tensor import Replicate
    plc = []
    for i, p in enumerate(y.placements):
        if p.is_partial():
            q = x.placements[i] if is_dtensor(x) else Replicate()
            keep = q.is_shard() and q.dim % x.ndim != x.ndim - 1
            p = q if keep else Replicate()
        plc.append(p)
    count_reshard(note)
    return y.redistribute(y.device_mesh, plc)


def local_contiguous(x):
    """A DTensor whose local tensor is laid out contiguously (copied when it
    is not); `x` itself otherwise. DTensor takes a reshape for a view when
    the global strides allow one, whatever its local tensor's strides are,
    and an op before may leave the local tensor transposed."""
    if not is_dtensor(x) or x._local_tensor.is_contiguous():
        return x
    return x.clone(memory_format=torch.contiguous_format)


def grad_in_layout(x):
    """`x` (a DTensor) unchanged, whose gradient comes back in `x`'s own
    placements (replicated where `x` was a pending sum), its local tensor
    contiguous (``local_contiguous``). Put on a matmul's operands and
    result, and on each layer's adapter slice: the backward of a reshape
    before or after takes the gradient for a view in the forward's layout;
    and torch 2.11's DTensor cannot add a pending-sum gradient to a
    sharded one from another path (Shard → Partial). `x` itself for a
    plain tensor."""
    if not is_dtensor(x):
        return x
    return _GradInLayout.apply(x)


class _GradInLayout(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        ctx.placements = tuple(t.placements)
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        plc = tuple(Replicate() if f.is_partial() else f
                    for f in ctx.placements)
        if tuple(g.placements) != plc:
            g = g.redistribute(g.device_mesh, plc)
        return local_contiguous(g)


def matmul(x, w):
    """x @ w. Over DTensors its operands and result hand their gradients
    back in their own layouts (``grad_in_layout``), and a 3-D x [B, S, d]
    is folded to rows by hand, its product's rows made whole before they
    unfold when they do not split over the ranks as B rows (``fit_split``;
    a micro-batch of 8 rows on 16 data ranks): DTensor may split the
    folded rows, then refuses to unfold them."""
    if not is_dtensor(x):
        return x @ w
    x = grad_in_layout(x)
    if x.ndim != 3:
        return grad_in_layout(x @ w)
    B, S, d = x.shape
    y = grad_in_layout(x.reshape(B * S, d)) @ w
    y = fit_split(y, 0, B, note="micro_rows").reshape(B, S, -1)
    return grad_in_layout(y)


def vocab_gather(logits, t):
    """``torch.gather(logits, -1, t[..., None])[..., 0]``. Over a DTensor
    split over its last dim (the vocabulary), each rank picks the targets
    that fall in its own slice and the picks are summed, as GSPMD
    partitions the gather (DTensor's own plan for it builds a mask with an
    op the meta device lacks)."""
    if not is_dtensor(logits):
        return torch.gather(logits, -1, t[..., None])[..., 0]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    logits = reduce_pending(logits, note="vocab_gather")
    mesh, nd = logits.device_mesh, logits.ndim
    t_plc = [Replicate() if p.is_shard(nd - 1) else p
             for p in logits.placements]
    if not is_dtensor(t):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    t_loc = t.redistribute(mesh, t_plc).to_local()
    loc = logits.to_local()
    idx = t_loc.long() - shard_offset(logits, nd - 1)
    inside = (idx >= 0) & (idx < loc.shape[-1])
    pick = torch.gather(loc, -1, idx.clamp(0, loc.shape[-1] - 1)[..., None])
    pick = pick[..., 0] * inside
    out = [Partial() if p.is_shard(nd - 1) else q
           for p, q in zip(logits.placements, t_plc)]
    pick = DTensor.from_local(pick, mesh, out, run_check=False,
                              shape=t.shape, stride=t.contiguous().stride())
    return reduce_pending(pick, note="vocab_gather")
