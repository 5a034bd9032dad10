"""Where a kernel wrapper meets its operands: which tensors take the plain
version, and the boundary for DTensor operands on the card.

- ``plain(t)``: tensors on the CPU, and on the meta device (the dry run's
  shape-only tensors, which hold no data for a kernel to read), take a
  wrapper's plain version, DTensors too: DTensor then partitions the plain
  version's ops by its own rules.
- ``on_replicas(fn, *args)``: a kernel cannot read a sharded tensor, so a
  wrapper given DTensor operands on the card redistributes each to
  Replicate, runs `fn` (the wrapper itself) on the local tensors, where the
  kernel launches, and returns replicated DTensors: what XLA does around a
  custom call it cannot partition. Redistribution, ``to_local`` and
  ``from_local`` are differentiable, so an autograd node inside `fn` (the
  token_logprob kernels) gets its backward called on local tensors too.
- ``heads_parallel(fn, q, k, v, ...)``: an attention (a plain version, or
  the model's plain attention) over DTensors, run shard by shard over rows
  and heads.
"""
from __future__ import annotations

import math
import sys

import torch


def plain(t: torch.Tensor) -> bool:
    """True for a tensor that takes a wrapper's plain version."""
    return t.device.type in ("cpu", "meta")


def is_dtensor(t) -> bool:
    """True for a DTensor (without importing DTensor where no code has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def on_replicas(fn, *args, **kwargs):
    """fn(*args, **kwargs) with each DTensor in `args` redistributed to
    Replicate on its mesh and passed as its local tensor; every tensor `fn`
    returns (alone or in a tuple) comes back as a replicated DTensor on the
    mesh of the first DTensor argument."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    rep = [Replicate()] * mesh.ndim

    def local(a):
        if isinstance(a, DTensor):
            return a.redistribute(mesh, rep).to_local()
        return a

    def wrap(o):
        if isinstance(o, torch.Tensor):
            return DTensor.from_local(o, mesh, rep, run_check=False)
        return o

    out = fn(*[local(a) for a in args], **kwargs)
    if isinstance(out, tuple):
        return tuple(wrap(o) for o in out)
    return wrap(out)


def heads_parallel(fn, q, k, v, *rest, **kwargs):
    """fn(q, k, v, *rest, **kwargs), an attention over DTensors, run shard
    by shard: every operand is laid out with its batch (dim 0) split over
    the mesh's dp axes and its heads (q's dim -2, k's and v's dim 2) over
    "model" where those divide evenly, everything else whole (a split
    sequence is gathered), and each rank attends its own rows and heads on
    local tensors. A kv head and the q heads it serves stay on one rank, so
    the result is the unsharded one's. `rest`: tensors with a batch dim
    (positions; a plain tensor counts as replicated) or other arguments. DTensor would otherwise partition the
    attention's einsums by searching every placement of their operands,
    which takes minutes on a 3-axis mesh. Returns a DTensor laid out as q."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.train.sharding import (DEFAULT_RULES, MULTIPOD_RULES,
                                            axis_sizes, count_reshard)
    mesh = q.device_mesh
    sizes = axis_sizes(mesh)
    dp = (MULTIPOD_RULES if "pod" in sizes else DEFAULT_RULES)["dp"]
    split_b = q.shape[0] % math.prod(sizes[a] for a in dp) == 0
    split_h = "model" in sizes and k.shape[2] % sizes["model"] == 0

    def layout(head_dim):
        out = []
        for name in mesh.mesh_dim_names:
            if name in dp and split_b:
                out.append(Shard(0))
            elif name == "model" and split_h and head_dim is not None:
                out.append(Shard(head_dim))
            else:
                out.append(Replicate())
        return out

    moved = []

    def local(t, head_dim):
        if not isinstance(t, torch.Tensor):
            return t
        if not isinstance(t, DTensor):      # a plain tensor is replicated
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        plc = layout(head_dim)
        moved.append(tuple(t.placements) != tuple(plc))
        return t.redistribute(mesh, plc).to_local()

    qd = q.ndim - 2
    out = fn(local(q, qd), local(k, 2), local(v, 2),
             *[local(r, None) for r in rest], **kwargs)
    if any(moved):
        count_reshard("attention_heads")
    return DTensor.from_local(out, mesh, layout(qd), run_check=False)
