"""Parameter/cache/batch partition specs for the production meshes (port of
``repro.launch.shardings``), and the DTensors they place.

Rules (the JAX package's DESIGN.md §6), over logical axes dp=('pod','data')
and tp='model':

  base weights   — FSDP over dp on the embed/input dim, TP over tp on the
                   heads/ff/expert dim (MaxText-style 2D sharding);
  MoE experts    — expert axis over tp (EP), d over dp;
  Mamba blocks   — FSDP only (these archs are ≤1.2B; TP of the fused
                   in_proj would split z/x/B/C/dt across shards for no win);
  LoRA adapters  — A FSDP on d_in, B TP on d_out (matches the base matmul
                   output sharding so the delta needs no extra resharding);
  KV cache       — batch over dp; kv_heads over tp when divisible, else the
                   *sequence* dim over tp (flash-decode style);
  batch arrays   — leading (row) dim over dp unless batch==1 (long-decode).

Specs are matched by tree path suffix; anything unmatched is replicated.
The trees are the port's (``launch.specs.eval_shapes``' meta tensors, or
real ones): dicts and NamedTuples, None leaves skipped. A spec is
``train.sharding.PartitionSpec``, leaf for leaf the JAX package's;
``placements`` turns it into DTensor placements. ``with_shardings`` places a
meta shape tree as DTensors of the local shards' shapes (the dry run);
``distribute`` places real tensors that every rank holds whole.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import ModelConfig
from repro_torch.train.sharding import P, axis_sizes, placements


def _dp(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _divisible(n: int, mesh, axes) -> bool:
    if axes is None:
        return True
    axes = (axes,) if isinstance(axes, str) else axes
    sizes = axis_sizes(mesh)
    return n % math.prod(sizes[a] for a in axes) == 0


def _maybe(mesh, dim_size: int, axes):
    """Use `axes` for this dim only if it divides evenly (uneven shards
    would pad; avoid silently)."""
    return axes if _divisible(dim_size, mesh, axes) else None


def param_specs(cfg: ModelConfig, params_shapes, mesh):
    """PartitionSpec tree matching the params tree (by path)."""
    dp = _dp(mesh)
    tp = "model"

    def spec_for(path: str, shape) -> P:
        nd = len(shape.shape)
        dims = shape.shape

        def mk(*axes):
            axes = axes + (None,) * (nd - len(axes))
            return P(*[_maybe(mesh, dims[i], a) for i, a in enumerate(axes)])

        def lead():
            """Stacked per-layer weights carry a leading L axis (nd is one
            higher); that axis is never sharded."""
            return (None,) if nd in (3, 4) else ()

        if path.endswith("embed"):
            return mk(None, tp)
        if path.endswith("lm_head"):
            return mk(None, tp)
        if ("attn/" in path) or ("xattn/" in path):
            if path.endswith(("wq", "wk", "wv")):
                return mk(*lead(), dp, tp)
            if path.endswith("wo"):
                return mk(*lead(), tp, dp)
            if path.endswith(("bq", "bk", "bv")):
                return mk(*(None,) * (nd - 1), tp)
            return P()                                   # q/k norms
        if "moe/" in path and "shared/" not in path:
            if path.endswith("router"):
                return mk(None, dp, None)
            if path.endswith("w_in"):                    # [L, E, d, ff]
                return mk(None, tp, dp, None)
            if path.endswith("w_out"):                   # [L, E, ff, d]
                return mk(None, tp, None, dp)
        if path.endswith("w_in"):                        # dense/shared MLP
            return mk(*lead(), dp, tp)
        if path.endswith("w_out"):
            return mk(*lead(), tp, dp)
        if "mamba/" in path:
            if path.endswith(("in_proj", "out_proj", "conv_w")):
                return mk(*lead(), dp, None)
            return P()                                    # small vectors
        return P()                                        # norms etc.

    flat = _flatten_with_paths(params_shapes)
    return _unflatten_like(params_shapes,
                           {k: spec_for(k, v) for k, v in flat.items()})


def lora_specs(cfg: ModelConfig, lora_shapes, mesh, *, batched: bool = False):
    """A: FSDP on d_in; B: TP on d_out. Batched trees carry the task dim on
    axis 1 (never sharded — adapters are tiny)."""
    dp = _dp(mesh)
    tp = "model"
    off = 2 if batched else 1          # leading L (+T) axes unsharded

    def spec_for(path: str, shape) -> P:
        dims = shape.shape
        lead = (None,) * off
        if path.endswith("/a"):
            return P(*lead, _maybe(mesh, dims[off], dp), None)
        if path.endswith("/b"):
            ax = _maybe(mesh, dims[off + 1], tp)
            # ssm_in/ssm_out outputs stay replicated (mamba is FSDP-only)
            if "ssm" in path:
                ax = None
            return P(*lead, None, ax)
        return P()

    flat = _flatten_with_paths(lora_shapes)
    return _unflatten_like(lora_shapes,
                           {k: spec_for(k, v) for k, v in flat.items()})


def cache_specs(cfg: ModelConfig, cache_shapes, mesh, batch: int):
    dp = _dp(mesh) if batch > 1 else None
    tp = "model"

    def spec_for(path: str, shape) -> P:
        dims = shape.shape
        base = path.rsplit("/", 1)[-1]
        b_ax = None
        if dp and base in ("k", "v", "xk", "xv", "ssm", "conv"):
            b_ax = _maybe(mesh, dims[1], dp)
        if base in ("k", "v", "xk", "xv"):
            # [L, B, S, KVH, hd]
            kv_ax = _maybe(mesh, dims[3], tp)
            if kv_ax is not None:
                return P(None, b_ax, None, kv_ax, None)
            s_ax = _maybe(mesh, dims[2], tp)       # seq-sharded fallback
            return P(None, b_ax, s_ax, None, None)
        if base == "ssm":                           # [L, B, H, N, P]
            return P(None, b_ax, _maybe(mesh, dims[2], tp), None, None)
        if base == "conv":                          # [L, B, conv_dim, W-1]
            return P(None, b_ax, _maybe(mesh, dims[2], tp), None)
        if base == "pos":
            return P(_maybe(mesh, dims[0], dp) if dp else None)
        return P()

    flat = _flatten_with_paths(cache_shapes)
    return _unflatten_like(cache_shapes,
                           {k: spec_for(k, v) for k, v in flat.items()})


def batch_specs(batch_shapes, mesh, batch: int, *, wide: bool = False):
    """wide=True shards the row dim over ALL mesh axes — used by SSM/hybrid
    archs whose block weights are FSDP-only (tp-replicated): without it,
    every tp slice redundantly computes the same tokens."""
    if wide:
        dp = tuple(mesh.mesh_dim_names) if batch > 1 else None
    else:
        dp = _dp(mesh) if batch > 1 else None

    def spec_for(path: str, shape) -> P:
        dims = shape.shape
        if not dims:
            return P()
        ax = _maybe(mesh, dims[0], dp) if dp else None
        return P(ax, *([None] * (len(dims) - 1)))

    flat = _flatten_with_paths(batch_shapes)
    return _unflatten_like(batch_shapes,
                           {k: spec_for(k, v) for k, v in flat.items()})


def opt_specs(param_spec_tree):
    """Optimizer m/v mirror the param specs; step is replicated."""
    return {"m": param_spec_tree, "v": param_spec_tree, "step": P()}


# ---------------------------------------------------------------------------

def _flatten_with_paths(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten_with_paths(v, f"{prefix}{k}/"))
    elif hasattr(tree, "_fields"):                    # NamedTuple
        for k in tree._fields:
            v = getattr(tree, k)
            if v is not None:
                out.update(_flatten_with_paths(v, f"{prefix}{k}/"))
    elif tree is None:
        pass
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten_like(tree, flat: Dict[str, Any], prefix=""):
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        vals = {}
        for k in tree._fields:
            v = getattr(tree, k)
            vals[k] = (None if v is None
                       else _unflatten_like(v, flat, f"{prefix}{k}/"))
        return type(tree)(**vals)
    if tree is None:
        return None
    return flat[prefix.rstrip("/")]


def _map_specs(fn, tree, specs_tree):
    """fn(leaf, spec) over a tree and its spec tree, by path."""
    flat = _flatten_with_paths(tree)
    spec_flat = _flatten_with_paths(specs_tree)
    return _unflatten_like(tree, {k: fn(v, spec_flat[k])
                                  for k, v in flat.items()})


def local_shape(shape, spec, mesh) -> Tuple[int, ...]:
    """One rank's shard of a tensor of `shape` placed by `spec` (whose
    sharded dims divide evenly, as ``_maybe`` keeps them)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for i, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        k = math.prod(sizes[a] for a in axes)
        if out[i] % k:
            raise ValueError(f"dim {i} of {tuple(shape)} does not split "
                             f"{k} ways ({spec})")
        out[i] //= k
    return tuple(out)


def with_shardings(shapes_tree, specs_tree, mesh):
    """A tree of DTensors placed by `specs_tree` on `mesh`, each over a
    meta tensor of its local shard's shape: the shape tree as the step sees
    it, sharded, with no memory."""
    from torch.distributed.tensor import DTensor

    def attach(t, spec):
        local = torch.empty(local_shape(t.shape, spec, mesh), dtype=t.dtype,
                            device="meta")
        return DTensor.from_local(local, mesh, placements(spec, mesh),
                                  run_check=False, shape=t.shape,
                                  stride=torch.empty(t.shape,
                                                     device="meta").stride())
    return _map_specs(attach, shapes_tree, specs_tree)


def distribute(tree, specs_tree, mesh):
    """Real tensors that every rank holds whole (the same seed on each) as
    DTensors placed by `specs_tree`: each rank keeps its shard, no
    collective is issued."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()

    def place(t, spec):
        plc = placements(spec, mesh)
        local = t
        for mdim, p in enumerate(plc):
            if p.is_shard():
                local = local.chunk(mesh.size(mdim), dim=p.dim)[coord[mdim]]
        return DTensor.from_local(local.contiguous(), mesh, plc,
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())
    return _map_specs(place, tree, specs_tree)


def gather(tree):
    """Every DTensor leaf of a tree as the whole tensor (plain leaves as
    they are)."""
    from torch.distributed.tensor import DTensor
    flat = _flatten_with_paths(tree)
    return _unflatten_like(tree, {
        k: v.full_tensor() if isinstance(v, DTensor) else v
        for k, v in flat.items()})


def arg_bytes(tree) -> int:
    """Bytes of one rank's shards of a tree (DTensors' local tensors; a
    plain leaf counts whole)."""
    from torch.distributed.tensor import DTensor
    n = 0
    for v in _flatten_with_paths(tree).values():
        loc = v.to_local() if isinstance(v, DTensor) else v
        n += loc.numel() * loc.element_size()
    return n
