"""Per-task LoRA adapters (paper §4.2: θ_t^(v)); port of
``repro.lora.adapters``.

Tree layout (uniform across families):
  {"layers": {target: {"a": [L, d_in, r], "b": [L, r, d_out]}},
   "shared": {target: {"a": [n_inv, d_in, r], ...}}}   # hybrid only

`a` is gaussian-initialized, `b` zero-initialized → adapters start as the
identity (policy v0 == base model).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.common import LoraCtx, dtype_of, randn, resolve_device


# projection in/out dims per target name
def target_dims(cfg: ModelConfig, target: str) -> Tuple[int, int]:
    d = cfg.d_model
    if target == "attn_q":
        return d, cfg.q_dim
    if target == "attn_k" or target == "attn_v":
        return d, cfg.kv_dim
    if target == "attn_o":
        return cfg.q_dim, d
    if target == "mlp_in":
        ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.num_shared:
            ff = cfg.moe.num_shared * cfg.moe.expert_d_ff
        cols = 2 * ff if cfg.mlp_act == "swiglu" else ff
        return d, cols
    if target == "mlp_out":
        ff = cfg.d_ff
        if cfg.moe is not None and cfg.moe.num_shared:
            ff = cfg.moe.num_shared * cfg.moe.expert_d_ff
        return ff, d
    if target == "ssm_in":
        s = cfg.ssm
        d_in = s.d_inner(d)
        return d, 2 * d_in + 2 * s.n_groups * s.state_dim + s.num_heads(d)
    if target == "ssm_out":
        return cfg.ssm.d_inner(d), d
    raise ValueError(target)


def applicable_targets(cfg: ModelConfig) -> Dict[str, Tuple[str, ...]]:
    """Which configured targets apply, split by layers/shared subtree."""
    t = cfg.lora.targets
    if cfg.family == "ssm":
        layers = tuple(x for x in t if x.startswith("ssm"))
        return {"layers": layers or ("ssm_in", "ssm_out"), "shared": ()}
    if cfg.family == "hybrid":
        layers = tuple(x for x in t if x.startswith("ssm")) or ("ssm_in", "ssm_out")
        shared = tuple(x for x in t if x.startswith(("attn", "mlp")))
        return {"layers": layers, "shared": shared}
    if cfg.moe is not None:
        # adapters on attention (+ shared-expert MLP if present)
        layers = tuple(x for x in t if x.startswith("attn")
                       or (x.startswith("mlp") and cfg.moe.num_shared))
        return {"layers": layers, "shared": ()}
    layers = tuple(x for x in t if x.startswith(("attn", "mlp")))
    return {"layers": layers, "shared": ()}


def init_lora(cfg: ModelConfig, generator: torch.Generator,
              device="cuda") -> Dict[str, Any]:
    """Fresh adapters: gaussian `a` scaled by 1/sqrt(d_in), zero `b` — so the
    delta is 0 until `b` is trained (or randomised by a test)."""
    dev = resolve_device(device)
    lc = cfg.lora
    dt = dtype_of(lc.dtype)
    tmap = applicable_targets(cfg)
    tree: Dict[str, Any] = {}

    def make(n_stack: int, target: str):
        d_in, d_out = target_dims(cfg, target)
        a = (randn((n_stack, d_in, lc.rank), generator, dev)
             * (1.0 / np.sqrt(d_in))).to(dt)
        b = torch.zeros((n_stack, lc.rank, d_out), dtype=dt, device=dev)
        return {"a": a, "b": b}

    if tmap["layers"]:
        tree["layers"] = {tgt: make(cfg.num_layers, tgt)
                          for tgt in tmap["layers"]}
    if tmap["shared"]:
        n_inv = cfg.num_layers // cfg.hybrid_attn_every
        tree["shared"] = {tgt: make(n_inv, tgt) for tgt in tmap["shared"]}
    return tree


def single_ctx(tree, cfg: ModelConfig) -> LoraCtx:
    """One task's adapters for the whole forward (training mode)."""
    return LoraCtx("single", tree, scaling=cfg.lora.scaling)


def batched_ctx(stacked_tree, row_task_ids, cfg: ModelConfig) -> LoraCtx:
    # step: tensors=stacked_tree,row_task_ids
    """stacked_tree: task-stacked adapters (``stack_adapters``); the batched
    delta runs the SGMV kernel when the tensors lie on the card."""
    return LoraCtx("batched", stacked_tree, row_task_ids,
                   scaling=cfg.lora.scaling)


def stack_adapters(trees):
    """[{...}, {...}] -> one tree with the task dim on axis 1: leaves become
    [L, T, d, r], so a layer slice ``leaf[i]`` is a contiguous [T, d, r]
    (single-task [L, d, r] slices to [d, r] the same way)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_adapters([t[k] for t in trees]) for k in first}
    return torch.stack(trees, dim=1).contiguous()


def init_stacked_buffer(tree, capacity: int, device=None):
    """Zeroed fixed-capacity stacked-LoRA buffer shaped like
    ``stack_adapters([tree] * capacity)``: leaves [L, capacity, ...] in the
    leaves' dtype, on `device` (default: the leaves' device).

    Zero is the identity adapter (b == 0 => delta == 0), so unoccupied
    slots are inert: a row routed at an empty slot sees the base model."""
    if isinstance(tree, dict):
        return {k: init_stacked_buffer(v, capacity, device)
                for k, v in tree.items()}
    return torch.zeros((tree.shape[0], capacity) + tuple(tree.shape[1:]),
                       dtype=tree.dtype,
                       device=tree.device if device is None else device)


def write_adapter_slot(buf, tree, index: int):
    """Install `tree` at slot `index` of a stacked buffer, IN PLACE (the JAX
    package returns a new buffer with ``.at[:, i].set``): ``buf[:, index] =
    leaf`` for every leaf, cast and moved to the buffer's dtype and
    device."""
    if isinstance(buf, dict):
        for k, v in buf.items():
            write_adapter_slot(v, tree[k], index)
        return
    buf[:, index].copy_(tree)
