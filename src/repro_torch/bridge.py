"""Carries the JAX package's parameters and adapters over to the port.

Both take trees whose leaves are numpy arrays (``jax.device_get`` of the JAX
trees, or ``np.asarray`` leaf by leaf) — the port never imports jax. The
port keeps JAX's ``[d_in, d_out]`` weight orientation and its tree, so the
bridge is a copy and not a transpose: dicts stay dicts, the JAX package's
``AttnParams`` / ``MLPParams`` NamedTuples become the port's of the same
name and fields, and each array becomes a tensor of the same dtype (bf16
included, through its 16-bit pattern).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.attention import AttnParams
from repro_torch.models.common import resolve_device
from repro_torch.models.mlp import MLPParams

_TUPLES = {"AttnParams": AttnParams, "MLPParams": MLPParams}


def _tensor(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":           # ml_dtypes' bfloat16
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).astype(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _convert(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = _TUPLES.get(type(tree).__name__)
        if cls is None or tuple(cls._fields) != tuple(tree._fields):
            raise TypeError(f"no port counterpart for {type(tree).__name__}")
        return cls(*(_convert(v, device) for v in tree))
    return _tensor(tree, device)


def params_from_jax(tree, cfg: ModelConfig, device="cuda"):
    """The JAX package's ``init_params`` tree (numpy leaves) as the port's
    parameters on ``device``."""
    dev = resolve_device(device)
    out = _convert(tree, dev)
    emb = out["embed"]
    if tuple(emb.shape) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {tuple(emb.shape)} does not fit {cfg.name}")
    return out


def lora_from_jax(tree, device="cuda"):
    """A JAX adapter tree (``init_lora``, numpy leaves) on ``device``."""
    return _convert(tree, resolve_device(device))
