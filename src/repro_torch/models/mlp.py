"""Dense MLP variants: swiglu (most archs), squared-ReLU (nemotron-4),
gelu (seamless). Port of ``repro.models.mlp``."""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from .common import LoraCtx, dense_init, proj


class MLPParams(NamedTuple):
    w_in: torch.Tensor               # [d, ff] (up; or gate+up fused for swiglu)
    w_out: torch.Tensor              # [ff, d]


def mlp_init(gen, d: int, ff: int, act: str, dtype, device) -> MLPParams:
    in_cols = 2 * ff if act == "swiglu" else ff
    return MLPParams(w_in=dense_init(gen, d, in_cols, dtype, device),
                     w_out=dense_init(gen, ff, d, dtype, device))


def mlp_apply(x, p: MLPParams, act: str, lora: Optional[LoraCtx] = None,
              prefix: str = "mlp"):
    h = proj(x, p.w_in, lora=lora, name=f"{prefix}_in")
    if act == "swiglu":
        gate, up = h.chunk(2, dim=-1)
        h = F.silu(gate) * up
    elif act == "squared_relu":
        h = torch.square(F.relu(h))
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")      # jax.nn.gelu's default
    else:
        raise ValueError(act)
    return proj(h, p.w_out, lora=lora, name=f"{prefix}_out")
