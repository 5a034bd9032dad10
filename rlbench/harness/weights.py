"""The builder of the dense decoder family (Qwen3's layout): a
configuration file names it under ``builder``, and the harness finds it
there (``cell.load_module``). A builder gives the widths the yardstick
counts (``shape``), the weights from the seed, made on the device in a few
large draws in the dtype they are served in (``make_base``: the
configuration's ``torch_dtype``; ``make_adapters``: fp32), and the
program's view of them (``port_config``, ``port_params``). Another family
brings a builder of its own beside its reference.

The layout is the benchmark's own, per-layer weights stacked on a leading
layer axis, ``x @ W`` orientation:
  embed [V, d]; final_norm [d]; ln1, ln2 [L, d]; q_norm, k_norm [L, hd];
  wq [L, d, H·hd]; wk, wv [L, d, KVH·hd]; wo [L, H·hd, d];
  w_in [L, d, 2·ff] (gate columns first, then up); w_out [L, ff, d].
An RMSNorm's scale is 1 + w for the stored w. Adapters: per tenant and
target, a [L, d_in, r] and b [L, r, d_out]; a target's delta is
scaling · (x a) b.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from .yardstick import Shape

Weights = Dict[str, torch.Tensor]


def _gen(seed: int, salt: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + salt) % (2 ** 63))
    return g


def shape(cfg: Dict[str, Any]) -> Shape:
    """The widths of the configuration file `cfg`."""
    lora = cfg["lora"]
    return Shape(layers=cfg["num_hidden_layers"], d=cfg["hidden_size"],
                 heads=cfg["num_attention_heads"],
                 kv_heads=cfg["num_key_value_heads"],
                 head_dim=cfg["head_dim"], ff=cfg["intermediate_size"],
                 vocab=cfg["vocab_size"], lora_rank=lora["rank"],
                 lora_targets=tuple(lora["targets"]))


def port_config(cfg: Dict[str, Any]):
    """The program's ModelConfig for a configuration file: the family, the
    MLP's activation and the qk-norm as the file states them."""
    from repro_torch.configs.base import LoRAConfig, ModelConfig
    lora = cfg["lora"]
    return ModelConfig(
        name=cfg["name"], family=cfg["family"],
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"], head_dim=cfg["head_dim"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        mlp_act=cfg["mlp_act"], qk_norm=bool(cfg["qk_norm"]),
        rope_theta=float(cfg["rope_theta"]),
        tie_embeddings=bool(cfg["tie_word_embeddings"]),
        norm_eps=float(cfg["rms_norm_eps"]), dtype=cfg["torch_dtype"],
        lora=LoRAConfig(rank=lora["rank"], alpha=float(lora["alpha"]),
                        targets=tuple(lora["targets"]), dtype=lora["dtype"]))


def port_params(w: Weights):
    """The benchmark's weights as the program's parameter tree (views)."""
    from repro_torch.models.attention import AttnParams
    from repro_torch.models.mlp import MLPParams
    return {"embed": w["embed"], "final_norm": w["final_norm"],
            "layers": {"ln1": w["ln1"], "ln2": w["ln2"],
                       "attn": AttnParams(wq=w["wq"], wk=w["wk"], wv=w["wv"],
                                          wo=w["wo"], q_norm=w["q_norm"],
                                          k_norm=w["k_norm"]),
                       "mlp": MLPParams(w_in=w["w_in"], w_out=w["w_out"])}}


def make_base(cfg: Dict[str, Any], seed: int, device) -> Weights:
    """The base model's weights in the configuration's dtype, from `seed`."""
    s = shape(cfg)
    norm_w_std = cfg["norm_w_std"]
    dtype = getattr(torch, cfg["torch_dtype"])
    g = _gen(seed, 1, device)
    L, d, hd = s.layers, s.d, s.head_dim

    def draw(shape, std):
        t = torch.randn(shape, generator=g, device=device, dtype=dtype)
        return t.mul_(std)

    return {
        "embed": draw((s.vocab, d), 0.02),
        "final_norm": draw((d,), norm_w_std),
        "ln1": draw((L, d), norm_w_std),
        "ln2": draw((L, d), norm_w_std),
        "q_norm": draw((L, hd), norm_w_std),
        "k_norm": draw((L, hd), norm_w_std),
        "wq": draw((L, d, s.q_dim), d ** -0.5),
        "wk": draw((L, d, s.kv_dim), d ** -0.5),
        "wv": draw((L, d, s.kv_dim), d ** -0.5),
        "wo": draw((L, s.q_dim, d), s.q_dim ** -0.5),
        "w_in": draw((L, d, 2 * s.ff), d ** -0.5),
        "w_out": draw((L, s.ff, d), s.ff ** -0.5),
    }


def make_adapters(cfg: Dict[str, Any], tenants: int, seed: int, device
                  ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """Each tenant's fp32 adapters {target: {"a", "b"}}, drawn per target
    for all tenants at once: a ~ N(0, 1/d_in), b ~ N(0, b_std²)."""
    s = shape(cfg)
    b_std = cfg["lora"]["b_std"]
    g = _gen(seed, 2, device)
    out: List[Dict[str, Dict[str, torch.Tensor]]] = [{} for _ in range(tenants)]
    for tgt in s.lora_targets:
        d_in, d_out = s.target_dims(tgt)
        a = torch.randn((tenants, s.layers, d_in, s.lora_rank), generator=g,
                        device=device).mul_(d_in ** -0.5)
        b = torch.randn((tenants, s.layers, s.lora_rank, d_out), generator=g,
                        device=device).mul_(b_std)
        for t in range(tenants):
            out[t][tgt] = {"a": a[t], "b": b[t]}
    return out
