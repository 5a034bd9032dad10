"""Model assembly for the dense family: init / prefill / decode (port of the
dense half of ``repro.models.model``).

The parameter tree is the JAX package's: per-layer weights stacked on a
leading layer axis. Where the JAX package ``lax.scan``s over that axis, the
port loops over it in Python.

The KV cache is a plain dict of tensors, updated IN PLACE (JAX's arrays are
immutable, so its functions return a new cache; the port writes into the
one it is given, which saves a copy of the cache per call, and returns the
same dict with a new ``pos``):
  k, v        [L, B, Smax, KVH, hd]
  pos         [B] int32 — valid entries per row
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs import ModelConfig
from .attention import attention_chunked, attention_decode, attn_init, qkv
from .common import (LoraCtx, dense_init, dtype_of, embed_init, proj,
                     resolve_device, rmsnorm, rmsnorm_init, rope_tables,
                     softcap)
from .mlp import mlp_apply, mlp_init

Params = Dict[str, Any]

_FAMILIES = ("dense", "vlm")       # the block stacks this slice ports


def _check_family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (have {_FAMILIES})")


# ===========================================================================
# init
# ===========================================================================

def _stack(trees):
    """Stack a list of same-shaped trees on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):               # AttnParams / MLPParams
        return type(first)(*(None if f is None else _stack([t[j] for t in trees])
                             for j, f in enumerate(first)))
    return torch.stack(trees)


def tree_map(fn, tree):
    """fn over every tensor leaf of a parameter tree (dicts and the
    ``AttnParams``/``MLPParams`` NamedTuples; None leaves stay None)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return type(tree)(*(tree_map(fn, v) for v in tree))
    return fn(tree)


def tree_index(tree, i):
    """Slice every leaf of a stacked tree at index i of its leading axis."""
    return tree_map(lambda t: t[i], tree)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights with the JAX package's tree and scales (``init_params``
    there), drawn from ``generator`` (a ``torch.Generator`` on ``device``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    p: Params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                     dt, dev),
                 "final_norm": rmsnorm_init(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size, dt, dev)

    def dense_layer():
        return {"ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_init(generator, cfg, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                dt, dev)}

    p["layers"] = _stack([dense_layer() for _ in range(cfg.num_layers)])
    return p


# ===========================================================================
# cache
# ===========================================================================

def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, dtype=None,
               device="cuda") -> Params:
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def _write_kv(ck, cv, k_new, v_new, pos):
    """Decode write: one token's K/V ([B, 1, KVH, hd]) at each row's offset
    `pos` ([B]) of ck/cv ([B, Smax, KVH, hd]), in place.

    The JAX package merges the token into the whole cache with a where over
    every position (a scatter at data-dependent rows made GSPMD replicate its
    sequence-sharded cache); the port writes the one position, with the same
    values. A row whose pos is past the cache end writes nothing, as the
    where-merge there writes nothing. (Prefill writes [0, S) in
    ``forward_seq``.)"""
    B, Smax = ck.shape[0], ck.shape[1]
    rows = torch.arange(B, device=ck.device)
    p = pos.long().clamp(max=Smax - 1)
    inside = (pos < Smax)[:, None, None]
    ck[rows, p] = torch.where(inside, k_new[:, 0].to(ck.dtype), ck[rows, p])
    cv[rows, p] = torch.where(inside, v_new[:, 0].to(cv.dtype), cv[rows, p])


# ===========================================================================
# layer bodies
# ===========================================================================

def _window_for(cfg: ModelConfig, i: int) -> int:
    """Layer i's sliding window; 0 = global."""
    if not cfg.local_global_period or not cfg.sliding_window:
        return 0
    return 0 if cfg.is_global_attn_layer(i) else cfg.sliding_window


def _dense_block_seq(x, lp, cfg, lora, window, positions, rope, q_chunk,
                     causal=True):
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv(h, lp["attn"], cfg, positions, lora, rope_tables=rope)
    o = attention_chunked(q, k, v, cfg, causal=causal,
                          window=window, q_chunk=q_chunk)
    o = o.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    x = x + proj(o, lp["attn"].wo, lora=lora, name="attn_o")
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y = mlp_apply(h, lp["mlp"], cfg.mlp_act, lora)
    return x + y, (k, v)


def _dense_block_decode(x, lp, cfg, lora, window, ck, cv, pos, rope):
    """x: [B, d] one token; ck/cv: [B, Smax, KVH, hd], written in place."""
    B = x.shape[0]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)[:, None, :]      # [B,1,d]
    q, k, v = qkv(h, lp["attn"], cfg, pos[:, None], lora, rope_tables=rope)
    _write_kv(ck, cv, k, v, pos)
    o = attention_decode(q[:, 0].contiguous(), ck, cv, pos + 1, cfg,
                         window=window)
    o = o.reshape(B, cfg.q_dim)
    x = x + proj(o, lp["attn"].wo, lora=lora, name="attn_o")
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y = mlp_apply(h, lp["mlp"], cfg.mlp_act, lora)
    return x + y


def _lora_layer(lora: Optional[LoraCtx], i: int) -> Optional[LoraCtx]:
    """The ctx bound to layer i's adapter slices, or None. Leaves are
    [L, (T,) d, r]; ``leaf[i]`` serves single and batched modes alike
    because the task dim sits on axis 1 (see lora.adapters)."""
    if lora is None or lora.mode == "off" or not lora.tree:
        return None
    tree = lora.tree.get("layers")
    if not tree:
        return None
    return lora.at_layer(tree_index(tree, i))


# ===========================================================================
# sequence forward (prefill) — returns hidden states (+ cache)
# ===========================================================================

def forward_seq(params: Params, tokens, cfg: ModelConfig,
                lora: Optional[LoraCtx] = None, cache: Optional[Params] = None,
                *, q_chunk: int = 512
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Full-sequence forward. Returns (hidden [B,S,d], cache, aux_loss).

    With a cache, each layer's K/V is written into it at [0, S) of every
    row, pads included; the caller sets cache["pos"] afterwards (per-row
    prompt lengths). Reads beyond ``pos`` never happen and decode overwrites
    in place, so the attention families need no ``seq_lens`` (the JAX
    package takes it for its recurrent families)."""
    _check_family(cfg)
    B, S = tokens.shape[:2]
    x = params["embed"][tokens.long()]                       # [B,S,d]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        x, (k, v) = _dense_block_seq(x, lp, cfg, _lora_layer(lora, i),
                                     _window_for(cfg, i), positions, rope,
                                     q_chunk)
        if cache is not None:
            cache["k"][i, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :S] = v.to(cache["v"].dtype)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# decode step
# ===========================================================================

def decode_step(params: Params, new_tokens, cache: Params, cfg: ModelConfig,
                lora: Optional[LoraCtx] = None, advance=None
                ) -> Tuple[torch.Tensor, Params]:
    """One token for every row. new_tokens: [B] int.

    `advance` ([B] int32 0/1, default all-ones) freezes rows awaiting
    external tool responses: a frozen row's K/V slot is written (and
    overwritten on resume) but its `pos` does not move, so its cache never
    accumulates garbage. Returns (logits [B, V], cache)."""
    _check_family(cfg)
    B = new_tokens.shape[0]
    pos = cache["pos"]
    if advance is None:
        advance = torch.ones((B,), dtype=torch.int32, device=pos.device)
    x = params["embed"][new_tokens.long()]                   # [B, d]
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        x = _dense_block_decode(x, lp, cfg, _lora_layer(lora, i),
                                _window_for(cfg, i), cache["k"][i],
                                cache["v"][i], pos, rope)
    cache = dict(cache, pos=(pos + advance).to(torch.int32))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, params, cfg), cache


# ===========================================================================
# logits
# ===========================================================================

def lm_logits(h, params: Params, cfg: ModelConfig):
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"].T
    logits = (h @ w.to(h.dtype)).float()
    return softcap(logits, cfg.logit_softcap)
