"""GQA attention: chunked-query prefill path + cached decode path (port of
``repro.models.attention``).

Variants covered: grouped KV heads, QKV bias (qwen1.5), qk-norm
(chameleon/qwen3), score softcap (gemma2), sliding window + local/global
alternation (gemma2).

`window` is always a Python int here (0 = global attention): gemma2's
per-layer windows are a list of ints, not a traced array. So
``attention_decode`` takes the ``gqa_decode`` kernel on the card for every
layer and every cache length, where the JAX package routes to its kernel only
for a static window and a cache length that tiles by 512.

Prefill attention stays plain tensor code, as the JAX package computes it
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.gqa_decode import gqa_decode
from .common import (LoraCtx, apply_rope, dense_init, proj, rmsnorm,
                     rmsnorm_init, softcap)

_NO_WINDOW = 2 ** 31 - 2            # int32 max - 1, as in the JAX package


class AttnParams(NamedTuple):
    wq: torch.Tensor
    wk: torch.Tensor
    wv: torch.Tensor
    wo: torch.Tensor
    bq: Optional[torch.Tensor] = None
    bk: Optional[torch.Tensor] = None
    bv: Optional[torch.Tensor] = None
    q_norm: Optional[torch.Tensor] = None
    k_norm: Optional[torch.Tensor] = None


def attn_init(gen, cfg: ModelConfig, dtype, device) -> AttnParams:
    d, qd, kvd = cfg.d_model, cfg.q_dim, cfg.kv_dim

    def zeros(n):
        return torch.zeros((n,), dtype=dtype, device=device)

    return AttnParams(
        wq=dense_init(gen, d, qd, dtype, device),
        wk=dense_init(gen, d, kvd, dtype, device),
        wv=dense_init(gen, d, kvd, dtype, device),
        wo=dense_init(gen, qd, d, dtype, device),
        bq=zeros(qd) if cfg.qkv_bias else None,
        bk=zeros(kvd) if cfg.qkv_bias else None,
        bv=zeros(kvd) if cfg.qkv_bias else None,
        q_norm=rmsnorm_init(cfg.head_dim, dtype, device) if cfg.qk_norm else None,
        k_norm=rmsnorm_init(cfg.head_dim, dtype, device) if cfg.qk_norm else None,
    )


def qkv(x, p: AttnParams, cfg: ModelConfig, positions, lora: Optional[LoraCtx],
        rope: bool = True, rope_tables=None):
    """Project + reshape to heads (+ qk-norm + RoPE). x: [B, S, d];
    `rope_tables`: ``common.rope_tables(positions, hd, theta)``, shared by
    the layers of one forward."""
    B, S, _ = x.shape
    q = proj(x, p.wq, p.bq, lora=lora, name="attn_q").reshape(B, S, cfg.num_heads, cfg.head_dim)
    k = proj(x, p.wk, p.bk, lora=lora, name="attn_k").reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    v = proj(x, p.wv, p.bv, lora=lora, name="attn_v").reshape(B, S, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, rope_tables)
        k = apply_rope(k, positions, cfg.rope_theta, rope_tables)
    return q, k, v


def repeat_kv(k, n_rep: int):
    """[B, S, KVH, hd] -> [B, S, KVH*n_rep, hd]."""
    if n_rep == 1:
        return k
    b, s, h, d = k.shape
    return k[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _effective_window(window: int) -> int:
    return window if window > 0 else _NO_WINDOW


def _pair_mask(q_pos, k_pos, *, causal: bool, window: int):
    """[Sq, Sk] boolean mask (True = attend)."""
    diff = q_pos[:, None] - k_pos[None, :]
    m = diff < _effective_window(window)
    if causal:
        m &= diff >= 0
    return m


def _scale(hd: int) -> float:
    """1/sqrt(hd) rounded as the JAX package rounds it, in fp32."""
    return float(np.float32(1.0) / np.sqrt(np.float32(hd)))


def _softmax_attend(q, k, v, cfg: ModelConfig, mask):
    """q: [B,Sq,H,hd], k/v: [B,Sk,H,hd] (already repeated), mask [Sq,Sk]."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * _scale(q.shape[-1])
    s = softcap(s, cfg.attn_softcap)
    s = s.masked_fill(~mask[None, None], -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def attention_dense(q, k, v, cfg: ModelConfig, *, causal: bool, window: int = 0):
    """Plain softmax attention. q:[B,Sq,H,hd], k/v:[B,Sk,KVH,hd]."""
    H = q.shape[2]
    Sq, Sk = q.shape[1], k.shape[1]
    k = repeat_kv(k, H // cfg.num_kv_heads)
    v = repeat_kv(v, H // cfg.num_kv_heads)
    dev = q.device
    mask = _pair_mask(torch.arange(Sq, device=dev), torch.arange(Sk, device=dev),
                      causal=causal, window=window)
    return _softmax_attend(q, k, v, cfg, mask)


def attention_chunked(q, k, v, cfg: ModelConfig, *, causal: bool,
                      window: int = 0, q_chunk: int = 512):
    """Query-chunked attention: a loop over q chunks; peak memory
    [B, H, q_chunk, Sk]. Used for prefill at long sequence length."""
    B, Sq, H, hd = q.shape
    if Sq <= q_chunk:
        return attention_dense(q, k, v, cfg, causal=causal, window=window)
    if Sq % q_chunk:
        raise ValueError(f"query length {Sq} is not a multiple of {q_chunk}")
    Sk = k.shape[1]
    k = repeat_kv(k, H // cfg.num_kv_heads)
    v = repeat_kv(v, H // cfg.num_kv_heads)
    dev = q.device
    k_pos = torch.arange(Sk, device=dev)
    outs = []
    for i in range(Sq // q_chunk):
        q_pos = i * q_chunk + torch.arange(q_chunk, device=dev)
        mask = _pair_mask(q_pos, k_pos, causal=causal, window=window)
        outs.append(_softmax_attend(q[:, i * q_chunk:(i + 1) * q_chunk],
                                    k, v, cfg, mask))
    return torch.cat(outs, dim=1)


def attention_decode(q, cache_k, cache_v, pos, cfg: ModelConfig, *,
                     window: int = 0):
    """Single-token decode. q: [B, H, hd]; cache: [B, Smax, KVH, hd];
    pos: [B] number of valid cache entries (incl. the just-written token).

    On the card this is the hand-written ``gqa_decode`` kernel; on the CPU
    its plain version (``kernels.ref.gqa_decode_ref``), which computes the
    grouped-einsum math of the JAX package's oracle path."""
    return gqa_decode(q, cache_k, cache_v, pos,
                      softcap=float(cfg.attn_softcap or 0.0),
                      window=int(window))
