"""GQA attention: chunked-query prefill path + cached decode path (port of
``repro.models.attention``).

Variants covered: grouped KV heads, QKV bias (qwen1.5), qk-norm
(chameleon/qwen3), score softcap (gemma2), sliding window + local/global
alternation (gemma2).

`window` is always a Python int here (0 = global attention): gemma2's
per-layer windows are a list of ints, not a traced array. So
``attention_decode`` takes the ``gqa_decode`` kernel on the card for every
layer and every cache length, where the JAX package routes to its kernel only
for a static window and a cache length that tiles by 512; and
``attention_decode_paged`` takes the ``paged_gqa_decode`` kernel for every
layer.

Prefill attention stays plain tensor code, as the JAX package computes it
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs import ModelConfig
from repro_torch.kernels.boundary import heads_parallel, is_dtensor
from repro_torch.kernels.gqa_decode import gqa_decode
from repro_torch.kernels.paged_decode import paged_gqa_decode
from repro_torch.train.sharding import fit_split
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
    q = split_heads(proj(x, p.wq, p.bq, lora=lora, name="attn_q"),
                    cfg.num_heads, cfg.head_dim)
    k = split_heads(proj(x, p.wk, p.bk, lora=lora, name="attn_k"),
                    cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(proj(x, p.wv, p.bv, lora=lora, name="attn_v"),
                    cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = rmsnorm(q, p.q_norm, cfg.norm_eps)
        k = rmsnorm(k, p.k_norm, cfg.norm_eps)
    if rope:
        q = apply_rope(q, positions, cfg.rope_theta, rope_tables)
        k = apply_rope(k, positions, cfg.rope_theta, rope_tables)
    return q, k, v


def split_heads(y, n: int, hd: int):
    """[..., n * hd] -> [..., n, hd]. Under a mesh whose tp splits the
    projection's outputs more ways than there are heads (8 kv heads, tp
    16), the outputs are made whole first (``fit_split``): GSPMD reshards
    across the view by itself, DTensor refuses."""
    y = fit_split(y, -1, n, note="heads_view")
    return y.reshape(*y.shape[:-1], n, hd)


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
    k = repeat_kv(k, H // k.shape[2])
    v = repeat_kv(v, H // v.shape[2])
    dev = q.device
    mask = _pair_mask(torch.arange(Sq, device=dev), torch.arange(Sk, device=dev),
                      causal=causal, window=window)
    return _softmax_attend(q, k, v, cfg, mask)


def attention_chunked(q, k, v, cfg: ModelConfig, *, causal: bool,
                      window: int = 0, q_chunk: int = 512):
    """Query-chunked attention: a loop over q chunks; peak memory
    [B, H, q_chunk, Sk]. Used for prefill at long sequence length. Over
    DTensors it runs shard by shard (``boundary.heads_parallel``)."""
    if is_dtensor(q):
        return heads_parallel(attention_chunked, q, k, v, cfg, causal=causal,
                              window=window, q_chunk=q_chunk)
    B, Sq, H, hd = q.shape
    if Sq <= q_chunk:
        return attention_dense(q, k, v, cfg, causal=causal, window=window)
    if Sq % q_chunk:
        raise ValueError(f"query length {Sq} is not a multiple of {q_chunk}")
    Sk = k.shape[1]
    k = repeat_kv(k, H // k.shape[2])
    v = repeat_kv(v, H // v.shape[2])
    dev = q.device
    k_pos = torch.arange(Sk, device=dev)
    outs = []
    for i in range(Sq // q_chunk):
        q_pos = i * q_chunk + torch.arange(q_chunk, device=dev)
        mask = _pair_mask(q_pos, k_pos, causal=causal, window=window)
        outs.append(_softmax_attend(q[:, i * q_chunk:(i + 1) * q_chunk],
                                    k, v, cfg, mask))
    return torch.cat(outs, dim=1)


def attention_prefill_chunk(q, k, v, cfg: ModelConfig, *, q_start: int,
                            window: int = 0):
    """Chunk-incremental prefill attention: queries sit at ABSOLUTE positions
    ``q_start .. q_start+Sq``, keys/values are the cache read back over
    ``[0, Sk)`` (earlier chunks + this one, RoPE'd at their absolute
    positions when written). It is `attention_dense` with the causal mask
    offset by ``q_start``; the cache is cast to the queries' dtype, as the
    JAX package does."""
    H = q.shape[2]
    Sq, Sk = q.shape[1], k.shape[1]
    k = repeat_kv(k.to(q.dtype), H // cfg.num_kv_heads)
    v = repeat_kv(v.to(q.dtype), H // cfg.num_kv_heads)
    dev = q.device
    mask = _pair_mask(q_start + torch.arange(Sq, device=dev),
                      torch.arange(Sk, device=dev), causal=True, window=window)
    return _softmax_attend(q, k, v, cfg, mask)


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


def attention_decode_plain(q, cache_k, cache_v, pos, cfg: ModelConfig, *,
                           window: int = 0):
    """``attention_decode`` as plain tensor code on every device: the JAX
    package's grouped-einsum path (scores in q's dtype, then fp32 with the
    scale, the softcap and the mask; the softmax cast back to q's dtype).
    For attention the JAX package computes outside its kernel whatever
    ``use_kernel`` is (encdec's cross-attention at decode). Over DTensors it
    runs shard by shard (``boundary.heads_parallel``)."""
    if is_dtensor(q):
        return heads_parallel(attention_decode_plain, q, cache_k, cache_v, pos,
                              cfg, window=window)
    B, H, hd = q.shape
    Smax, KVH = cache_k.shape[1], cache_k.shape[2]
    qg = q.reshape(B, KVH, H // KVH, hd)
    s = torch.einsum("bgrd,bkgd->bgrk", qg, cache_k.to(q.dtype)).float() * _scale(hd)
    s = softcap(s, cfg.attn_softcap)
    idx = torch.arange(Smax, device=q.device)
    pos = pos.to(torch.int64)
    valid = (idx[None, :] < pos[:, None]) \
        & ((pos[:, None] - 1 - idx[None, :]) < _effective_window(window))
    s = s.masked_fill(~valid[:, None, None, :], -1e30)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bgrk,bkgd->bgrd", p, cache_v.to(q.dtype)).reshape(B, H, hd)


def attention_decode_paged(q, kp, vp, tbl, pos, cfg: ModelConfig, *,
                           window: int = 0):
    """Single-token decode over the shared page pool (paged KV cache).

    q: [B, H, hd]; kp/vp: [n_pages+1, page, KVH, hd] — one layer's pool
    (physical page ``n_pages`` is the scratch page that sentinel block-table
    entries point at); tbl: [B, max_pages] int32 physical page ids; pos: [B]
    valid entries (incl. the just-written token).

    On the card this is the hand-written ``paged_gqa_decode`` kernel, which
    reads the pages in place through the table; on the CPU its plain version
    (``kernels.ref.paged_gqa_decode_ref``), which gathers each row's pages
    into a contiguous cache and attends over it, as the JAX package's oracle
    path does. Positions >= pos (incl. whatever a sentinel entry points at)
    are masked, so the paged output equals the dense one."""
    return paged_gqa_decode(q, kp, vp, tbl, pos,
                            softcap=float(cfg.attn_softcap or 0.0),
                            window=int(window))
