"""Model assembly for the dense family: init / prefill / decode / train
forward (port of the dense half of ``repro.models.model``).

The parameter tree is the JAX package's: per-layer weights stacked on a
leading layer axis. Where the JAX package ``lax.scan``s over that axis, the
port loops over it in Python.

The KV cache is a plain dict of tensors, updated IN PLACE (JAX's arrays are
immutable, so its functions return a new cache; the port writes into the
one it is given, which saves a copy of the cache per call, and returns the
same dict with a new ``pos``). Dense (``init_cache``):
  k, v        [L, B, Smax, KVH, hd]
  pos         [B] int32 — valid entries per row
or paged (``init_paged_cache``; ``decode_step`` tells them apart by ``tbl``):
  kp, vp      [L, n_pages+1, page, KVH, hd] — the shared page pool
  tbl         [B, max_pages] int32 — per-row physical page ids
  pos         [B] int32
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from .attention import (attention_chunked, attention_decode,
                        attention_decode_paged, attention_prefill_chunk,
                        attn_init, qkv)
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


def tree_leaves(tree):
    """The tensor leaves of a tree (dicts, NamedTuples; None skipped), in
    the tree's own order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like, leaves):
    """A tree shaped like `like` whose leaves are `leaves`, in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


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


def init_paged_cache(cfg: ModelConfig, batch: int, *, pool_pages: int,
                     page_size: int, max_pages_per_row: int, dtype=None,
                     device="cuda") -> Params:
    """Block-pool KV cache: attention K/V live in a SHARED pool of
    ``pool_pages`` pages of ``page_size`` tokens (``kp``/``vp``:
    [L, pool_pages+1, page, KVH, hd]) and each row names its pages through a
    block table ``tbl: [batch, max_pages_per_row]``. Physical page
    ``pool_pages`` is the scratch page: sentinel table entries (==
    pool_pages) route frozen/empty-lane writes and masked reads there. The
    host-side allocator (``rollout/kvcache.py``) owns the free list; this
    function only lays out device memory. Keys, shapes and the sentinel are
    the JAX package's."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    shape = (cfg.num_layers, pool_pages + 1, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    return {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
            "tbl": torch.full((batch, max_pages_per_row), pool_pages,
                              dtype=torch.int32, device=dev),
            "kp": torch.zeros(shape, dtype=dt, device=dev),
            "vp": torch.zeros(shape, dtype=dt, device=dev)}


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


def _write_kv_paged(kp, vp, tbl, k_new, v_new, pos):
    """Paged decode write: one token's K/V ([B, 1, KVH, hd]) into physical
    page ``tbl[b, pos // page]`` of kp/vp ([n_pages+1, page, KVH, hd]) at
    offset ``pos % page``, in place. Frozen and empty lanes whose entry is
    the sentinel write the scratch page, which is never validly read; so does
    a row whose pos is past its table (the JAX package's scatter drops that
    write)."""
    page, sentinel, max_pg = kp.shape[1], kp.shape[0] - 1, tbl.shape[1]
    lpage = (pos // page).long()
    pidx = tbl.gather(1, lpage.clamp(max=max_pg - 1)[:, None])[:, 0]
    pidx = torch.where(lpage < max_pg, pidx, sentinel).long()
    off = (pos % page).long()
    kp[pidx, off] = k_new[:, 0].to(kp.dtype)
    vp[pidx, off] = v_new[:, 0].to(vp.dtype)


def _block_decode(x, lp, cfg, lora, window, ck, cv, pos, rope, tbl=None):
    """x: [B, d] one token. Dense cache: ck/cv [B, Smax, KVH, hd]; paged
    cache (`tbl` [B, max_pages] given): ck/cv are this layer's page pool
    [n_pages+1, page, KVH, hd]. Either is written in place."""
    B = x.shape[0]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)[:, None, :]      # [B,1,d]
    q, k, v = qkv(h, lp["attn"], cfg, pos[:, None], lora, rope_tables=rope)
    q = q[:, 0].contiguous()
    if tbl is None:
        _write_kv(ck, cv, k, v, pos)
        o = attention_decode(q, ck, cv, pos + 1, cfg, window=window)
    else:
        _write_kv_paged(ck, cv, tbl, k, v, pos)
        o = attention_decode_paged(q, ck, cv, tbl, pos + 1, cfg,
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
    package takes it for its recurrent families). With ``cfg.remat`` and
    grad enabled, every layer runs under ``torch.utils.checkpoint``."""
    _check_family(cfg)
    B, S = tokens.shape[:2]
    x = params["embed"][tokens.long()]                       # [B,S,d]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    # remat, as the JAX package's checkpointed scan body: with grad on, each
    # layer keeps only its input and recomputes its activations backward
    remat = cfg.remat and torch.is_grad_enabled()
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        args = (x, lp, cfg, _lora_layer(lora, i), _window_for(cfg, i),
                positions, rope, q_chunk)
        if remat:
            x, (k, v) = checkpoint(_dense_block_seq, *args,
                                   use_reentrant=False)
        else:
            x, (k, v) = _dense_block_seq(*args)
        if cache is not None:
            cache["k"][i, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :S] = v.to(cache["v"].dtype)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x, cache, torch.zeros((), dtype=torch.float32, device=x.device)


# ===========================================================================
# chunk-incremental prefill
# ===========================================================================

def _dense_block_chunk(x, lp, cfg, lora, window, positions, rope, ck, cv,
                       start: int):
    """One dense block over a prefill CHUNK at absolute offset `start`.
    x: [B, C, d]; ck/cv: [B, Smax, KVH, hd], this layer's cache. Writes the
    chunk's K/V at [start, start+C), in place, and attends causally over
    [0, start+C). The ops of `_dense_block_seq`; only the mask offset and
    the cache-resident keys differ."""
    C = x.shape[1]
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv(h, lp["attn"], cfg, positions, lora, rope_tables=rope)
    ck[:, start:start + C] = k.to(ck.dtype)
    cv[:, start:start + C] = v.to(cv.dtype)
    o = attention_prefill_chunk(q, ck[:, :start + C], cv[:, :start + C], cfg,
                                q_start=start, window=window)
    o = o.reshape(x.shape[0], C, cfg.q_dim)
    x = x + proj(o, lp["attn"].wo, lora=lora, name="attn_o")
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    return x + mlp_apply(h, lp["mlp"], cfg.mlp_act, lora)


def forward_prefill_chunk(params: Params, tokens, cfg: ModelConfig,
                          lora: Optional[LoraCtx] = None,
                          cache: Optional[Params] = None, *, start: int = 0,
                          seq_lens=None) -> Tuple[torch.Tensor, Params]:
    """One chunk of an incremental prefill: tokens [B, C] are the absolute
    positions ``start .. start+C`` of each row (`start` a Python int). Every
    layer writes the chunk's K/V into the dense cache (``init_cache``) at
    [start, start+C), in place, and attends over [0, start+C) of it, so the
    cache must already hold the row's first `start` entries. `seq_lens` [B]
    is the valid length within the chunk; the attention families need none
    (positions past it are overwritten before they are read), as in
    ``forward_seq``. A prompt prefilled chunk by chunk gives the hidden
    states of ``forward_seq``. Returns (hidden [B, C, d] final-normed,
    cache); the caller sets ``cache["pos"]``."""
    _check_family(cfg)
    C = tokens.shape[1]
    x = params["embed"][tokens.long()]
    positions = (start + torch.arange(C, device=x.device))[None, :]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.num_layers):
        x = _dense_block_chunk(x, tree_index(params["layers"], i), cfg,
                               _lora_layer(lora, i), _window_for(cfg, i),
                               positions, rope, cache["k"][i], cache["v"][i],
                               start)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), cache


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
    accumulates garbage. Returns (logits [B, V], cache).

    The cache may be dense (``init_cache``) or paged (``init_paged_cache``,
    told apart by its ``tbl`` block table): the paged path writes the
    token's K/V into the row's current page and attends through the table
    (the ``paged_gqa_decode`` kernel on the card), with the dense path's
    values."""
    _check_family(cfg)
    B = new_tokens.shape[0]
    pos = cache["pos"]
    paged = "tbl" in cache
    if advance is None:
        advance = torch.ones((B,), dtype=torch.int32, device=pos.device)
    x = params["embed"][new_tokens.long()]                   # [B, d]
    rope = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
    ck, cv = (cache["kp"], cache["vp"]) if paged else (cache["k"], cache["v"])
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        x = _block_decode(x, lp, cfg, _lora_layer(lora, i),
                          _window_for(cfg, i), ck[i], cv[i], pos, rope,
                          cache.get("tbl"))
    cache = dict(cache, pos=(pos + advance).to(torch.int32))
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(x, params, cfg), cache


# ===========================================================================
# logits
# ===========================================================================

def vocab_matrix(params: Params, cfg: ModelConfig):
    """The [d, V] output matrix: the untied head, or the tied embedding's
    transpose as a view (no copy of the table)."""
    return params["lm_head"] if not cfg.tie_embeddings else params["embed"].T


def lm_logits(h, params: Params, cfg: ModelConfig):
    logits = (h @ vocab_matrix(params, cfg).to(h.dtype)).float()
    return softcap(logits, cfg.logit_softcap)


def forward_train(params: Params, tokens, cfg: ModelConfig,
                  lora: Optional[LoraCtx] = None, *, q_chunk: int = 512):
    """Teacher-forced full-sequence logits [B, S, V] (+ aux loss)."""
    h, _, aux = forward_seq(params, tokens, cfg, lora, None, q_chunk=q_chunk)
    return lm_logits(h, params, cfg), aux
