"""Model assembly: init / prefill / decode / train forward for every family
of the JAX package: dense, vlm, moe, ssm (mamba2), hybrid (zamba2) and
encdec (the seamless backbone behind a stub frontend). Port of
``repro.models.model``.

The parameter tree is the JAX package's: per-layer weights stacked on a
leading layer axis, plus the hybrid's one ``shared`` attention+MLP block and
encdec's ``encoder`` stack (its decoder layers carry a cross-attention,
``lnx``/``xattn``, after the self-attention). Where the JAX package
``lax.scan``s over that axis, the port loops over it in Python; the hybrid's
grouped scan (groups of ``hybrid_attn_every`` mamba blocks and one
shared-block invocation) and its per-layer loop are then one loop. An untied
head whose vocabulary is not a multiple of 8 (seamless's 256206) is a view
of a row-padded buffer (``padded_head``), for the token_logprob kernels.

The cache is a plain dict of tensors, updated IN PLACE (JAX's arrays are
immutable, so its functions return a new cache; the port writes into the
one it is given, which saves a copy of the cache per call, and returns the
same dict with a new ``pos``). Dense (``init_cache``):
  k, v        [L_attn, B, Smax, KVH, hd]   (L_attn: the attention layers,
                                            the hybrid's invocations)
  pos         [B] int32 — valid entries per row
  ssm, conv   [L, B, H, N, P] fp32, [L, B, conv_dim, W-1]  (ssm, hybrid)
  xk, xv      [L, B, S_enc, KVH, hd]  (encdec: the cross-attention memory,
                                       written by the prefill)
or paged (``init_paged_cache``; ``decode_step`` tells them apart by ``tbl``):
  kp, vp      [L_attn, n_pages+1, page, KVH, hd] — the shared page pool
  tbl         [B, max_pages] int32 — per-row physical page ids
  pos, ssm, conv   as in the dense cache (recurrent state is never paged)
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.kernels.boundary import is_dtensor
from repro_torch.train.sharding import embed_rows, grad_in_layout, shard_offset
from .attention import (attention_chunked, attention_decode,
                        attention_decode_paged, attention_decode_plain,
                        attention_prefill_chunk, attn_init, qkv,
                        split_heads)
from .common import (LoraCtx, dense_init, dtype_of, embed_init, proj,
                     resolve_device, rmsnorm, rmsnorm_init, rope_tables,
                     softcap)
from .mamba2 import dims as ssm_dims, mamba_block, mamba_decode_step, mamba_init
from .mlp import mlp_apply, mlp_init
from .moe import moe_apply, moe_init

Params = Dict[str, Any]

_FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def _check_family(cfg: ModelConfig):
    if cfg.family not in _FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} (have {_FAMILIES})")


# ===========================================================================
# init
# ===========================================================================

def tree_map(fn, tree):
    """fn over every tensor leaf of a parameter tree (dicts and the params
    NamedTuples, nested too; None leaves stay None)."""
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


def _stack_layers(make, n: int):
    """`n` layers of ``make()`` stacked on a new leading axis. The stacked
    leaves are allocated from the first layer's and each later layer is
    copied in as it is drawn, so that a full-size model's peak is its
    weights plus one layer, not twice its weights."""
    first = make()
    out = tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), first)
    for i in range(n):
        lay = first if i == 0 else make()
        for dst, src in zip(tree_leaves(out), tree_leaves(lay)):
            dst[i].copy_(src)
        del lay
    return out


def padded_head(w: torch.Tensor) -> torch.Tensor:
    """An untied head w [d, V] as the [:, :V] view of a [d, V'] buffer, V'
    the next multiple of 8, every value unchanged (the pad is 0 and never
    read): the bf16 token_logprob backward then loads W's tiles with 16-byte
    copies, which need a row stride of a multiple of 8 elements (the
    forward's launcher also needs V itself to be one). w itself when V is a
    multiple of 8."""
    d, V = w.shape
    Vp = -(-V // 8) * 8
    if Vp == V:
        return w
    return w.new_zeros((d, Vp))[:, :V].copy_(w)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random weights with the JAX package's tree and scales (``init_params``
    there), drawn from ``generator`` (a ``torch.Generator`` on ``device``)
    one layer at a time (``_stack_layers``). On the meta device the tree's
    shapes and dtypes come without memory or draws, and `generator` may be
    None (``launch.specs.eval_shapes``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg.dtype)
    p: Params = {"embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                                     dt, dev),
                 "final_norm": rmsnorm_init(cfg.d_model, dt, dev)}
    if not cfg.tie_embeddings:
        p["lm_head"] = padded_head(dense_init(generator, cfg.d_model,
                                              cfg.vocab_size, dt, dev))

    def dense_layer():
        return {"ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_init(generator, cfg, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                dt, dev)}

    def moe_layer():
        return {"ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_init(generator, cfg, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "moe": moe_init(generator, cfg, dt, dev)}

    def mamba_layer():
        return {"ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "mamba": mamba_init(generator, cfg, dt, dev)}

    def dec_layer():
        return {"ln1": rmsnorm_init(cfg.d_model, dt, dev),
                "attn": attn_init(generator, cfg, dt, dev),
                "lnx": rmsnorm_init(cfg.d_model, dt, dev),
                "xattn": attn_init(generator, cfg, dt, dev),
                "ln2": rmsnorm_init(cfg.d_model, dt, dev),
                "mlp": mlp_init(generator, cfg.d_model, cfg.d_ff, cfg.mlp_act,
                                dt, dev)}

    if cfg.family == "encdec":
        p["encoder"] = _stack_layers(dense_layer, cfg.encoder_layers)
    make = {"dense": dense_layer, "vlm": dense_layer, "moe": moe_layer,
            "ssm": mamba_layer, "hybrid": mamba_layer,
            "encdec": dec_layer}[cfg.family]
    p["layers"] = _stack_layers(make, cfg.num_layers)
    if cfg.family == "hybrid":
        p["shared"] = dense_layer()
    return p


# ===========================================================================
# cache
# ===========================================================================

def n_attn_layers(cfg: ModelConfig) -> int:
    """Attention layers with a K/V cache: every layer of the attention
    families, the shared block's invocations of the hybrid, none of ssm."""
    if cfg.family == "ssm":
        return 0
    if cfg.family == "hybrid":
        return cfg.num_layers // cfg.hybrid_attn_every
    return cfg.num_layers


def _recurrent_state(c: Params, cfg: ModelConfig, batch: int, dt, dev):
    """The ssm (fp32 whatever the model dtype) and conv (model dtype) rows
    of a recurrent family's cache, zeroed, into `c`."""
    if cfg.ssm is None:
        return
    d_in, H, N, G, conv_dim = ssm_dims(cfg)
    c["ssm"] = torch.zeros((cfg.num_layers, batch, H, N, cfg.ssm.head_dim),
                           dtype=torch.float32, device=dev)
    c["conv"] = torch.zeros((cfg.num_layers, batch, conv_dim,
                             cfg.ssm.conv_width - 1), dtype=dt, device=dev)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               enc_len: int = 0, dtype=None, device="cuda") -> Params:
    """The dense cache (module docstring); encdec's also holds `enc_len`
    frames of cross-attention memory a layer (``xk``/``xv``)."""
    _check_family(cfg)
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    c: Params = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    if cfg.family == "encdec":
        shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads,
                 cfg.head_dim)
        c["xk"] = torch.zeros(shape, dtype=dt, device=dev)
        c["xv"] = torch.zeros(shape, dtype=dt, device=dev)
    n_attn = n_attn_layers(cfg)
    if n_attn:
        shape = (n_attn, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        c["k"] = torch.zeros(shape, dtype=dt, device=dev)
        c["v"] = torch.zeros(shape, dtype=dt, device=dev)
    _recurrent_state(c, cfg, batch, dt, dev)
    return c


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
    function only lays out device memory. Pages hold the attention layers
    only (``n_attn_layers``: none for ssm); recurrent ssm/conv state is per
    row and fixed-size, so it stays dense as in ``init_cache``. Keys, shapes
    and the sentinel are the JAX package's. encdec is not paged (its
    cross-attention memory is written once), as in the JAX package."""
    _check_family(cfg)
    if cfg.family == "encdec":
        raise ValueError("paged KV cache unsupported for encdec")
    dev = resolve_device(device)
    dt = dtype or dtype_of(cfg.dtype)
    c: Params = {"pos": torch.zeros((batch,), dtype=torch.int32, device=dev)}
    n_attn = n_attn_layers(cfg)
    if n_attn:
        shape = (n_attn, pool_pages + 1, page_size, cfg.num_kv_heads,
                 cfg.head_dim)
        c["tbl"] = torch.full((batch, max_pages_per_row), pool_pages,
                              dtype=torch.int32, device=dev)
        c["kp"] = torch.zeros(shape, dtype=dt, device=dev)
        c["vp"] = torch.zeros(shape, dtype=dt, device=dev)
    _recurrent_state(c, cfg, batch, dt, dev)
    return c


def _write_kv(ck, cv, k_new, v_new, pos):
    """Decode write: one token's K/V ([B, 1, KVH, hd]) at each row's offset
    `pos` ([B]) of ck/cv ([B, Smax, KVH, hd]), in place.

    The JAX package merges the token into the whole cache with a where over
    every position (a scatter at data-dependent rows made GSPMD replicate its
    sequence-sharded cache); the port writes the one position, with the same
    values. A row whose pos is past the cache end writes nothing, as the
    where-merge there writes nothing. (Prefill writes [0, S) in
    ``forward_seq``.)

    A sharded cache (DTensors) is written shard by shard
    (``_write_kv_sharded``); a row whose pos lies outside a shard's
    positions (pos < 0 here) writes nothing into that shard."""
    if is_dtensor(ck):
        return _write_kv_sharded(ck, cv, k_new, v_new, pos)
    B, Smax = ck.shape[0], ck.shape[1]
    rows = torch.arange(B, device=ck.device)
    p = pos.long().clamp(0, Smax - 1)
    inside = ((pos >= 0) & (pos < Smax))[:, None, None]
    ck[rows, p] = torch.where(inside, k_new[:, 0].to(ck.dtype), ck[rows, p])
    cv[rows, p] = torch.where(inside, v_new[:, 0].to(cv.dtype), cv[rows, p])


def _write_kv_sharded(ck, cv, k_new, v_new, pos):
    """``_write_kv`` into DTensor caches [B, Smax, KVH, hd] split over rows,
    positions or kv heads: the token's K/V and the positions are laid out
    as the cache's rows and heads, and each rank writes its own shard in
    place at its positions (GSPMD replicated a sequence-split cache for the
    JAX package's where-merge; DTensor has no in-place rule for the
    scatter)."""
    from torch.distributed.tensor import Replicate, Shard
    mesh, plc = ck.device_mesh, ck.placements
    kv_plc = [p if (p.is_shard(0) or p.is_shard(2)) else Replicate()
              for p in plc]
    pos_plc = [Shard(0) if p.is_shard(0) else Replicate() for p in plc]
    k_loc = k_new.redistribute(mesh, kv_plc).to_local()
    v_loc = v_new.redistribute(mesh, kv_plc).to_local()
    pos_loc = pos.redistribute(mesh, pos_plc).to_local()
    _write_kv(ck.to_local(), cv.to_local(), k_loc, v_loc,
              pos_loc - shard_offset(ck, 1))


# ===========================================================================
# layer bodies
# ===========================================================================

def _window_for(cfg: ModelConfig, i: int) -> int:
    """Layer i's sliding window; 0 = global."""
    if not cfg.local_global_period or not cfg.sliding_window:
        return 0
    return 0 if cfg.is_global_attn_layer(i) else cfg.sliding_window


def _ffn(h, lp, cfg, lora, live=None):
    """The block's feed-forward: the MLP, or the MoE layer with its aux
    loss. h: [B, S, d] or [B, d] (one decode token); live [B]: the decode
    lanes that take expert capacity (``moe_apply``). Returns (y, aux or
    None)."""
    if "moe" not in lp:
        return mlp_apply(h, lp["mlp"], cfg.mlp_act, lora), None
    if h.dim() == 2:
        y, aux = moe_apply(h[:, None, :], lp["moe"], cfg, lora, live)
        return y[:, 0], aux
    return moe_apply(h, lp["moe"], cfg, lora)


def _dense_block_seq(x, lp, cfg, lora, window, positions, rope, q_chunk,
                     causal=True):
    """An attention block over a sequence: (x, (k, v), aux); aux is the
    MoE layer's load-balance loss, None for an MLP block."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = qkv(h, lp["attn"], cfg, positions, lora, rope_tables=rope)
    o = attention_chunked(q, k, v, cfg, causal=causal,
                          window=window, q_chunk=q_chunk)
    o = o.reshape(x.shape[0], x.shape[1], cfg.q_dim)
    x = x + proj(o, lp["attn"].wo, lora=lora, name="attn_o")
    h = rmsnorm(x, lp["ln2"], cfg.norm_eps)
    y, aux = _ffn(h, lp, cfg, lora)
    return x + y, (k, v), aux


def _mamba_layer_seq(x, lp, cfg, lora, ssm_state, conv_state, seq_lens):
    """A mamba layer (pre-norm, residual) over a sequence:
    (x, (ssm state, conv state))."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, st = mamba_block(h, lp["mamba"], cfg, lora, ssm_state=ssm_state,
                        conv_state=conv_state, return_state=True,
                        seq_lens=seq_lens)
    return x + y, st


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


def _block_decode(x, lp, cfg, lora, window, ck, cv, pos, rope, tbl=None,
                  live=None):
    """x: [B, d] one token. Dense cache: ck/cv [B, Smax, KVH, hd]; paged
    cache (`tbl` [B, max_pages] given): ck/cv are this layer's page pool
    [n_pages+1, page, KVH, hd]. Either is written in place. live [B]: the
    lanes that take MoE capacity (None: all)."""
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
    return x + _ffn(h, lp, cfg, lora, live)[0]


def _mamba_layer_decode(x, lp, cfg, lora, ssm_state, conv_state, advance):
    """One token through a mamba layer: (x, ssm', conv'). A row with
    ``advance`` 0 keeps its state (the JAX package's ssm branch masks it so;
    its hybrid branch does not, ROADMAP §3), and conv' is cast back to the
    cache's dtype."""
    h = rmsnorm(x, lp["ln1"], cfg.norm_eps)
    y, (st, cs) = mamba_decode_step(h, lp["mamba"], cfg, ssm_state,
                                    conv_state, lora)
    adv = advance > 0
    st = torch.where(adv[:, None, None, None], st, ssm_state.float())
    cs = torch.where(adv[:, None, None], cs, conv_state.to(cs.dtype))
    return x + y, st, cs.to(conv_state.dtype)


def _lora_layer(lora: Optional[LoraCtx], i: int,
                sub: str = "layers") -> Optional[LoraCtx]:
    """The ctx bound to adapter slice i of subtree `sub` ("layers", or the
    hybrid's "shared" block, one slice an invocation), or None. Leaves are
    [L, (T,) d, r]; ``leaf[i]`` serves single and batched modes alike
    because the task dim sits on axis 1 (see lora.adapters)."""
    if lora is None or lora.mode == "off" or not lora.tree:
        return None
    tree = lora.tree.get(sub)
    if not tree:
        return None
    # over DTensors each layer's slice hands its gradient back in the
    # slice's own layout, so that the layers' gradients of a stacked leaf
    # add up in one layout (``sharding.grad_in_layout``)
    return lora.at_layer(tree_map(lambda t: grad_in_layout(t[i]), tree))


def _hybrid_invokes(cfg: ModelConfig, i: int) -> bool:
    """True if the hybrid's shared block runs after mamba layer i."""
    k = cfg.hybrid_attn_every
    return bool(k) and (i + 1) % k == 0


def _run(fn, remat: bool, *args):
    """fn(*args), under ``torch.utils.checkpoint`` when `remat`."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _add_aux(total, aux):
    """The MoE aux losses summed; None (no launch) while there are none."""
    if aux is None:
        return total
    return aux if total is None else total + aux


# ===========================================================================
# encdec: the encoder and the decoder's cross-attention
# ===========================================================================

def _encode(params, enc_embeds, cfg, q_chunk, remat):
    """The seamless encoder: a bidirectional transformer (rope at frame
    positions 0..S_enc-1, no adapters) over the stub frontend's embeddings
    [B, S_enc, d], then the model's final norm. Each layer is checkpointed
    under `remat`; ``remat_block`` does not reach the encoder, as in the
    JAX package."""
    if enc_embeds is None:
        raise ValueError("the encdec family needs enc_embeds [B, S_enc, d]")
    x = enc_embeds
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    rope = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    for i in range(cfg.encoder_layers):
        x, _, _ = _run(_dense_block_seq, remat, x,
                       tree_index(params["encoder"], i), cfg, None, 0,
                       positions, rope, q_chunk, False)
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _cross_attn_seq(x, lp, cfg, enc_memory, q_chunk):
    """Decoder cross-attention over the encoder memory: no mask, no rope,
    no adapters. Returns (x, (k, v)); k/v [B, S_enc, KVH, hd] are the
    layer's cross-attention memory, which a prefill keeps in the cache."""
    h = rmsnorm(x, lp["lnx"], cfg.norm_eps)
    B, S, _ = h.shape
    p = lp["xattn"]
    q = split_heads(proj(h, p.wq), cfg.num_heads, cfg.head_dim)
    k = split_heads(proj(enc_memory, p.wk), cfg.num_kv_heads, cfg.head_dim)
    v = split_heads(proj(enc_memory, p.wv), cfg.num_kv_heads, cfg.head_dim)
    o = attention_chunked(q, k, v, cfg, causal=False, window=0,
                          q_chunk=q_chunk)
    return x + proj(o.reshape(B, S, cfg.q_dim), p.wo), (k, v)


def _cross_attn_decode(x, lp, cfg, xk, xv, enc_pos):
    """x: [B, d]; xk/xv: [B, S_enc, KVH, hd], the whole memory of every row
    (enc_pos [B] = S_enc). Plain attention on every device
    (``attention_decode_plain``): the JAX package computes it outside its
    kernel too (ROADMAP §2 lists the kernel as a candidate)."""
    h = rmsnorm(x, lp["lnx"], cfg.norm_eps)
    p = lp["xattn"]
    B = x.shape[0]
    q = split_heads(proj(h, p.wq), cfg.num_heads, cfg.head_dim)
    o = attention_decode_plain(q, xk, xv, enc_pos, cfg)
    return x + proj(o.reshape(B, cfg.q_dim), p.wo)


# ===========================================================================
# sequence forward (prefill) — returns hidden states (+ cache)
# ===========================================================================

def _attn_layer_seq(x, lp, cfg, lora, window, positions, rope, q_chunk,
                    enc_memory):
    """One layer of an attention stack over a sequence: the block, then
    encdec's cross-attention. Returns (x, (k, v), aux, (xk, xv) or None)."""
    x, kv, aux = _dense_block_seq(x, lp, cfg, lora, window, positions, rope,
                                  q_chunk)
    xkv = None
    if enc_memory is not None:
        x, xkv = _cross_attn_seq(x, lp, cfg, enc_memory, q_chunk)
    return x, kv, aux, xkv


def forward_seq(params: Params, tokens, cfg: ModelConfig,
                lora: Optional[LoraCtx] = None, cache: Optional[Params] = None,
                *, enc_embeds=None, q_chunk: int = 512, inputs_embeds=None,
                seq_lens=None
                ) -> Tuple[torch.Tensor, Optional[Params], torch.Tensor]:
    """Full-sequence forward. Returns (hidden [B,S,d], cache, aux_loss):
    aux is the MoE layers' load-balance loss summed over layers (a tensor
    autograd sees), 0 for the other families. encdec takes the frontend's
    `enc_embeds` [B, S_enc, d], which the encoder turns into the memory
    every decoder layer's cross-attention reads. `inputs_embeds` [B, S, d]
    takes the place of the embedding lookup (then `tokens` may be None), on
    every family.

    With a cache, each attention layer's K/V is written into it at [0, S)
    of every row, pads included, and each mamba layer's ssm/conv state
    replaces the cache's; encdec's cross-attention memory fills ``xk``/``xv``
    (S_enc must be the cache's). The caller sets cache["pos"] afterwards
    (per-row prompt lengths). Reads beyond ``pos`` never happen and decode
    overwrites in place, so attention needs no mask; the recurrent families
    take `seq_lens` [B] so that their states are those at each row's true
    length and not at the padded width.

    With grad enabled: under ``cfg.remat`` every layer runs under
    ``torch.utils.checkpoint``. Under ``cfg.remat_block`` = k > 0, with no
    cache, an attention stack (dense, vlm, moe, encdec's decoder) whose
    depth k divides is also checkpointed k layers at a time (two-level
    remat): backward keeps only every k-th layer's input and recomputes a
    block, whose layers recompute theirs again under ``cfg.remat``. The JAX
    package applies it to its layer scan only, so here too it needs
    ``cfg.scan_layers`` (the port's loop stands for both the scan and the
    unrolled loop of that flag); the encoder keeps per-layer checkpoints."""
    _check_family(cfg)
    if inputs_embeds is None:
        x = embed_rows(params["embed"], tokens)             # [B,S,d]
    else:
        x = inputs_embeds
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None, :]
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.head_dim else None)
    aux_total = None      # summed only over MoE layers: no launch elsewhere
    # remat, as the JAX package's checkpointed scan body: with grad on, each
    # layer keeps only its input and recomputes its activations backward
    remat = cfg.remat and torch.is_grad_enabled()
    if cfg.ssm is None:
        enc = (_encode(params, enc_embeds, cfg, q_chunk, remat)
               if cfg.family == "encdec" else None)

        def layer(x, i):
            return _run(_attn_layer_seq, remat, x,
                        tree_index(params["layers"], i), cfg,
                        _lora_layer(lora, i), _window_for(cfg, i), positions,
                        rope, q_chunk, enc)

        blk = cfg.remat_block
        if (blk and cfg.scan_layers and cache is None
                and torch.is_grad_enabled() and cfg.num_layers % blk == 0):
            def block(x, aux, i0):
                for i in range(i0, i0 + blk):
                    x, _, a, _ = layer(x, i)
                    aux = _add_aux(aux, a)
                return x, aux

            for i0 in range(0, cfg.num_layers, blk):
                x, aux_total = checkpoint(block, x, aux_total, i0,
                                          use_reentrant=False)
        else:
            for i in range(cfg.num_layers):
                x, (k, v), aux, xkv = layer(x, i)
                aux_total = _add_aux(aux_total, aux)
                if cache is not None:
                    cache["k"][i, :, :S] = k.to(cache["k"].dtype)
                    cache["v"][i, :, :S] = v.to(cache["v"].dtype)
                    if xkv is not None:
                        cache["xk"][i] = xkv[0].to(cache["xk"].dtype)
                        cache["xv"][i] = xkv[1].to(cache["xv"].dtype)
    else:
        inv = 0
        for i in range(cfg.num_layers):
            lp = tree_index(params["layers"], i)
            x, (st, cs) = _run(_mamba_layer_seq, remat, x, lp, cfg,
                               _lora_layer(lora, i), None, None, seq_lens)
            if cache is not None:
                cache["ssm"][i] = st
                cache["conv"][i] = cs.to(cache["conv"].dtype)
            if cfg.family == "hybrid" and _hybrid_invokes(cfg, i):
                x, (k, v), _ = _run(_dense_block_seq, remat, x,
                                    params["shared"], cfg,
                                    _lora_layer(lora, inv, "shared"), 0,
                                    positions, rope, q_chunk)
                if cache is not None:
                    cache["k"][inv, :, :S] = k.to(cache["k"].dtype)
                    cache["v"][inv, :, :S] = v.to(cache["v"].dtype)
                inv += 1
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return x, cache, aux_total


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
    return x + _ffn(h, lp, cfg, lora)[0]


def forward_prefill_chunk(params: Params, tokens, cfg: ModelConfig,
                          lora: Optional[LoraCtx] = None,
                          cache: Optional[Params] = None, *, start: int = 0,
                          seq_lens=None) -> Tuple[torch.Tensor, Params]:
    """One chunk of an incremental prefill: tokens [B, C] are the absolute
    positions ``start .. start+C`` of each row (`start` a Python int). Every
    attention layer writes the chunk's K/V into the dense cache
    (``init_cache``) at [start, start+C), in place, and attends over
    [0, start+C) of it, so the cache must already hold the row's first
    `start` entries; every mamba layer reads its ssm/conv state from the
    cache, carries it through the chunk and writes it back. `seq_lens` [B]
    is the valid length within the chunk: the recurrent families mask the
    positions past it out of their state, attention needs no mask
    (positions past it are overwritten before they are read). A prompt
    prefilled chunk by chunk gives the hidden states of ``forward_seq``
    (exactly, for the SSD scan, when `start` is a multiple of
    ``cfg.ssm.chunk_size``: the prefill worker rounds its chunk so).
    Returns (hidden [B, C, d] final-normed, cache); the caller sets
    ``cache["pos"]``. encdec raises, as in the JAX package."""
    _check_family(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError("chunked prefill unsupported for family "
                                  "'encdec'")
    C = tokens.shape[1]
    x = params["embed"][tokens.long()]
    positions = (start + torch.arange(C, device=x.device))[None, :]
    rope = (rope_tables(positions, cfg.head_dim, cfg.rope_theta)
            if cfg.head_dim else None)
    inv = 0
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        if cfg.ssm is None:
            x = _dense_block_chunk(x, lp, cfg, _lora_layer(lora, i),
                                   _window_for(cfg, i), positions, rope,
                                   cache["k"][i], cache["v"][i], start)
            continue
        x, (st, cs) = _mamba_layer_seq(x, lp, cfg, _lora_layer(lora, i),
                                       cache["ssm"][i], cache["conv"][i],
                                       seq_lens)
        cache["ssm"][i] = st
        cache["conv"][i] = cs.to(cache["conv"].dtype)
        if cfg.family == "hybrid" and _hybrid_invokes(cfg, i):
            x = _dense_block_chunk(x, params["shared"], cfg,
                                   _lora_layer(lora, inv, "shared"), 0,
                                   positions, rope, cache["k"][inv],
                                   cache["v"][inv], start)
            inv += 1
    return rmsnorm(x, params["final_norm"], cfg.norm_eps), cache


# ===========================================================================
# decode step
# ===========================================================================

def decode_step(params: Params, new_tokens, cache: Params, cfg: ModelConfig,
                lora: Optional[LoraCtx] = None, advance=None
                ) -> Tuple[torch.Tensor, Params]:
    # step: the model's decode; tensors=params,new_tokens,cache,advance
    """One token for every row. new_tokens: [B] int.

    `advance` ([B] int32 0/1, default all-ones) freezes rows awaiting
    external tool responses: a frozen row's K/V slot is written (and
    overwritten on resume) but its `pos` does not move, and its ssm/conv
    state is kept, so its cache never accumulates garbage. (The JAX
    package's hybrid branch advances a frozen row's recurrent state;
    ROADMAP §3. The port masks it as the JAX ssm branch does.) A frozen
    or empty lane also takes no MoE expert capacity (``moe_apply``'s
    ``live``; the JAX package routes it). Returns (logits [B, V], cache).

    The cache may be dense (``init_cache``) or paged (``init_paged_cache``,
    told apart by its ``tbl`` block table): the paged path writes the
    token's K/V into the row's current page and attends through the table
    (the ``paged_gqa_decode`` kernel on the card), with the dense path's
    values.

    encdec attends to the prefill's cross-attention memory (``xk``/``xv``)
    after each self-attention block, over all of its S_enc frames."""
    _check_family(cfg)
    B = new_tokens.shape[0]
    pos = cache["pos"]
    paged = "tbl" in cache
    live = None
    if advance is None:
        advance = torch.ones((B,), dtype=torch.int32, device=pos.device)
    elif cfg.moe is not None:
        live = advance > 0
    x = params["embed"][new_tokens.long()]                   # [B, d]
    rope = (rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)
            if cfg.head_dim else None)
    ck, cv = ((cache.get("kp"), cache.get("vp")) if paged
              else (cache.get("k"), cache.get("v")))
    if cfg.family == "encdec":
        xk, xv = cache["xk"], cache["xv"]
        enc_pos = torch.full((B,), xk.shape[2], dtype=torch.int32,
                             device=pos.device)
    inv = 0
    for i in range(cfg.num_layers):
        lp = tree_index(params["layers"], i)
        if cfg.ssm is None:
            x = _block_decode(x, lp, cfg, _lora_layer(lora, i),
                              _window_for(cfg, i), ck[i], cv[i], pos, rope,
                              cache.get("tbl"), live)
            if cfg.family == "encdec":
                x = _cross_attn_decode(x, lp, cfg, xk[i], xv[i], enc_pos)
            continue
        x, st, cs = _mamba_layer_decode(x, lp, cfg, _lora_layer(lora, i),
                                        cache["ssm"][i], cache["conv"][i],
                                        advance)
        cache["ssm"][i] = st
        cache["conv"][i] = cs
        if cfg.family == "hybrid" and _hybrid_invokes(cfg, i):
            x = _block_decode(x, params["shared"], cfg,
                              _lora_layer(lora, inv, "shared"), 0, ck[inv],
                              cv[inv], pos, rope, cache.get("tbl"))
            inv += 1
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
                  lora: Optional[LoraCtx] = None, *, enc_embeds=None,
                  q_chunk: int = 512):
    """Teacher-forced full-sequence logits [B, S, V] (+ aux loss: the MoE
    load-balance loss, 0 for the other families); encdec takes
    `enc_embeds`."""
    h, _, aux = forward_seq(params, tokens, cfg, lora, None,
                            enc_embeds=enc_embeds, q_chunk=q_chunk)
    return lm_logits(h, params, cfg), aux
