"""Plain PyTorch versions of the hand-written kernels (port of
``repro.kernels.ref``).

The CPU path of every kernel wrapper runs these, the tests hold them against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against them on
the card. Nothing on the main path calls them when a card is present.
"""
from __future__ import annotations

import torch


def sgmv_ref(rows, a, b, ids):
    """y[i] = rows[i] @ a[ids[i]] @ b[ids[i]]  (fp32)."""
    T = a.shape[0]
    xf = rows.float()
    out = torch.zeros((rows.shape[0], b.shape[2]), dtype=torch.float32,
                      device=rows.device)
    for t in range(T):
        h = (xf @ a[t].float()) @ b[t].float()
        out = out + h * (ids == t)[:, None]
    return out


def sgmv_add_ref(y, rows, a, b, ids, scaling: float):
    """y += (scaling * sgmv_ref(rows, a, b, ids)).to(rows.dtype), in place,
    rounded as ``y + d.to(y.dtype)`` rounds; rows [..., d] and y [...,
    dout] hold the R rows of ids [R]. Returns y."""
    d = sgmv_ref(rows.reshape(-1, rows.shape[-1]), a, b, ids)
    return y.add_((d * scaling).to(rows.dtype).reshape(y.shape))


def _logits_ref(h, w, softcap):
    """Softcapped fp32 logits of h [..., d] against w [d, V]."""
    z = h.float() @ w.float()
    return torch.tanh(z / softcap) * softcap if softcap else z


def token_logprob_stats_ref(h, w, targets, softcap: float = 0.0):
    """(logprob, entropy, lse) per row, fp32 (see ``token_logprob_ref``)."""
    z = _logits_ref(h, w, softcap)
    lse = torch.logsumexp(z, dim=-1)
    tgt = torch.gather(z, -1, targets.long()[..., None])[..., 0]
    p = torch.softmax(z, dim=-1)
    return tgt - lse, lse - (p * z).sum(-1), lse


def token_logprob_ref(h, w, targets, softcap: float = 0.0):
    """Per-row target logprob and entropy over the whole vocabulary, fp32.

    h: [R, d] (or [B, S, d]); w: [d, V]; targets: [R] (or [B, S]) ids in
    [0, V). Returns (logprob, entropy) of targets' shape. Differentiable
    by torch autograd in h and w."""
    lp, ent, _ = token_logprob_stats_ref(h, w, targets, softcap)
    return lp, ent


def token_logprob_bwd_ref(h, w, targets, lse, ent, g_lp, g_ent,
                          softcap: float = 0.0):
    """dh of ``token_logprob_ref`` for upstream grads g_lp, g_ent ([R] fp32),
    from the forward's saved lse and entropy ([R] fp32). With z the
    softcapped logits and p = exp(z - lse):

        dz_j = g_lp (1[j = t] - p_j) - g_ent p_j (z_j - lse + ent)

    times 1 - tanh^2(raw / cap) under a softcap; dh = dz @ w^T, returned in
    h's dtype. h: [R, d]; w: [d, V]; targets: [R]."""
    z = _logits_ref(h, w, softcap)
    lse, ent = lse[:, None], ent[:, None]
    p = torch.exp(z - lse)
    hit = torch.zeros_like(z).scatter_(1, targets.long()[:, None], 1.0)
    dz = g_lp[:, None] * (hit - p) - g_ent[:, None] * p * (z - lse + ent)
    if softcap:
        dz = dz * (1.0 - torch.square(z / softcap))
    return (dz @ w.float().T).to(h.dtype)


def gqa_decode_ref(q, cache_k, cache_v, pos, *, softcap=0.0, window=0):
    """Single-token GQA attention over a contiguous cache, in fp32.

    q: [B, H, hd]; cache_k/v: [B, Smax, KVH, hd]; pos: [B] valid lengths
    (including the just-written token). Returns [B, H, hd] in q's dtype."""
    B, H, hd = q.shape
    Smax, KVH = cache_k.shape[1], cache_k.shape[2]
    rep = H // KVH
    k = torch.repeat_interleave(cache_k, rep, dim=2)
    v = torch.repeat_interleave(cache_v, rep, dim=2)
    s = torch.einsum("bhd,bkhd->bhk", q.float(), k.float()) / (hd ** 0.5)
    if softcap:
        s = torch.tanh(s / softcap) * softcap
    idx = torch.arange(Smax, device=q.device)
    pos = pos.to(torch.int64)
    valid = idx[None, :] < pos[:, None]
    if window:
        valid &= (pos[:, None] - 1 - idx[None, :]) < window
    s = s.masked_fill(~valid[:, None, :], -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v.float()).to(q.dtype)


def paged_gqa_decode_ref(q, kp, vp, tbl, pos, *, softcap=0.0, window=0):
    """Single-token GQA attention over a page pool: gather each row's pages
    through its block table into a contiguous cache, then
    ``gqa_decode_ref``.

    q: [B, H, hd]; kp/vp: [n_pages+1, page, KVH, hd] (the last page is the
    scratch page sentinel entries point at); tbl: [B, max_pages] physical
    page ids; pos: [B] valid lengths. Returns [B, H, hd] in q's dtype."""
    B = q.shape[0]
    page, KVH, hd = kp.shape[1], kp.shape[2], kp.shape[3]
    n_pg = tbl.shape[1]
    idx = tbl.long()
    ck = kp[idx].reshape(B, n_pg * page, KVH, hd)
    cv = vp[idx].reshape(B, n_pg * page, KVH, hd)
    return gqa_decode_ref(q, ck, cv, pos, softcap=softcap, window=window)
