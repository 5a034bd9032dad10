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
