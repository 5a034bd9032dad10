"""Mamba2 (SSD, state-space duality) block: chunked train/prefill scan and
O(1) single-token decode (port of ``repro.models.mamba2``; arXiv:2405.21060).

Layout: x/dt/B/C come out of one fused in_proj; a depthwise causal conv runs
over the (x, B, C) channels; the SSD core mixes an intra-chunk term
(quadratic, attention-like) and an inter-chunk term (recurrent); the output
is gated-RMSNormed and projected back. The scan is plain PyTorch (einsum,
cumsum), as the JAX package's is plain jnp: no kernel of the TPU package
lies here.

State carried between calls (decode, chunk boundaries):
  ssm_state  [B, H, N, P]    (per-head state x headdim; always fp32)
  conv_state [B, conv_dim, W-1]
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs import ModelConfig
from repro_torch.train.sharding import cumsum, fit_split, grad_in_layout
from .common import LoraCtx, dense_init, proj, rand, randn, rmsnorm


class MambaParams(NamedTuple):
    in_proj: torch.Tensor      # [d, 2*d_in + 2*G*N + H]
    conv_w: torch.Tensor       # [conv_dim, W] depthwise
    conv_b: torch.Tensor       # [conv_dim]
    dt_bias: torch.Tensor      # [H]
    a_log: torch.Tensor        # [H]
    d_skip: torch.Tensor       # [H]
    norm_w: torch.Tensor       # [d_in] gated RMSNorm
    out_proj: torch.Tensor     # [d_in, d]


def dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    s = cfg.ssm
    d_in = s.d_inner(cfg.d_model)
    H = s.num_heads(cfg.d_model)
    conv_dim = d_in + 2 * s.n_groups * s.state_dim
    return d_in, H, s.state_dim, s.n_groups, conv_dim


def mamba_init(gen: torch.Generator, cfg: ModelConfig, dtype,
               device) -> MambaParams:
    """Random weights with the JAX package's shapes and scales, drawn from
    ``gen``."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, H, N, G, conv_dim = dims(cfg)
    proj_cols = 2 * d_in + 2 * G * N + H
    f32 = dict(dtype=torch.float32, device=device)
    in_proj = dense_init(gen, d, proj_cols, dtype, device)
    conv_w = (randn((conv_dim, s.conv_width), gen, device)
              * (1.0 / np.sqrt(s.conv_width))).to(dtype)
    # dt bias such that softplus(bias) spans [dt_min, dt_max]
    u = rand((H,), gen, device)
    dt = torch.exp(u * (np.log(s.dt_max) - np.log(s.dt_min)) + np.log(s.dt_min))
    dt_bias = dt + torch.log(-torch.expm1(-dt))              # inverse softplus
    a_log = torch.log(1.0 + 15.0 * rand((H,), gen, device))
    return MambaParams(
        in_proj=in_proj, conv_w=conv_w,
        conv_b=torch.zeros((conv_dim,), dtype=dtype, device=device),
        dt_bias=dt_bias, a_log=a_log,
        d_skip=torch.ones((H,), **f32),
        norm_w=torch.zeros((d_in,), dtype=dtype, device=device),
        out_proj=dense_init(gen, d_in, d, dtype, device))


def _ssd_bf16() -> bool:
    """``REPRO_SSD_BF16=1`` rounds the intra-chunk products' operands to
    bf16 (fp32 accumulation and result), as the JAX package's switch of the
    same name does; decay and state math stay fp32. Off by default."""
    return os.environ.get("REPRO_SSD_BF16", "0") == "1"


def _segsum(dA):
    """Log-decay matrix: out[..., i, j] = sum_{j<k<=i} dA[..., k], -inf for
    j > i. dA: [..., Q] -> [..., Q, Q]. The mask goes in before the caller's
    exp (exp of a masked-to-0 difference would put inf * 0 in the
    backward)."""
    Q = dA.shape[-1]
    cs = cumsum(dA, -1)
    diff = cs[..., :, None] - cs[..., None, :]               # i,j -> cs_i - cs_j
    mask = torch.ones((Q, Q), dtype=torch.bool, device=dA.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _causal_conv_train(xbc, w, b, W: int, conv_state=None, seq_lens=None):
    """Depthwise causal conv. xbc: [B, S, ch]; w: [ch, W].
    conv_state: [B, ch, W-1] history (prefill continuation) or None.
    seq_lens: [B] true row lengths: the returned state is the window ending
    at each row's own last real token, not at the padded tail."""
    B, S, ch = xbc.shape
    x = xbc.transpose(1, 2)                                  # [B, ch, S]
    if conv_state is None:
        pad = torch.zeros((B, ch, W - 1), dtype=x.dtype, device=x.device)
    else:
        pad = conv_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=-1)                         # [B, ch, S+W-1]
    wf = w.float()
    out = torch.zeros((B, ch, S), dtype=torch.float32, device=x.device)
    for i in range(W):                                       # W is 4: unrolled
        out = out + xp[:, :, i:i + S].float() * wf[:, i][None, :, None]
    out = out + b.float()[None, :, None]
    if seq_lens is None:
        new_state = xp[:, :, S:]
    else:
        # real input j sits at xp column W-1+j, so the last W-1 real inputs
        # of a length-L row are columns [L, L+W-1)
        idx = (seq_lens.long()[:, None, None]
               + torch.arange(W - 1, device=x.device)[None, None, :])
        new_state = torch.gather(xp, 2, idx.expand(B, ch, W - 1))
    return F.silu(out).to(xbc.dtype).transpose(1, 2), new_state


def ssd_chunked(x, dt, A, B_, C_, chunk: int, init_state=None):
    """SSD core. x: [B,S,H,P]; dt: [B,S,H] (post-softplus); A: [H]
    (negative); B_/C_: [B,S,G,N]. Returns (y [B,S,H,P], final state
    [B,H,N,P] fp32)."""
    Bsz, S, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    pad = (-S) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk
    # positions split over a mesh axis more ways than there are chunks are
    # made whole first (GSPMD reshards across the view by itself)
    x, dt, B_, C_ = (fit_split(t, 1, nc, note="ssd_chunks")
                     for t in (x, dt, B_, C_))

    def tohead(t):  # [B,S,G,N] -> [B,nc,Q,H,N]
        return t.repeat_interleave(rep, dim=2).reshape(Bsz, nc, chunk, H, N)

    lowp = (lambda t: t.to(torch.bfloat16).float()) if _ssd_bf16() \
        else (lambda t: t)
    xc = x.reshape(Bsz, nc, chunk, H, P).float()
    dtc = dt.reshape(Bsz, nc, chunk, H).float()
    Bh, Ch = tohead(B_).float(), tohead(C_).float()

    dA = dtc * A[None, None, None, :]                        # [B,nc,Q,H]
    dA_cs = cumsum(dA, 2)

    # intra-chunk (diagonal) term
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))           # [B,nc,H,Q,Q]
    att = torch.einsum("bnqhs,bnkhs->bnhqk", lowp(Ch), lowp(Bh)) * L
    xdt = xc * dtc[..., None]
    y_diag = torch.einsum("bnhqk,bnkhp->bnqhp", lowp(att), lowp(xdt))

    # chunk boundary states
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)    # [B,nc,Q,H]
    states = torch.einsum("bnkhs,bnkhp->bnhsp",
                          Bh * (dtc * decay_to_end)[..., None], xc)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])              # [B,nc,H]
    s = (torch.zeros((Bsz, H, N, P), dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    prev = []                                                # entering states
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                   # [B,nc,H,N,P]

    # inter-chunk (off-diagonal) term
    y_off = torch.einsum("bnqhs,bnhsp->bnqhp", Ch, prev_states) \
        * torch.exp(dA_cs)[..., None]
    # its gradient comes back in the forward's layout, for the view back
    # into chunks (``grad_in_layout``)
    y = grad_in_layout((y_diag + y_off).reshape(Bsz, nc * chunk, H, P))[:, :S]
    return y.to(x.dtype), s


def _split_in(zxbcdt, cfg: ModelConfig):
    d_in, H, N, G, _ = dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in, G * N, G * N, H], dim=-1)


def mamba_block(x, p: MambaParams, cfg: ModelConfig,
                lora: Optional[LoraCtx] = None, ssm_state=None,
                conv_state=None, return_state: bool = False, seq_lens=None):
    """Full Mamba2 block over a sequence. x: [B, S, d].

    seq_lens [B] (prefill of a mixed-length batch): positions >= the row's
    true length become state no-ops (dt = 0: decay 1, zero injection) and
    the conv state is taken at the row's own last real token, so the
    returned states equal an unpadded per-row run's. Outputs at real
    positions do not depend on it (the recurrence is causal)."""
    s = cfg.ssm
    d_in, H, N, G, _ = dims(cfg)
    B, S, _ = x.shape
    zxbcdt = proj(x, p.in_proj, lora=lora, name="ssm_in")
    z, xr, Bc, Cc, dt_raw = _split_in(zxbcdt, cfg)
    xbc = torch.cat([xr, Bc, Cc], dim=-1)                    # [B,S,conv_dim]
    xbc, new_conv = _causal_conv_train(xbc, p.conv_w, p.conv_b, s.conv_width,
                                       conv_state, seq_lens)
    xr, Bc, Cc = torch.split(xbc, [d_in, G * N, G * N], dim=-1)
    xh = xr.reshape(B, S, H, s.head_dim)
    dt = F.softplus(dt_raw.float() + p.dt_bias)
    if seq_lens is not None:
        live = (torch.arange(S, device=x.device)[None, :]
                < seq_lens.to(x.device)[:, None])
        dt = dt * live[:, :, None].to(dt.dtype)
    A = -torch.exp(p.a_log)
    y, final_state = ssd_chunked(xh, dt, A, Bc.reshape(B, S, G, N),
                                 Cc.reshape(B, S, G, N), s.chunk_size,
                                 ssm_state)
    y = y + xh.float().to(y.dtype) * p.d_skip.to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm_w, cfg.norm_eps)
    out = proj(y, p.out_proj, lora=lora, name="ssm_out")
    if return_state:
        return out, (final_state, new_conv)
    return out


def mamba_decode_step(x, p: MambaParams, cfg: ModelConfig, ssm_state,
                      conv_state, lora: Optional[LoraCtx] = None):
    """One-token step. x: [B, d]; ssm_state: [B,H,N,P];
    conv_state: [B, conv_dim, W-1]. Returns (y [B,d], (ssm fp32, conv))."""
    s = cfg.ssm
    d_in, H, N, G, _ = dims(cfg)
    B = x.shape[0]
    zxbcdt = proj(x, p.in_proj, lora=lora, name="ssm_in")
    z, xr, Bc, Cc, dt_raw = _split_in(zxbcdt, cfg)
    xbc = torch.cat([xr, Bc, Cc], dim=-1)                    # [B, conv_dim]
    full = torch.cat([conv_state.to(xbc.dtype), xbc[:, :, None]], dim=-1)
    conv_out = torch.einsum("bcw,cw->bc", full.float(), p.conv_w.float()) \
        + p.conv_b.float()
    xbc_o = F.silu(conv_out).to(xbc.dtype)
    new_conv = full[:, :, 1:]
    xr, Bc, Cc = torch.split(xbc_o, [d_in, G * N, G * N], dim=-1)
    xh = xr.reshape(B, H, s.head_dim).float()
    Bh = Bc.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    Ch = Cc.reshape(B, G, N).repeat_interleave(H // G, dim=1).float()
    dt = F.softplus(dt_raw.float() + p.dt_bias)              # [B,H]
    A = -torch.exp(p.a_log)
    dA = torch.exp(dt * A[None, :])                          # [B,H]
    st = ssm_state.float() * dA[:, :, None, None] \
        + (Bh * dt[:, :, None])[:, :, :, None] * xh[:, :, None, :]
    # C·state as a product and a sum over the state dim: an einsum would
    # flatten (row, head) into one batch dim, which DTensor (torch 2.11)
    # refuses when both are split over the mesh
    y = (Ch[:, :, :, None] * st).sum(dim=2)
    y = y + xh * p.d_skip[None, :, None]
    y = y.reshape(B, d_in).to(x.dtype)
    y = rmsnorm(y * F.silu(z.float()).to(y.dtype), p.norm_w, cfg.norm_eps)
    out = proj(y, p.out_proj, lora=lora, name="ssm_out")
    return out, (st, new_conv)
