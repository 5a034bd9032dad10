"""Plain reference of the dense decoder the benchmark serves and trains
(Qwen3: GQA with per-head RMSNorm on q and k, rotary positions, SwiGLU,
tied embedding head), in fp32 with TF32 off, one sequence at a time, with
no cache and no batching. It imports torch alone.

It reads the weights in the benchmark's layout (``harness/weights.py``):
matrices in ``x @ W`` orientation stacked over layers, an RMSNorm's scale
1 + w, the fused gate+up projection's gate columns first. A LoRA target's
delta is scaling · (x a) b, added to the projection's output; the fused
gate+up projection takes one adapter over its 2·ff columns.

``quant="fp8"`` is the lower precision the control computes in: every base
matrix rounded to float8 e4m3 with one scale per output column (per row of
the embedding), and then computed in fp32 as the rest.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

MATRICES = ("wq", "wk", "wv", "wo", "w_in", "w_out")


def fp32_strict():
    """Full fp32 matmuls on the card: no TF32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def quantize_fp8(w: torch.Tensor, dim: int) -> torch.Tensor:
    """w rounded to float8 e4m3 with one scale per slice along `dim` (the
    amax of the slice over the other dim maps to 448), returned in fp32."""
    w = w.float()
    amax = w.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / 448.0
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


class RefModel:
    """The reference over one set of base weights."""

    def __init__(self, cfg: Dict, weights: Dict[str, torch.Tensor],
                 quant: Optional[str] = None):
        self.L = cfg["num_hidden_layers"]
        self.d = cfg["hidden_size"]
        self.H = cfg["num_attention_heads"]
        self.KVH = cfg["num_key_value_heads"]
        self.hd = cfg["head_dim"]
        self.ff = cfg["intermediate_size"]
        self.eps = float(cfg["rms_norm_eps"])
        self.theta = float(cfg["rope_theta"])
        self.scaling = cfg["lora"]["alpha"] / cfg["lora"]["rank"]
        if not cfg["tie_word_embeddings"]:
            raise ValueError("the reference serves tied heads only")
        if (cfg.get("family"), cfg.get("mlp_act"), cfg.get("qk_norm")) != (
                "dense", "swiglu", True):
            raise ValueError("the reference serves the dense SwiGLU decoder "
                             "with qk-norm only")
        self.quant = quant
        w = {}
        for k, t in weights.items():
            t = t.float()
            if quant == "fp8" and k in MATRICES:
                t = quantize_fp8(t, dim=1)          # [L, d_in, d_out]: per column
            elif quant == "fp8" and k == "embed":
                t = quantize_fp8(t, dim=1)          # [V, d]: per token row
            elif quant is not None and quant != "fp8":
                raise ValueError(quant)
            w[k] = t
        self.w = w

    # -- pieces -------------------------------------------------------------
    def norm(self, x, w):
        x = x * torch.rsqrt(x.square().mean(-1, keepdim=True) + self.eps)
        return x * (1.0 + w)

    def rope(self, x, pos):
        """x [S, heads, hd] rotated by the angles of positions `pos` [S]."""
        half = self.hd // 2
        inv = 1.0 / (self.theta ** (torch.arange(0, self.hd, 2, dtype=torch.float64,
                                                   device=x.device) / self.hd))
        ang = pos.double()[:, None] * inv[None, :]
        sin = torch.sin(ang).float()[:, None, :]
        cos = torch.cos(ang).float()[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat((x1 * cos - x2 * sin, x1 * sin + x2 * cos), dim=-1)

    def lin(self, x, name, i, lora, target):
        y = x @ self.w[name][i]
        if lora is not None and target in lora:
            a, b = lora[target]["a"][i], lora[target]["b"][i]
            y = y + self.scaling * ((x @ a) @ b)
        return y

    def layer(self, x, i, lora):
        S = x.shape[0]
        w = self.w
        h = self.norm(x, w["ln1"][i])
        q = self.lin(h, "wq", i, lora, "attn_q").view(S, self.H, self.hd)
        k = self.lin(h, "wk", i, lora, "attn_k").view(S, self.KVH, self.hd)
        v = self.lin(h, "wv", i, lora, "attn_v").view(S, self.KVH, self.hd)
        q = self.norm(q, w["q_norm"][i])
        k = self.norm(k, w["k_norm"][i])
        pos = torch.arange(S, device=x.device)
        q, k = self.rope(q, pos), self.rope(k, pos)
        rep = self.H // self.KVH
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(self.hd)
        causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
        s = s.masked_fill(~causal, float("-inf"))
        o = torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)
        x = x + self.lin(o.reshape(S, self.H * self.hd), "wo", i, lora, "attn_o")
        h = self.norm(x, w["ln2"][i])
        gu = self.lin(h, "w_in", i, lora, "mlp_in")
        gate, up = gu[:, :self.ff], gu[:, self.ff:]
        return x + self.lin(F.silu(gate) * up, "w_out", i, lora, "mlp_out")

    # -- whole sequence -------------------------------------------------------
    def hidden(self, tokens: torch.Tensor, lora=None, remat: bool = False):
        """Final-norm hidden states [S, d] of one sequence `tokens` [S]."""
        x = self.w["embed"][tokens.long()]
        for i in range(self.L):
            if remat and torch.is_grad_enabled():
                x = checkpoint(self.layer, x, i, lora, use_reentrant=False)
            else:
                x = self.layer(x, i, lora)
        return self.norm(x, self.w["final_norm"])

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        return h @ self.w["embed"].T

    def next_token_stats(self, tokens: torch.Tensor, start: int, lora=None,
                         chunk: int = 256):
        """For the positions p in [start - 1, S - 1), each predicting
        tokens[p+1]: the logprob of tokens[p+1], the gap by which its logit
        lies below the position's best, and the best token. Returns
        (lp [n], gap [n], argmax [n]), with no grad."""
        with torch.no_grad():
            h = self.hidden(tokens, lora)
            S = tokens.shape[0]
            lps, gaps, tops = [], [], []
            for c0 in range(start - 1, S - 1, chunk):
                c1 = min(c0 + chunk, S - 1)
                z = self.logits(h[c0:c1])
                tgt = tokens[c0 + 1:c1 + 1].long()
                zt = z.gather(1, tgt[:, None])[:, 0]
                zmax, arg = z.max(dim=1)
                lps.append(zt - torch.logsumexp(z, dim=1))
                gaps.append(zmax - zt)
                tops.append(arg)
            return torch.cat(lps), torch.cat(gaps), torch.cat(tops)

    def completion_logprobs(self, tokens: torch.Tensor, start: int, lora=None):
        """Logprobs [n] of tokens[start:] given their prefixes, with grad
        through `lora` when grad is on."""
        h = self.hidden(tokens, lora, remat=True)
        z = self.logits(h[start - 1:tokens.shape[0] - 1])
        tgt = tokens[start:].long()
        return z.gather(1, tgt[:, None])[:, 0] - torch.logsumexp(z, dim=1)
