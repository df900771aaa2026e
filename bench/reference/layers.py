"""Plain float32 transformer pieces of the reference: RMSNorm, attention
(blocked over query rows so that a 16k-token causal prompt fits), SwiGLU,
RoPE and the exit head. Parameters come as the nested dicts of tensors the
benchmark made, in the port's layout: a stacked layer dict with ``norm1``,
``norm2``, ``attn`` (``wq``/``wk``/``wv`` (L, d, heads, hd), ``wo`` (L,
heads, hd, d), optional biases ``bq``/``bk``/``bv``) and ``mlp``
(``w_gate``/``w_up`` (L, d, f), ``w_down`` (L, f, d)). Every product goes
through ``precision.matmul``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from bench.reference.precision import matmul

Q_BLOCK = 1024      # query rows a block of the attention
ROW_BLOCK = 8192    # token rows a block of the feed-forward


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float
            ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * scale.float()


def l2_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp_min(n, eps)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, heads, hd) at positions 0..S-1, rotate-half form."""
    S, hd = x.shape[1], x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                          device=x.device) / hd))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool, prec: str) -> torch.Tensor:
    """q (B, S, H, D), k/v (B, S, KV, D) -> (B, S, H, D): softmax(q k^T /
    sqrt(D)) v in float32, query rows in blocks of ``Q_BLOCK``; with
    ``causal`` a block reads only the keys up to its last row."""
    B, S, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    kt = k.permute(0, 2, 3, 1)                      # (B, KV, D, S)
    vt = v.permute(0, 2, 1, 3)                      # (B, KV, S, D)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=q.device)
    for b in range(B):
        for i0 in range(0, S, Q_BLOCK):
            i1 = min(i0 + Q_BLOCK, S)
            n_k = i1 if causal else S
            qb = q[b, i0:i1].reshape(i1 - i0, KV, G, D).permute(1, 2, 0, 3)
            s = matmul(qb, kt[b, :, None, :, :n_k], prec) * scale
            if causal:
                rows = torch.arange(i0, i1, device=q.device)[:, None]
                cols = torch.arange(n_k, device=q.device)[None, :]
                s = s.masked_fill(cols > rows, float("-inf"))
            p = torch.softmax(s, dim=-1)
            o = matmul(p, vt[b, :, None, :n_k], prec)  # (KV, G, rows, D)
            out[b, i0:i1] = o.permute(2, 0, 1, 3).reshape(i1 - i0, H, D)
    return out


def _proj(x: torch.Tensor, w: torch.Tensor, prec: str) -> torch.Tensor:
    """x (N, d_in) @ w (d_in, ...) -> (N, ...)."""
    return matmul(x, w.reshape(w.shape[0], -1), prec).reshape(
        x.shape[0], *w.shape[1:])


def layer(lp: Dict, i: int, x: torch.Tensor, *, eps: float, causal: bool,
          prec: str, rope_theta: float = 0.0,
          kv_out: Optional[list] = None) -> torch.Tensor:
    """Layer ``i`` of the stacked dict ``lp`` on x (B, S, d) in float32;
    ``kv_out`` receives this layer's (k, v) after RoPE."""
    B, S, d = x.shape
    at = lp["attn"]
    h = rmsnorm(x, lp["norm1"][i], eps).reshape(B * S, d)
    qkv = []
    for w, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        y = _proj(h, at[w][i], prec)
        if bias in at:
            y = y + at[bias][i].float()
        qkv.append(y.reshape(B, S, *y.shape[1:]))
    q, k, v = qkv
    if rope_theta > 0:
        q, k = rope(q, rope_theta), rope(k, rope_theta)
    if kv_out is not None:
        kv_out.append((k, v))
    o = attention(q, k, v, causal=causal, prec=prec).reshape(B * S, -1)
    wo = at["wo"][i]
    x = x + matmul(o, wo.reshape(-1, wo.shape[-1]), prec).reshape(B, S, d)
    mp = lp["mlp"]
    out = torch.empty_like(x).reshape(B * S, d)
    xr = x.reshape(B * S, d)
    for r0 in range(0, B * S, ROW_BLOCK):
        h2 = rmsnorm(xr[r0:r0 + ROW_BLOCK], lp["norm2"][i], eps)
        g = matmul(h2, mp["w_gate"][i], prec)
        u = matmul(h2, mp["w_up"][i], prec)
        out[r0:r0 + ROW_BLOCK] = matmul(torch.nn.functional.silu(g) * u,
                                        mp["w_down"][i], prec)
    return x + out.reshape(B, S, d)


def exit_embedding(tp: Dict, pooled: torch.Tensor, eps: float,
                   prec: str = "fp32") -> torch.Tensor:
    """(..., d) pooled states -> (..., E) unit embeddings through the exit
    head (its RMSNorm, then its projection)."""
    h = rmsnorm(pooled, tp["exit_head"]["norm"], eps)
    lead = h.shape[:-1]
    e = matmul(h.reshape(-1, h.shape[-1]), tp["exit_head"]["proj"], prec)
    return l2_normalize(e).reshape(*lead, -1)
