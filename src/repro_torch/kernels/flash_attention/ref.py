"""Plain PyTorch attention (materialised softmax) with the flash kernel's
masks and outputs.

q (B, Sq, H, D); k, v (B, Skv, KV, D) with H % KV == 0 (GQA: head h reads
kv head h // (H // KV)). ``q_offset`` shifts query positions (query i sits
at absolute position i + q_offset). Scores and softmax in fp32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int,
                   q_offset: int, device=None) -> torch.Tensor:
    """(Sq, Skv) bool: may query i (at position i + q_offset) see key j?"""
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(Skv, device=device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=device)
    if causal:
        mask &= kj <= qi
    if window and window > 0:
        mask &= kj > (qi - window)
    return mask


def attention_fwd_reference(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: int = 0, q_offset: int = 0,
                            scale: Optional[float] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, Sq, KV, G, D).float()
    s = torch.einsum("bqkgd,bjkd->bkgqj", qg, k.float()) * scale
    mask = attention_mask(Sq, Skv, causal=causal, window=window,
                          q_offset=q_offset, device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    lse = torch.logsumexp(s, dim=-1)                       # (B, KV, G, Sq)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqj,bjkd->bqkgd", p, v.float())
    return o.reshape(B, Sq, H, D).to(q.dtype), lse.reshape(B, H, Sq)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        **kw) -> torch.Tensor:
    return attention_fwd_reference(q, k, v, **kw)[0]
