"""Plain PyTorch single-token decode attention against a (possibly partly
filled) KV cache: the reference's ``decode_attention_reference``.

q (B, H, D) is one query per sequence; k, v (B, S, KV, D) with H % KV == 0
(GQA: head h reads kv head h // (H // KV)); lengths (B,) int: positions
< length are valid and the query sits at position length - 1. With
``window`` > 0 only positions > length - 1 - window are valid. Scores,
softmax and the PV product in fp32; the output is cast to q's dtype.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def decode_attention_reference(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, lengths: torch.Tensor, *,
                               window: int = 0,
                               scale: Optional[float] = None) -> torch.Tensor:
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    qg = q.reshape(B, KV, G, D).float()
    s = torch.einsum("bkgd,bjkd->bkgj", qg, k.float()) * scale
    pos = torch.arange(S, device=q.device)[None, :]
    lengths = lengths.to(q.device)[:, None]
    valid = pos < lengths
    if window and window > 0:
        valid &= pos > (lengths - 1 - window)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgj,bjkd->bkgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def bf16_rounding_limit(o_ref: torch.Tensor) -> torch.Tensor:
    """Per-element limit of a bf16 output against another whose arithmetic
    is f32 throughout with one final rounding (another split of the keys,
    another summation order): one bf16 step at |o| (2^-7 |o|: the two
    roundings may land a step apart) plus 2^-12 of the row's largest |o|
    (the f32 difference before rounding, which shows where |o| is a
    cancelled sum far below its row's scale)."""
    r = o_ref.float().abs()
    return 2.0 ** -7 * r + 2.0 ** -12 * r.amax(dim=-1, keepdim=True)
