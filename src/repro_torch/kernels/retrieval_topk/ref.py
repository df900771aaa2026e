"""Plain PyTorch version of the fused int4 retrieval top-k.

Dequantize, score in fp32, mask rows ``>= n_valid`` to -1e30, keep the
top-k sorted by descending score with ties going to the lower row id (a
stable sort). ``block_n`` streams the bank in row chunks, merging each into
a running (Q, k) best set, so the fp32 bank is never whole in memory.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quantize import dequantize_int4

NEG_INF = -1e30


def _topk_stable(scores: torch.Tensor, ids: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(ids, 1, order[:, :k])


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-8)


def retrieval_topk_int4_reference(query: torch.Tensor, packed: torch.Tensor,
                                  scales: torch.Tensor, k: int, *,
                                  normalize: bool = False,
                                  n_valid: Optional[int] = None,
                                  block_n: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E); packed (N, E//2) int8; scales (N, 1) -> (scores (Q, k)
    f32, ids (Q, k) int32). Requires k <= N."""
    N = packed.shape[0]
    n_valid = N if n_valid is None else int(n_valid)
    q = query.float()
    if normalize:
        q = _normalize(q)
    bn = N if block_n is None else int(block_n)
    Q = q.shape[0]
    best_s = torch.empty((Q, 0), dtype=torch.float32, device=q.device)
    best_i = torch.empty((Q, 0), dtype=torch.int64, device=q.device)
    for j0 in range(0, N, bn):
        b = dequantize_int4(packed[j0:j0 + bn], scales[j0:j0 + bn])
        if normalize:
            b = _normalize(b)
        s = q @ b.T                                          # (Q, bn)
        ids = torch.arange(j0, j0 + b.shape[0], device=q.device)
        s = torch.where(ids[None, :] < n_valid, s, torch.full_like(s, NEG_INF))
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(Q, -1)], dim=1)
        best_s, best_i = _topk_stable(cat_s, cat_i, k)
    return best_s, best_i.to(torch.int32)
