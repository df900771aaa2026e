"""Plain PyTorch versions of the retrieval top-k scans.

Score in fp32, mask dead rows to -1e30, keep the top-k sorted by
descending score with ties going to the lower row id (a stable sort over
rows in id order). ``block_n`` / ``block_l`` stream the bank or the
candidate lists in chunks, merging each into a running (Q, k) best set, so
neither the fp32 bank nor the gathered rows are ever whole in memory.

  * ``retrieval_topk_reference``: dense fp32 bank, optional L2 normalisation
    of both sides, rows >= ``n_valid`` masked.
  * ``retrieval_topk_int4_reference``: the same over a packed int4 bank,
    dequantized block by block.
  * ``retrieval_topk_int4_gathered_reference``: per-query candidate rows
    (Q, L) of a packed int4 bank; ids < 0 or >= ``n_valid`` are dead, and
    slots with no live candidate hold the sentinel pair (-1e30, -1).
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from repro_torch.core.quantize import dequantize_int4

NEG_INF = -1e30


def _topk_stable(scores: torch.Tensor, ids: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    s, order = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :k], torch.gather(ids, 1, order[:, :k])


def _normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-8)


def _scan_rows(q: torch.Tensor, rows: Callable[[int, int], torch.Tensor],
               N: int, k: int, *, normalize: bool, n_valid: Optional[int],
               block_n: Optional[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of ``q`` against bank rows [0, N), read in blocks as fp32 by
    ``rows(start, stop)``; rows >= n_valid score -1e30."""
    n_valid = N if n_valid is None else int(n_valid)
    if normalize:
        q = _normalize(q)
    bn = N if block_n is None else int(block_n)
    Q = q.shape[0]
    best_s = torch.empty((Q, 0), dtype=torch.float32, device=q.device)
    best_i = torch.empty((Q, 0), dtype=torch.int64, device=q.device)
    for j0 in range(0, N, bn):
        b = rows(j0, min(j0 + bn, N))
        if normalize:
            b = _normalize(b)
        s = q @ b.T                                          # (Q, bn)
        ids = torch.arange(j0, j0 + b.shape[0], device=q.device)
        s = torch.where(ids[None, :] < n_valid, s, torch.full_like(s, NEG_INF))
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids[None, :].expand(Q, -1)], dim=1)
        best_s, best_i = _topk_stable(cat_s, cat_i, k)
    return best_s, best_i.to(torch.int32)


def retrieval_topk_reference(query: torch.Tensor, bank: torch.Tensor, k: int,
                             *, normalize: bool = True,
                             n_valid: Optional[int] = None,
                             block_n: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E); bank (N, E) -> (scores (Q, k) f32, ids (Q, k) int32).
    Requires k <= N."""
    return _scan_rows(query.float(), lambda a, b: bank[a:b].float(),
                      bank.shape[0], k, normalize=normalize, n_valid=n_valid,
                      block_n=block_n)


def retrieval_topk_int4_reference(query: torch.Tensor, packed: torch.Tensor,
                                  scales: torch.Tensor, k: int, *,
                                  normalize: bool = False,
                                  n_valid: Optional[int] = None,
                                  block_n: Optional[int] = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E); packed (N, E//2) int8; scales (N, 1) -> (scores (Q, k)
    f32, ids (Q, k) int32). Requires k <= N."""
    return _scan_rows(query.float(),
                      lambda a, b: dequantize_int4(packed[a:b], scales[a:b]),
                      packed.shape[0], k, normalize=normalize,
                      n_valid=n_valid, block_n=block_n)


def retrieval_topk_int4_gathered_reference(
        query: torch.Tensor, packed: torch.Tensor, scales: torch.Tensor,
        row_ids: torch.Tensor, k: int, *, normalize: bool = False,
        n_valid: Optional[int] = None, block_l: Optional[int] = None
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E); packed (N, E//2) int8; scales (N, 1); row_ids (Q, L)
    candidate bank rows, L >= k -> (scores (Q, k) f32, global row ids
    (Q, k) int32). Ids < 0 (padding) or >= ``n_valid`` are dead and never
    read; a slot with no live candidate holds (-1e30, -1)."""
    N = packed.shape[0]
    nv = N if n_valid is None else int(n_valid)
    q = query.float()
    if normalize:
        q = _normalize(q)
    ids_all = row_ids.long()
    Q, L = ids_all.shape
    bl = L if block_l is None else int(block_l)
    best_s = torch.empty((Q, 0), dtype=torch.float32, device=q.device)
    best_i = torch.empty((Q, 0), dtype=torch.int64, device=q.device)
    for l0 in range(0, L, bl):
        ids = ids_all[:, l0:l0 + bl]
        live = (ids >= 0) & (ids < nv)
        safe = torch.where(live, ids, torch.zeros_like(ids))
        b = dequantize_int4(packed[safe], scales[safe])      # (Q, bl, E)
        if normalize:
            b = _normalize(b)
        s = torch.bmm(b, q[:, :, None])[..., 0]              # (Q, bl)
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        ids = torch.where(live, ids, torch.full_like(ids, -1))
        cat_s = torch.cat([best_s, s], dim=1)
        cat_i = torch.cat([best_i, ids], dim=1)
        # ties go to the lower id: order by id, then a stable score sort
        order = torch.argsort(cat_i, dim=1, stable=True)
        best_s, best_i = _topk_stable(torch.gather(cat_s, 1, order),
                                      torch.gather(cat_i, 1, order), k)
    best_i = torch.where(best_s > NEG_INF / 2, best_i,
                         torch.full_like(best_i, -1))
    return best_s, best_i.to(torch.int32)
