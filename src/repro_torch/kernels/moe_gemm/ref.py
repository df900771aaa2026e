"""Plain PyTorch grouped expert GEMM.

``moe_gemm_reference`` is the reference's oracle: y[t] = x[t] @ w[e[t]] in
fp32, cast to x's dtype (computed one expert at a time instead of gathering
a (T, d, F) weight copy). ``moe_gemm_sorted_reference`` is the plain version
of the kernel's own function on the expert-sorted, block-padded layout of
``ops.sort_by_expert``: rows below ``used`` are multiplied by their block's
expert, rows from ``used`` on are left 0.
"""
from __future__ import annotations

import torch


def moe_gemm_reference(x: torch.Tensor, expert_ids: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """x (T, d); expert_ids (T,) in [0, E); w (E, d, F) -> (T, F)."""
    out = torch.zeros((x.shape[0], w.shape[2]), dtype=x.dtype,
                      device=x.device)
    for e in torch.unique(expert_ids).tolist():
        rows = torch.nonzero(expert_ids == e)[:, 0]
        out[rows] = (x[rows].float() @ w[e].float()).to(x.dtype)
    return out


def moe_gemm_sorted_reference(xs: torch.Tensor, block_expert: torch.Tensor,
                              w: torch.Tensor, block_t: int,
                              used: torch.Tensor) -> torch.Tensor:
    """xs (T_pad, d) sorted by expert, each group padded to ``block_t``
    rows; block_expert (T_pad // block_t,); used () rows in real groups ->
    (T_pad, F) in xs's dtype."""
    ys = torch.zeros((xs.shape[0], w.shape[2]), dtype=xs.dtype,
                     device=xs.device)
    n_used = int(used) // block_t
    experts = block_expert[:n_used].tolist()
    b0 = 0
    for b in range(1, n_used + 1):  # one product per run of equal experts
        if b == n_used or experts[b] != experts[b0]:
            r0, r1 = b0 * block_t, b * block_t
            ys[r0:r1] = (xs[r0:r1].float() @ w[experts[b0]].float()).to(
                xs.dtype)
            b0 = b
    return ys
