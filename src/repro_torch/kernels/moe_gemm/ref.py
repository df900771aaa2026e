"""Plain PyTorch grouped expert GEMM.

``moe_gemm_reference`` is the reference's oracle: y[t] = x[t] @ w[e[t]] in
fp32, cast to x's dtype (computed one expert at a time instead of gathering
a (T, d, F) weight copy). ``moe_gemm_sorted_reference`` is the plain version
of the kernel's own function on the expert-sorted, block-padded layout of
``ops.sort_by_expert``: rows below ``used`` are multiplied by their block's
expert, rows from ``used`` on are left 0. ``moe_gemm_sorted_dx_reference``
and ``moe_gemm_sorted_dw_reference`` are the plain versions of its backward
on the same layout (the gradients of xs and of w), which read no row from
``used`` on. ``moe_gemm_sorted_swiglu_reference`` is the plain version of
the fused gate/up kernel: the MoE layer's three steps, gate, up and
``F.silu(g.float()).to(dtype) * u``. ``dispatch_rows_reference`` and
``combine_rows_reference`` are the plain versions of the row kernels
(``csrc/moe_rows.cu``): token rows into the sorted layout through the
plan's ``slot_of``, and each token's ``top_k`` sorted rows back, weighed
and summed as the MoE layer's batched product sums them.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
    for e, r0, r1 in _groups(block_expert, block_t, used):
        ys[r0:r1] = (xs[r0:r1].float() @ w[e].float()).to(xs.dtype)
    return ys


def moe_gemm_sorted_swiglu_reference(xs: torch.Tensor,
                                     block_expert: torch.Tensor,
                                     w_gate: torch.Tensor,
                                     w_up: torch.Tensor, block_t: int,
                                     used: torch.Tensor) -> torch.Tensor:
    """h (T_pad, F) in xs's dtype = SiLU(g) * u with g and u the sorted
    products through ``w_gate`` and ``w_up`` (E, d, F), each in xs's dtype,
    and SiLU taken in fp32 and cast back; rows from ``used`` on are 0."""
    g = moe_gemm_sorted_reference(xs, block_expert, w_gate, block_t, used)
    u = moe_gemm_sorted_reference(xs, block_expert, w_up, block_t, used)
    return F.silu(g.float()).to(xs.dtype) * u


def _groups(block_expert: torch.Tensor, block_t: int, used: torch.Tensor):
    """(expert, first row, end row) of each run of equal experts among the
    blocks below ``used``: each expert's group, in order."""
    n_used = int(used) // block_t
    experts = block_expert[:n_used].tolist()
    b0 = 0
    for b in range(1, n_used + 1):
        if b == n_used or experts[b] != experts[b0]:
            yield experts[b0], b0 * block_t, b * block_t
            b0 = b


def moe_gemm_sorted_dx_reference(dys: torch.Tensor,
                                 block_expert: torch.Tensor, w: torch.Tensor,
                                 block_t: int,
                                 used: torch.Tensor) -> torch.Tensor:
    """The gradient of xs: dys (T_pad, F), w (E, d, F) -> (T_pad, d) in
    dys's dtype, dys[r] @ w[e(r)]^T in fp32 for rows below ``used``, 0 from
    ``used`` on (dys is not read there)."""
    dxs = torch.zeros((dys.shape[0], w.shape[1]), dtype=dys.dtype,
                      device=dys.device)
    for e, r0, r1 in _groups(block_expert, block_t, used):
        dxs[r0:r1] = (dys[r0:r1].float() @ w[e].float().T).to(dys.dtype)
    return dxs


def moe_gemm_sorted_dw_reference(xs: torch.Tensor, dys: torch.Tensor,
                                 block_expert: torch.Tensor, n_experts: int,
                                 block_t: int, used: torch.Tensor,
                                 dtype: torch.dtype = None) -> torch.Tensor:
    """The gradient of w: xs (T_pad, d), dys (T_pad, F) -> (E, d, F) in
    ``dtype`` (w's; default xs's), each expert's xs^T dys summed in fp32
    over its rows below ``used``, 0 for an expert with no rows."""
    dw = torch.zeros((n_experts, xs.shape[1], dys.shape[1]),
                     dtype=dtype or xs.dtype, device=xs.device)
    for e, r0, r1 in _groups(block_expert, block_t, used):
        dw[e] = (xs[r0:r1].float().T @ dys[r0:r1].float()).to(dw.dtype)
    return dw


def dispatch_rows_reference(x: torch.Tensor, slot_of: torch.Tensor,
                            T_pad: int, top_k: int) -> torch.Tensor:
    """x (T, d) -> the sorted buffer (T_pad, d): token t's row at each of
    its ``top_k`` rows ``slot_of[t * top_k + k]``, every other row 0 (the
    padding rows, which the kernel zeroes, and the rows from ``used`` on,
    which it leaves unwritten)."""
    xs = torch.zeros((T_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    slots = slot_of.long().view(-1, top_k)
    for k in range(top_k):
        xs[slots[:, k]] = x
    return xs


def combine_rows_reference(ys: torch.Tensor, slot_of: torch.Tensor,
                           w: torch.Tensor) -> torch.Tensor:
    """ys (T_pad, d) sorted rows, w (T, K) -> y (T, d) in ys's dtype: token
    t's K rows ``ys[slot_of[t * K + k]]`` summed by their weights, each
    weight rounded to ys's dtype, in one batched product (the MoE layer's
    torch steps, bit for bit)."""
    T, K = w.shape
    rows = ys[slot_of.long()].view(T, K, ys.shape[1])
    return torch.bmm(w.to(ys.dtype)[:, None, :], rows)[:, 0]
