"""Grouped expert GEMM: sort-by-expert -> padded grouped GEMM -> unsort.

``moe_gemm(x, expert_ids, w)`` computes y[t] = x[t] @ w[expert_ids[t]]. The
plan (``sort_by_expert``) is torch ops on the tensors' device with static
shapes: no host sync, no data-dependent shape. ``moe_gemm_sorted`` is the
kernel's dispatch: a CPU tensor takes the plain version (``ref.py``), a CUDA
tensor launches the hand-written grouped GEMM (``kernel.py``) or raises.
``launches`` counts kernel launches, and ``launches_by_kernel`` splits that
count by the kernel that ran (``kernel.kernel_for``).

Under grad mode ``moe_gemm_sorted`` is a ``torch.autograd.Function``: its
backward is the same grouped product again, dxs = dys @ w[e]^T block by
block (``moe_gemm_sorted_dx``) and dw[e] = xs_e^T @ dys_e over each
expert's rows (``moe_gemm_sorted_dw``), each launched only for an input
that needs its gradient; on the CPU the plain versions. ``bwd_launches``
counts backward kernel launches, ``bwd_launches_by_kernel`` splits them
into ``dx_wgmma``, ``dx_mma_sync``, ``dw_wgmma`` and ``dw_mma_sync``.

``moe_gemm_sorted_swiglu`` is the MoE layer's gate, up and SiLU·up in one
call: the plain three steps on a CPU tensor, one launch of the fused wgmma
kernel on a CUDA tensor (counted in ``launches`` and as ``swiglu_wgmma``).
It has no backward; ``swiglu_takes`` is the rule by which the layer takes
it: CUDA tensors on the wgmma kernel's shapes, no gradient recorded through
them. ``scatter_rows`` and
``gather_rows`` move rows by index; the backward of ``scatter_rows`` sums
a token's ``top_k`` assignment gradients in a fixed order, so a MoE
layer's gradient has the same bits twice.

``dispatch_rows`` and ``combine_rows`` are the same row moves on the row
kernels (``csrc/moe_rows.cu``): the sorted buffer in one token-major pass,
and each token's ``top_k`` sorted rows weighed and summed in one pass (the
gather and the MoE layer's batched product). Neither has a backward;
``rows_take`` is the rule by which the layer takes them: CUDA tensors, no
gradient recorded through them. ``row_launches`` counts their launches
apart from the GEMMs', ``row_launches_by_kernel`` splits them into
``dispatch`` and ``combine``.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.moe_gemm.ref import (
    combine_rows_reference, dispatch_rows_reference,
    moe_gemm_sorted_dw_reference, moe_gemm_sorted_dx_reference,
    moe_gemm_sorted_reference, moe_gemm_sorted_swiglu_reference)

launches = 0
launches_by_kernel: Dict[str, int] = {}
bwd_launches = 0
bwd_launches_by_kernel: Dict[str, int] = {}
row_launches = 0
row_launches_by_kernel: Dict[str, int] = {}


class Plan(NamedTuple):
    order: torch.Tensor         # (T,) token ids grouped by expert (stable)
    slot: torch.Tensor          # (T,) row of sorted token i in the buffer
    block_expert: torch.Tensor  # (T_pad // block_t,) int32
    T_pad: int                  # static bound ((T + bt - 1)//bt + E) * bt
    used: torch.Tensor          # () int32 rows in real groups, on device
    ends: torch.Tensor          # (E,) int32 end row of each expert's group
    counts: torch.Tensor        # (E,) int32 real rows of each group
    slot_of: torch.Tensor       # (T,) int32 row of assignment i (inverse)


def block_t_for(T: int, n_experts: int) -> int:
    """Token-block rows: 128 or 64 where the average group fills a tile of
    that many rows (a prefill: the wgmma kernel, whose 128-row tile reads
    each slice of an expert's weights once for twice the rows), else 16, so
    a sparse batch (decode) pads each expert's few tokens to 16 rows."""
    for bt in (128, 64):
        if T >= bt * n_experts:
            return bt
    return 16


def plan(expert_ids: torch.Tensor, n_experts: int, block_t: int) -> Plan:
    """Sort/pad plan: each expert's group is padded up to a multiple of
    ``block_t`` rows so no token block straddles two experts. Blocks past
    the last real group map to expert E - 1 (clipped, as the reference)."""
    dev = expert_ids.device
    T = expert_ids.shape[0]
    ids = expert_ids.long()
    counts = torch.zeros(n_experts, dtype=torch.int64, device=dev)
    counts.index_add_(0, ids, torch.ones_like(ids))
    padded = (counts + block_t - 1) // block_t * block_t
    ends = torch.cumsum(padded, 0)
    starts = ends - padded
    T_pad = ((T + block_t - 1) // block_t + n_experts) * block_t
    order = torch.argsort(ids, stable=True)
    sorted_e = ids[order]
    group_start = torch.cumsum(counts, 0) - counts
    pos_in_group = torch.arange(T, device=dev) - group_start[sorted_e]
    slot = starts[sorted_e] + pos_in_group
    block_starts = torch.arange(T_pad // block_t, device=dev) * block_t
    block_expert = torch.clamp(
        torch.searchsorted(ends, block_starts, right=True), 0,
        n_experts - 1).to(torch.int32)
    slot = slot.to(torch.int32)
    slot_of = torch.empty_like(slot)
    slot_of[order] = slot
    return Plan(order, slot, block_expert, T_pad, ends[-1].to(torch.int32),
                ends.to(torch.int32), counts.to(torch.int32), slot_of)


def sort_by_expert(expert_ids: torch.Tensor, n_experts: int, block_t: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The reference's plan: (order, slot, block_expert, T_pad)."""
    return tuple(plan(expert_ids, n_experts, block_t)[:4])


def _count(counter: Dict[str, int], name: str) -> None:
    counter[name] = counter.get(name, 0) + 1


def moe_gemm_sorted_fwd(xs: torch.Tensor, block_expert: torch.Tensor,
                        w: torch.Tensor, block_t: int,
                        used: torch.Tensor) -> torch.Tensor:
    """``moe_gemm_sorted`` without autograd."""
    global launches
    if xs.device.type == "cpu":
        return moe_gemm_sorted_reference(xs, block_expert, w, block_t, used)
    if xs.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for {xs.device}")
    from repro_torch.kernels.moe_gemm.kernel import kernel_for, moe_gemm_cuda
    out = moe_gemm_cuda(xs, block_expert, w, block_t, used)
    launches += 1
    _count(launches_by_kernel,
           kernel_for(xs.dtype, block_t, xs.shape[1], w.shape[2]))
    return out


def moe_gemm_sorted_dx(dys: torch.Tensor, block_expert: torch.Tensor,
                       w: torch.Tensor, block_t: int,
                       used: torch.Tensor) -> torch.Tensor:
    """The gradient of xs, (T_pad, d): dys[r] @ w[e(r)]^T for rows below
    ``used``, 0 from ``used`` on (dys is not read there)."""
    global bwd_launches
    if dys.device.type == "cpu":
        return moe_gemm_sorted_dx_reference(dys, block_expert, w, block_t,
                                            used)
    if dys.device.type != "cuda":
        raise ValueError(f"moe_gemm backward: no kernel for {dys.device}")
    from repro_torch.kernels.moe_gemm.kernel import kernel_for, moe_gemm_cuda
    out = moe_gemm_cuda(dys, block_expert, w, block_t, used, dx=True)
    bwd_launches += 1
    _count(bwd_launches_by_kernel, "dx_" + kernel_for(
        dys.dtype, block_t, dys.shape[1], w.shape[1]))
    return out


def moe_gemm_sorted_dw(xs: torch.Tensor, dys: torch.Tensor,
                       block_expert: torch.Tensor, ends: torch.Tensor,
                       block_t: int, used: torch.Tensor,
                       dtype: torch.dtype) -> torch.Tensor:
    """The gradient of w, (E, d, F) in ``dtype`` (w's; on the card xs's,
    which the forward kernel requires w's to be): each expert's xs^T @ dys
    over the rows of its group (``ends``, the plan's), below ``used``."""
    global bwd_launches
    if xs.device.type == "cpu":
        return moe_gemm_sorted_dw_reference(xs, dys, block_expert,
                                            ends.shape[0], block_t, used,
                                            dtype)
    if xs.device.type != "cuda":
        raise ValueError(f"moe_gemm backward: no kernel for {xs.device}")
    from repro_torch.kernels.moe_gemm.kernel import (kernel_for,
                                                     moe_gemm_dw_cuda)
    out = moe_gemm_dw_cuda(xs, dys, ends, block_t, used)
    bwd_launches += 1
    _count(bwd_launches_by_kernel, "dw_" + kernel_for(
        xs.dtype, block_t, xs.shape[1], dys.shape[1]))
    return out


class _MoEGemmSorted(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, block_expert, w, block_t, used, ends):
        ys = moe_gemm_sorted_fwd(xs, block_expert, w, block_t, used)
        ctx.save_for_backward(xs, block_expert, w, used, ends)
        ctx.block_t = block_t
        return ys

    @staticmethod
    def backward(ctx, dys):
        xs, block_expert, w, used, ends = ctx.saved_tensors
        bt = ctx.block_t
        dys = dys.contiguous()
        dxs = moe_gemm_sorted_dx(dys, block_expert, w, bt, used) \
            if ctx.needs_input_grad[0] else None
        dw = moe_gemm_sorted_dw(xs, dys, block_expert, ends, bt, used,
                                w.dtype) if ctx.needs_input_grad[2] else None
        return dxs, None, dw, None, None, None


def moe_gemm_sorted(xs: torch.Tensor, block_expert: torch.Tensor,
                    w: torch.Tensor, block_t: int, used: torch.Tensor,
                    ends: torch.Tensor) -> torch.Tensor:
    """ys (T_pad, F) = xs @ w[block_expert[row // block_t]] for rows below
    ``used``; rows from ``used`` on are not computed (the plain version
    leaves them 0, the kernel leaves them unwritten). Differentiable in xs
    and w (the gradient of w walks each expert's group up to ``ends``, the
    plan's)."""
    if torch.is_grad_enabled() and (xs.requires_grad or w.requires_grad):
        return _MoEGemmSorted.apply(xs, block_expert, w, block_t, used, ends)
    return moe_gemm_sorted_fwd(xs, block_expert, w, block_t, used)


def swiglu_takes(xs: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, block_t: int) -> bool:
    """Whether gate, up and SiLU·up of the sorted rows may take
    ``moe_gemm_sorted_swiglu``'s one launch: CUDA tensors of one dtype on
    the shapes ``kernel.kernel_for`` gives the wgmma kernel, and no
    gradient recorded through them (the fused kernel has no backward)."""
    if xs.device.type != "cuda" or w_gate.dtype != xs.dtype or \
            w_up.dtype != xs.dtype:
        return False
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (xs, w_gate, w_up)):
        return False
    from repro_torch.kernels.moe_gemm.kernel import kernel_for
    return kernel_for(xs.dtype, block_t, xs.shape[1],
                      w_gate.shape[2]) == "wgmma"


def moe_gemm_sorted_swiglu(xs: torch.Tensor, block_expert: torch.Tensor,
                           w_gate: torch.Tensor, w_up: torch.Tensor,
                           block_t: int, used: torch.Tensor) -> torch.Tensor:
    """h (T_pad, F) = SiLU(g) * u, g and u the sorted rows' products
    through ``w_gate`` and ``w_up`` rounded to xs's dtype, SiLU in fp32 cast
    back (the three steps the MoE layer takes under grad mode, with their
    roundings); rows from ``used`` on are 0 on the CPU, unwritten on the
    card. On the card one launch of ``moe_gemm_wgmma_swiglu``: g and u never
    reach device memory; no backward."""
    global launches
    if xs.device.type == "cpu":
        return moe_gemm_sorted_swiglu_reference(xs, block_expert, w_gate,
                                                w_up, block_t, used)
    if xs.device.type != "cuda":
        raise ValueError(f"moe_gemm swiglu: no kernel for {xs.device}")
    refuse_grad("moe_gemm swiglu", "the MoE layer takes the three grouped "
                "GEMMs under grad mode", xs, w_gate, w_up)
    from repro_torch.kernels.moe_gemm.kernel import moe_gemm_swiglu_cuda
    out = moe_gemm_swiglu_cuda(xs, block_expert, w_gate, w_up, block_t, used)
    launches += 1
    _count(launches_by_kernel, "swiglu_wgmma")
    return out


def scatter_rows(x: torch.Tensor, p: Plan, top_k: int = 1) -> torch.Tensor:
    """The (T_pad, d) sorted buffer: assignment a (token ``a // top_k`` of
    x) at row ``slot_of[a]``; padding rows are 0. The backward gathers each
    assignment's row and sums a token's ``top_k`` of them in order."""
    xa = x if top_k == 1 else x.unsqueeze(1).expand(
        -1, top_k, -1).reshape(-1, x.shape[1])
    xs = torch.zeros((p.T_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    xs[p.slot_of.long()] = xa
    return xs


def gather_rows(ys: torch.Tensor, p: Plan) -> torch.Tensor:
    """Inverse of ``scatter_rows``: (T, F) in the original token order."""
    return ys[p.slot_of.long()]


def rows_take(*tensors: torch.Tensor) -> bool:
    """Whether the MoE layer moves its rows on the row kernels
    (``dispatch_rows``, ``combine_rows``): CUDA tensors, and no gradient
    recorded through them (the kernels have no backward)."""
    if any(t.device.type != "cuda" for t in tensors):
        return False
    return not (torch.is_grad_enabled() and
                any(t.requires_grad for t in tensors))


def dispatch_rows(x: torch.Tensor, p: Plan, top_k: int = 1) -> torch.Tensor:
    """``scatter_rows``' buffer below ``used``: token t's row of x at each of
    its ``top_k`` rows ``slot_of[t * top_k + k]``, padding rows 0; rows from
    ``used`` on are 0 on the CPU, unwritten on the card. On the card one
    launch of ``moe_dispatch_rows``, which reads each row of x once; no
    backward."""
    global row_launches
    if x.device.type == "cpu":
        return dispatch_rows_reference(x, p.slot_of, p.T_pad, top_k)
    if x.device.type != "cuda":
        raise ValueError(f"moe dispatch rows: no kernel for {x.device}")
    refuse_grad("moe dispatch rows", "the MoE layer takes scatter_rows "
                "under grad mode", x)
    from repro_torch.kernels.moe_gemm.kernel import moe_dispatch_rows_cuda
    out = moe_dispatch_rows_cuda(x.contiguous(), p.slot_of, p.counts, p.ends,
                                 p.T_pad, top_k)
    row_launches += 1
    _count(row_launches_by_kernel, "dispatch")
    return out


def combine_rows(ys: torch.Tensor, p: Plan, w: torch.Tensor) -> torch.Tensor:
    """y (T, d) in ys's dtype: token t's K = w.shape[1] sorted rows
    ``ys[slot_of[t * K + k]]`` summed by their weights w (T, K), each
    rounded to ys's dtype. On the CPU the MoE layer's gather and batched
    product; on the card one launch of ``moe_combine_rows``, which sums in
    fp32 in the order k = 0 .. K - 1 and rounds once (within one step of
    ys's dtype of the batched product); no backward."""
    global row_launches
    if ys.device.type == "cpu":
        return combine_rows_reference(ys, p.slot_of, w)
    if ys.device.type != "cuda":
        raise ValueError(f"moe combine rows: no kernel for {ys.device}")
    refuse_grad("moe combine rows", "the MoE layer takes gather_rows and "
                "torch.bmm under grad mode", ys, w)
    from repro_torch.kernels.moe_gemm.kernel import moe_combine_rows_cuda
    out = moe_combine_rows_cuda(ys, p.slot_of, w.float().contiguous())
    row_launches += 1
    _count(row_launches_by_kernel, "combine")
    return out


def moe_gemm(x: torch.Tensor, expert_ids: torch.Tensor, w: torch.Tensor, *,
             block_t: int = 0) -> torch.Tensor:
    """x (T, d); expert_ids (T,); w (E, d, F) -> (T, F). ``block_t`` 0
    picks the token block from T and E (``block_t_for``)."""
    E = w.shape[0]
    bt = block_t or block_t_for(x.shape[0], E)
    p = plan(expert_ids, E, bt)
    ys = moe_gemm_sorted(scatter_rows(x, p), p.block_expert, w, bt, p.used,
                         p.ends)
    return gather_rows(ys, p)
