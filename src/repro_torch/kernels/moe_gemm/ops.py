"""Grouped expert GEMM: sort-by-expert -> padded grouped GEMM -> unsort.

``moe_gemm(x, expert_ids, w)`` computes y[t] = x[t] @ w[expert_ids[t]]. The
plan (``sort_by_expert``) is torch ops on the tensors' device with static
shapes: no host sync, no data-dependent shape. ``moe_gemm_sorted`` is the
kernel's dispatch: a CPU tensor takes the plain version (``ref.py``), a CUDA
tensor launches the hand-written grouped GEMM (``kernel.py``) or raises.
``launches`` counts kernel launches, and ``launches_by_kernel`` splits that
count by the kernel that ran (``kernel.kernel_for``). The kernel has no
backward yet (ROADMAP A.4b): under grad mode an input that needs a gradient
raises (``grad_guard``).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.moe_gemm.ref import moe_gemm_sorted_reference

launches = 0
launches_by_kernel: Dict[str, int] = {}


class Plan(NamedTuple):
    order: torch.Tensor         # (T,) token ids grouped by expert (stable)
    slot: torch.Tensor          # (T,) row of sorted token i in the buffer
    block_expert: torch.Tensor  # (T_pad // block_t,) int32
    T_pad: int                  # static bound ((T + bt - 1)//bt + E) * bt
    used: torch.Tensor          # () int32 rows in real groups, on device


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
    return Plan(order, slot.to(torch.int32), block_expert, T_pad,
                ends[-1].to(torch.int32))


def sort_by_expert(expert_ids: torch.Tensor, n_experts: int, block_t: int
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """The reference's plan: (order, slot, block_expert, T_pad)."""
    return tuple(plan(expert_ids, n_experts, block_t)[:4])


def moe_gemm_sorted(xs: torch.Tensor, block_expert: torch.Tensor,
                    w: torch.Tensor, block_t: int,
                    used: torch.Tensor) -> torch.Tensor:
    """ys (T_pad, F) = xs @ w[block_expert[row // block_t]] for rows below
    ``used``; rows from ``used`` on are not computed (the plain version
    leaves them 0, the kernel leaves them unwritten)."""
    global launches
    if xs.device.type == "cpu":
        return moe_gemm_sorted_reference(xs, block_expert, w, block_t, used)
    if xs.device.type != "cuda":
        raise ValueError(f"moe_gemm: no kernel for {xs.device}")
    refuse_grad("moe_gemm", "ROADMAP A.4b: the grouped GEMM backward", xs, w)
    from repro_torch.kernels.moe_gemm.kernel import kernel_for, moe_gemm_cuda
    out = moe_gemm_cuda(xs, block_expert, w, block_t, used)
    launches += 1
    name = kernel_for(xs.dtype, block_t, xs.shape[1], w.shape[2])
    launches_by_kernel[name] = launches_by_kernel.get(name, 0) + 1
    return out


def scatter_rows(x: torch.Tensor, p: Plan, token_of=None) -> torch.Tensor:
    """The (T_pad, d) sorted buffer: row ``slot[i]`` holds token
    ``order[i]`` (``token_of`` maps an assignment to its row of ``x``);
    padding rows are 0."""
    src = p.order if token_of is None else token_of(p.order)
    xs = torch.zeros((p.T_pad, x.shape[1]), dtype=x.dtype, device=x.device)
    xs[p.slot.long()] = x[src]
    return xs


def gather_rows(ys: torch.Tensor, p: Plan) -> torch.Tensor:
    """Inverse of ``scatter_rows``: (T, F) in the original token order."""
    slot_of = torch.empty_like(p.slot)
    slot_of[p.order] = p.slot
    return ys[slot_of.long()]


def moe_gemm(x: torch.Tensor, expert_ids: torch.Tensor, w: torch.Tensor, *,
             block_t: int = 0) -> torch.Tensor:
    """x (T, d); expert_ids (T,); w (E, d, F) -> (T, F). ``block_t`` 0
    picks the token block from T and E (``block_t_for``)."""
    E = w.shape[0]
    bt = block_t or block_t_for(x.shape[0], E)
    p = plan(expert_ids, E, bt)
    ys = moe_gemm_sorted(scatter_rows(x, p), p.block_expert, w, bt, p.used)
    return gather_rows(ys, p)
