"""Dispatch for RMSNorm, forward and backward: a CPU tensor takes the plain
versions, a CUDA tensor launches the Triton kernels or raises.
``rmsnorm_op`` is a ``torch.autograd.Function`` when a gradient is needed
(its backward the backward kernel on CUDA, ``rmsnorm_bwd_reference`` on
the CPU). ``launches`` counts forward kernel launches, ``bwd_launches``
backward ones."""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.rmsnorm.ref import (rmsnorm_bwd_reference,
                                             rmsnorm_reference)

launches = 0
bwd_launches = 0


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    global launches
    if x.device.type == "cpu":
        return rmsnorm_reference(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm: no kernel for {x.device}")
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_triton
    out = rmsnorm_triton(x, scale, eps)
    launches += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dscale) for the cotangent ``dy`` of ``rmsnorm_fwd``."""
    global bwd_launches
    if x.device.type == "cpu":
        return rmsnorm_bwd_reference(x, scale, dy, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm backward: no kernel for {x.device}")
    from repro_torch.kernels.rmsnorm.kernel import rmsnorm_bwd_triton
    grads = rmsnorm_bwd_triton(x, scale, dy, eps)
    bwd_launches += 1
    return grads


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, ds = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return (dx if ctx.needs_input_grad[0] else None,
                ds if ctx.needs_input_grad[1] else None, None)


def rmsnorm_op(x: torch.Tensor, scale: torch.Tensor,
               eps: float = 1e-6) -> torch.Tensor:
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    return rmsnorm_fwd(x, scale, eps)
