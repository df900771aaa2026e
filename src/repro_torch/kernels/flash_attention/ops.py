"""Dispatch for attention, forward and backward.

Layouts: q (B, Sq, H, D); k (B, Skv, KV, D), v (B, Skv, KV, Dv); GQA via
H = KV * G. A CPU tensor takes the plain versions (``ref.py``); a CUDA
tensor launches the hand-written kernels (``kernel.py``) or raises (MLA's
D 192 / Dv 128 runs the ``flash_fwd_mla`` kernel, forward only: its
backward raises). ``flash_attention`` is a
``torch.autograd.Function`` (the reference's ``custom_vjp``): its forward
saves q, k, v, out and lse, its backward runs the backward kernel on CUDA
and ``attention_bwd_reference`` on the CPU. ``launches`` counts forward
kernel launches, ``launches_by_head_dim`` splits that count by D (one
shape per tower on the serving path), ``bwd_launches`` counts backward
kernel launches (one a call: f32 delta, the one-pass kernel and the dQ
sum; bf16 the dQ and dK/dV kernels).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import (attention_bwd_reference,
                                                     attention_fwd_reference)

launches = 0
launches_by_head_dim: Dict[int, int] = {}
bwd_launches = 0


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, Dv) in q's dtype, lse (B, H, Sq) f32), no
    autograd."""
    global launches
    if q.device.type == "cpu":
        return attention_fwd_reference(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    from repro_torch.kernels.flash_attention.kernel import flash_fwd_cuda
    out = flash_fwd_cuda(q, k, v, causal=causal, window=window,
                         q_offset=q_offset, scale=scale)
    launches += 1
    D = q.shape[-1]
    launches_by_head_dim[D] = launches_by_head_dim.get(D, 0) + 1
    return out


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: int = 0, q_offset: int = 0,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's out and lse and the cotangent
    ``dout`` of out."""
    global bwd_launches
    kw = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
    if q.device.type == "cpu":
        return attention_bwd_reference(q, k, v, out, lse, dout, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention backward: no kernel for "
                         f"{q.device}")
    if v.shape[-1] != q.shape[-1]:
        raise NotImplementedError(
            f"flash_attention backward: no kernel for q/k head dim "
            f"{q.shape[-1]} with v head dim {v.shape[-1]} (MLA's forward "
            f"only; training an MLA model is not supported on CUDA)")
    from repro_torch.kernels.flash_attention.kernel import flash_bwd_cuda
    grads = flash_bwd_cuda(q, k, v, out, lse, dout, **kw)
    bwd_launches += 1
    return grads


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       q_offset=q_offset, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = dict(causal=causal, window=window, q_offset=q_offset,
                      scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention, differentiable in q, k, v. q (B,Sq,H,D), k (B,Skv,KV,D),
    v (B,Skv,KV,Dv) -> (B,Sq,H,Dv)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, q_offset, scale)
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)[0]
