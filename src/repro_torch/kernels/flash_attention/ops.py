"""Dispatch for attention forward.

Layouts: q (B, Sq, H, D); k, v (B, Skv, KV, D); GQA via H = KV * G. A CPU
tensor takes the plain version (``ref.py``); a CUDA tensor launches the
hand-written flash kernel (``kernel.py``) or raises. ``launches`` counts
kernel launches, and ``launches_by_head_dim`` splits that count by D (one
shape per tower on the serving path).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ref import attention_fwd_reference

launches = 0
launches_by_head_dim: Dict[int, int] = {}


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int = 0,
                        q_offset: int = 0, scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out (B, Sq, H, D) in q's dtype, lse (B, H, Sq) f32)."""
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


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, q_offset: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention forward. q (B,Sq,H,D), k/v (B,Skv,KV,D) -> (B,Sq,H,D)."""
    return flash_attention_fwd(q, k, v, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)[0]
