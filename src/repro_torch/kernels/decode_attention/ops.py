"""Dispatch for single-token decode attention.

q (B, H, D); k, v (B, S, KV, D); lengths (B,) int32 -> (B, H, D) in q's
dtype. A CPU tensor takes the plain version (``ref.py``); a CUDA tensor
launches the hand-written flash-decoding kernel (``kernel.py``) or raises.
``launches`` counts kernel launches (one per call: the split pass and its
merge). The kernel has no backward: under grad mode an input that needs a
gradient raises (``grad_guard``).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import (
    decode_attention_reference)
from repro_torch.kernels.grad_guard import NO_REFERENCE_GRAD, refuse_grad

launches = 0


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One query token per sequence against its cache; see ``ref.py``."""
    global launches
    if q.device.type == "cpu":
        return decode_attention_reference(q, k, v, lengths, window=window,
                                          scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: no kernel for {q.device}")
    refuse_grad("decode_attention", NO_REFERENCE_GRAD, q, k, v)
    from repro_torch.kernels.decode_attention.kernel import decode_attn_cuda
    out = decode_attn_cuda(q, k, v, lengths, window=window, scale=scale)
    launches += 1
    return out
