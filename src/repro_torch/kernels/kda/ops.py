"""Dispatch for the KDA chunked forward (Kimi Delta Attention's
recurrence over a prompt).

q, k, v (B, S, H, d) after the short convolutions (q and k L2-normed), g
(B, S, H, dk) fp32 the log-decay, beta (B, S, H) fp32, an optional fp32
initial state (B, H, dk, dv) -> (o (B, S, H, dv) in q's dtype, the final
state fp32). A CPU tensor takes the plain chunked version
(``ref.kda_chunked``); a CUDA tensor launches the kernel (``kernel.py``,
bf16 q, k, v at d 128) or raises. The kernel has no backward: under grad
mode an input that needs a gradient raises (``grad_guard``).

``counters``: ``launches`` (kernel calls) and ``tokens`` (Σ B·S·H over
them, the token-heads the recurrence ran).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels.grad_guard import refuse_grad
from repro_torch.kernels.kda.ref import kda_chunked

counters: Dict[str, int] = {"launches": 0, "tokens": 0}


def reset_counters() -> None:
    for k in counters:
        counters[k] = 0


def read_counters() -> Dict[str, int]:
    return dict(counters)


def kda_chunk(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              g: torch.Tensor, beta: torch.Tensor, *, scale: float,
              initial_state: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    if q.device.type == "cpu":
        return kda_chunked(q, k, v, g, beta, scale=scale,
                           initial_state=initial_state)
    if q.device.type != "cuda":
        raise ValueError(f"kda_chunk: no kernel for {q.device}")
    refuse_grad("kda_chunk", "ROADMAP F: KDA training", q, k, v, g, beta)
    from repro_torch.kernels.kda.kernel import kda_fwd_cuda
    out = kda_fwd_cuda(q, k, v, g, beta, scale=scale,
                       initial_state=initial_state)
    B, S, H = beta.shape
    counters["launches"] += 1
    counters["tokens"] += B * S * H
    return out
