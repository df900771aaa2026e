"""Dispatch for the fused int4 retrieval top-k.

The device of the bank decides: a CPU bank takes the plain version
(``ref.py``, streamed in ``PLAIN_BLOCK_N``-row chunks), a CUDA bank
launches the hand-written kernel (``kernel.py``) or raises. ``launches``
counts kernel launches.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.retrieval_topk.ref import retrieval_topk_int4_reference

PLAIN_BLOCK_N = 65536
launches = 0


def retrieval_topk_int4(query: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, k: int, *,
                        normalize: bool = False,
                        n_valid: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a packed int4 bank: ``packed`` (N, E//2) int8 nibble rows
    + ``scales`` (N, 1) per-row absmax (``quantize_int4`` layout); rows
    ``>= n_valid`` score -1e30. Returns ((Q, k) f32 scores, (Q, k) int32
    row ids), descending, ties to the lower id."""
    global launches
    if packed.device.type == "cpu":
        return retrieval_topk_int4_reference(query, packed, scales, k,
                                             normalize=normalize,
                                             n_valid=n_valid,
                                             block_n=PLAIN_BLOCK_N)
    if packed.device.type != "cuda":
        raise ValueError(f"retrieval_topk_int4: no kernel for {packed.device}")
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_cuda)
    out = retrieval_topk_int4_cuda(query, packed, scales, k,
                                   normalize=normalize, n_valid=n_valid)
    launches += 1
    return out
