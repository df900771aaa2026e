"""Plain int4 row quantization and the int4 top-k scan, as RECALL's store
and activation cache define them: per-row absmax scale ``absmax / 7``
(floored at 1e-12), codes ``round_half_even(x / scale)`` clipped to
[-8, 7], two codes a byte. The reference keeps codes unpacked: only their
values are judged.
"""
from __future__ import annotations

from typing import Tuple

import torch


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) -> (codes (..., D) float32 in [-8, 7], scale (..., 1))."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / absmax.new_full((), 7.0), 1e-12)
    codes = torch.clamp(torch.round(xf / scale), -8, 7)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return codes * scale


def roundtrip(x: torch.Tensor) -> torch.Tensor:
    return dequantize(*quantize(x))


def topk(queries: torch.Tensor, rows: torch.Tensor, k: int
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(scores (Q, k), row ids (Q, k)) of the largest inner products of
    each query with the dequantized ``rows`` (N, E), in float32."""
    s = queries.float() @ rows.float().T
    v, i = torch.topk(s, min(k, rows.shape[0]), dim=-1)
    return v, i


def cell_gap(ref: torch.Tensor, served: torch.Tensor) -> float:
    """How far the served dequantized rows lie outside the rounding cells
    of the reference's float32 rows, in quantization steps of the
    reference's scale: max over elements of |ref - served| / scale - 1/2,
    floored at 0. A served row that is the int4 image of the reference row
    reads 0; one computed a little differently reads its error in steps
    wherever that error moves a value past a rounding edge."""
    _, scale = quantize(ref)
    err = (ref.float() - served.float()).abs() / scale
    return max(float(err.max()) - 0.5, 0.0) if err.numel() else 0.0
