"""Matmul precisions of the plain reference and of its controls.

Every matrix product of the reference goes through ``matmul``. At
``"fp32"`` it is a plain float32 product (the harness turns TF32 off). The
lower precisions round both operands first and accumulate in float32, the
same on the CPU and on the card:

* ``"tf32"``: each operand rounded to TF32 (10 explicit mantissa bits,
  round to nearest even), what the tensor cores take for a float32 product
  with TF32 on: the step below float32;
* ``"fp8"``: each operand scaled so that its absmax along the contracted
  dimension is 448, cast to ``float8_e4m3fn`` and back, the usual
  per-row / per-column fp8 recipe: the step below bfloat16.
"""
from __future__ import annotations

import torch

PRECISIONS = ("fp32", "tf32", "fp8")


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, kept in float32."""
    xi = x.float().contiguous().view(torch.int32)
    lsb = (xi >> 13) & 1
    xi = (xi + 0x0FFF + lsb) & -8192
    return xi.view(torch.float32)


def round_fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x scaled to absmax 448 along ``dim``, rounded through e4m3, scaled
    back."""
    xf = x.float()
    amax = xf.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    s = 448.0 / amax
    return (xf * s).to(torch.float8_e4m3fn).float() / s


def matmul(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32"
           ) -> torch.Tensor:
    """a (..., M, K) @ b (..., K, N) in float32 at ``prec``."""
    a, b = a.float(), b.float()
    if prec == "fp32":
        return a @ b
    if prec == "tf32":
        return round_tf32(a) @ round_tf32(b)
    if prec == "fp8":
        return round_fp8(a, -1) @ round_fp8(b, -2)
    raise ValueError(f"precision {prec!r}")
