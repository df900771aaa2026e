"""Plain PyTorch split GEMMs: fp32 activations times bf16 weights, with x
split exactly into three bf16 terms and each term's product summed in
fp32, the arithmetic of ``csrc/split_gemm.cu``.

``split3(x)`` is the split (as fp32 tensors whose values are bf16):
x1 = x with its low 16 bits cleared (bf16 rounded toward zero),
x2 = the same of r = |x| - |x1|, x3 = r - |x2|, both with x's sign, so
x1 + x2 + x3 == x bit for bit for |x| >= 2^-103, ±0 included; below,
bits under 2^-133 (bf16's subnormal step) are lost. For inf and NaN, x1
is x (a NaN stays a NaN) and x2 = x3 = 0. ``matmul`` and
``swiglu_gate_up`` sum the three terms' products, smallest first.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

_HIGH = -65536          # 0xffff0000 as int32: a float's bf16 half
_SIGN = -2 ** 31        # 0x80000000
_I32, _F32 = torch.int32, torch.float32


def split3(x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(x1, x2, x3), fp32 tensors holding bf16 values, of fp32 ``x``."""
    if x.dtype != _F32:
        raise TypeError(f"split3 takes float32, got {x.dtype}")
    u = x.contiguous().view(_I32)
    # a NaN whose payload lies below bit 16 would truncate to inf: quiet it
    u = torch.where((u & 0x7FFFFFFF) > 0x7F800000, u | 0x00400000, u)
    sign = u & _SIGN
    x1 = (u & _HIGH).view(_F32)
    # exact and >= 0 for finite x; inf - inf and NaN give NaN, fmax 0
    r = torch.fmax(x.abs() - x1.abs(), torch.zeros_like(x))
    q = r.view(_I32) & _HIGH
    x2 = (q | sign).view(_F32)
    x3 = ((r - q.view(_F32)).view(_I32) & _HIGH | sign).view(_F32)
    return x1, x2, x3


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) fp32 @ w (K, N) bf16 -> (M, N) fp32."""
    wf = w.float()
    x1, x2, x3 = split3(x)
    return (x3 @ wf + x2 @ wf) + x1 @ wf


def swiglu_gate_up(x: torch.Tensor, w_gate: torch.Tensor,
                   w_up: torch.Tensor) -> torch.Tensor:
    """h (M, N) fp32 = SiLU(x @ w_gate) * (x @ w_up), each product split."""
    return F.silu(matmul(x, w_gate)) * matmul(x, w_up)
