"""Dispatch for the int4 activation-cache quantize / dequantize.

A CPU tensor takes the plain version (``ref.py``); a CUDA tensor launches
the hand-written kernel (``kernel.py``) or raises. Leading dims are
flattened into rows, as the reference's ``quantize_int4`` takes any
``(..., D)``. Plain-int launch counters: ``launches`` (quantize) and
``launches_dequant``. The kernels have no backward (nor has the reference):
under grad mode an input that needs a gradient raises (``grad_guard``).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.grad_guard import NO_REFERENCE_GRAD, refuse_grad
from repro_torch.kernels.int4_cache.ref import (dequantize_int4_reference,
                                                quantize_int4_reference)

launches = 0
launches_dequant = 0


def quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D), D even -> (packed (..., D//2) int8, scale (..., 1) f32),
    bit-exact with ``quantize_int4_np``."""
    global launches
    if x.device.type == "cpu":
        return quantize_int4_reference(x)
    if x.device.type != "cuda":
        raise ValueError(f"int4_cache.quantize: no kernel for {x.device}")
    refuse_grad("int4_cache.quantize", NO_REFERENCE_GRAD, x)
    from repro_torch.kernels.int4_cache.kernel import int4_quant_cuda
    lead, D = x.shape[:-1], x.shape[-1]
    packed, scale = int4_quant_cuda(x.reshape(-1, D).contiguous())
    launches += 1
    return packed.reshape(*lead, D // 2), scale.reshape(*lead, 1)


def dequantize(packed: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize``: (..., D//2) int8 + (..., 1) f32 ->
    (..., D) ``dtype``."""
    global launches_dequant
    if packed.device.type == "cpu":
        return dequantize_int4_reference(packed, scale, dtype=dtype)
    if packed.device.type != "cuda":
        raise ValueError(f"int4_cache.dequantize: no kernel for "
                         f"{packed.device}")
    refuse_grad("int4_cache.dequantize", NO_REFERENCE_GRAD, scale)
    from repro_torch.kernels.int4_cache.kernel import int4_dequant_cuda
    lead, D2 = packed.shape[:-1], packed.shape[-1]
    out = int4_dequant_cuda(packed.reshape(-1, D2).contiguous(),
                            scale.reshape(-1, 1).contiguous(), dtype)
    launches_dequant += 1
    return out.reshape(*lead, 2 * D2)
