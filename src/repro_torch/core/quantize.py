"""INT4 embedding/activation quantization (paper §3.4 cache analysis).

Per-row absmax scaling, two nibbles packed per int8: the low nibble holds
element 2i, the high nibble element 2i+1, and the low nibble is
sign-extended with ``(p << 4) >> 4``. The torch versions are bit-exact with
the numpy ones (same fp32 absmax / IEEE divide / round-half-even / clip
sequence), which are copied verbatim from the reference.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def quantize_int4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (..., D) with D even -> (packed (..., D//2) int8, scale (..., 1) f32)."""
    if x.shape[-1] % 2:
        raise ValueError(f"int4 packing needs an even last dim, got {x.shape}")
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    # divide by a tensor, not a Python number: on CUDA, PyTorch turns
    # division by a host scalar into a multiply by its reciprocal, which
    # differs from the IEEE quotient in the last bit
    scale = absmax / absmax.new_full((), 7.0)
    scale = torch.clamp_min(scale, 1e-12)
    # torch.round rounds half to even, like np.rint / jnp.round
    q = torch.clamp(torch.round(xf / scale), -8, 7).to(torch.int8)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = (lo & 0x0F) | (hi << 4)
    return packed, scale


def dequantize_int4(packed: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of quantize_int4: (..., D//2) int8 -> (..., D)."""
    lo = (packed << 4) >> 4  # sign-extend low nibble (arithmetic shift on int8)
    hi = packed >> 4
    out = torch.stack([lo, hi], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])
    return (out.float() * scale.float()).to(dtype)


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row int8 (gradient compression): x (..., D) -> (q (..., D) int8,
    scale (..., 1) f32), the scale the row's absmax / 127 floored at 1e-12,
    the quotient rounded half to even and clipped to [-128, 127]."""
    xf = x.float()
    absmax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(absmax / absmax.new_full((), 127.0), 1e-12)
    q = torch.clamp(torch.round(xf / scale), -128, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def quantize_int4_np(x: "np.ndarray") -> Tuple["np.ndarray", "np.ndarray"]:
    """Pure-numpy quantize (host-side inserts, no device dispatch)."""
    xf = np.asarray(x, np.float32)
    assert xf.shape[-1] % 2 == 0, xf.shape
    scale = np.max(np.abs(xf), axis=-1, keepdims=True) / np.float32(7.0)
    scale = np.maximum(scale, np.float32(1e-12))
    q = np.clip(np.rint(xf / scale), -8, 7).astype(np.int8)
    lo, hi = q[..., 0::2], q[..., 1::2]
    packed = (lo & np.int8(0x0F)) | (hi << 4)
    return packed, scale


def dequantize_int4_np(packed: "np.ndarray", scale: "np.ndarray",
                       dtype=None) -> "np.ndarray":
    """Pure-numpy mirror of ``dequantize_int4`` (bit-exact parity)."""
    p = np.asarray(packed, np.int8)
    lo = (p << 4) >> 4  # arithmetic shift sign-extends the low nibble
    hi = p >> 4
    D2 = p.shape[-1]
    out = np.stack([lo, hi], axis=-1).reshape(p.shape[:-1] + (2 * D2,))
    out = out.astype(np.float32) * np.asarray(scale, np.float32)
    return out if dtype is None else out.astype(dtype)
