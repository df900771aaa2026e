"""Triton RMSNorm for Hopper.

Replaces the TPU kernel repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel
(entry rmsnorm_pallas), which the reference's ``layers.rmsnorm`` computes
twice per encoder layer and once per exit head.

What bounds it on the H100: one read of x and one write of y, 2 bytes per
element each in bf16, against ~4 operations per element: memory bytes at
3.35 TB/s.

Design: one program per block of rows, the row held whole in a masked
``BLOCK_D = next_pow2(D)`` vector (D = 1280 and 1024 on the serving path),
fp32 mean of squares and scale, one cast back. Triton's masked row
reduction moves the same bytes a CUDA kernel would, with no build step.
``triton`` is imported only when a kernel is first launched.
"""
from __future__ import annotations

import functools

import torch

triton = None  # bound at first launch (no triton where there is no card)
tl = None


def _rmsnorm_kernel(X, S, O, n_rows, D, eps,
                    BLOCK_R: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    rows = tl.program_id(0) * BLOCK_R + tl.arange(0, BLOCK_R)
    cols = tl.arange(0, BLOCK_D)
    mask = (rows[:, None] < n_rows) & (cols[None, :] < D)
    offs = rows[:, None].to(tl.int64) * D + cols[None, :]
    x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
    var = tl.sum(x * x, axis=1) / D
    r = 1.0 / tl.sqrt(var + eps)
    s = tl.load(S + cols, mask=cols < D, other=0.0).to(tl.float32)
    y = x * r[:, None] * s[None, :]
    tl.store(O + offs, y.to(O.dtype.element_ty), mask=mask)


@functools.lru_cache(maxsize=None)
def _compiled():
    global triton, tl
    import triton
    import triton.language as tl
    return triton.jit(_rmsnorm_kernel)


def rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError("rmsnorm_triton: x and scale must be on one CUDA "
                         "device")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"rmsnorm_triton: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    kern = _compiled()
    x2 = x.reshape(-1, D).contiguous()
    out = torch.empty_like(x2)
    n_rows = x2.shape[0]
    if n_rows == 0:
        return out.reshape(x.shape)
    block_d = triton.next_power_of_2(D)
    block_r = max(1, min(16, 8192 // block_d))
    grid = (triton.cdiv(n_rows, block_r),)
    with torch.cuda.device(x.device):
        kern[grid](x2, scale.contiguous(), out, n_rows, D, float(eps),
                   BLOCK_R=block_r, BLOCK_D=block_d, num_warps=4)
    return out.reshape(x.shape)
