"""Triton RMSNorm for Hopper, forward and backward.

The forward replaces the TPU kernel
repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel (entry rmsnorm_pallas),
which the reference's ``layers.rmsnorm`` computes twice per encoder layer
and once per exit head. The backward has no TPU kernel: the reference
differentiates ``layers.rmsnorm`` (repro/models/layers.py) with autodiff,
and the port's training path (P-LoRA healing) needs its gradient through
the forward kernel.

What bounds it on the H100: one read of x and one write of y, 2 bytes per
element each in bf16, against ~4 operations per element: memory bytes at
3.35 TB/s.

Design: one program per block of rows, the row held whole in a masked
``BLOCK_D = next_pow2(D)`` vector (D = 1280 and 1024 on the serving path),
fp32 mean of squares and scale, one cast back. Triton's masked row
reduction moves the same bytes a CUDA kernel would, with no build step.
``triton`` is imported only when a kernel is first launched.

Backward (``rmsnorm_bwd_triton``): dx = r (g s - x^ mean(g s x^)) with
x^ = x r, r = rsqrt(mean(x^2) + eps), g = dy, in fp32 with IEEE square
root and quotients, cast to x's dtype; dscale = sum over rows of g x^. It
reads x and dy and writes dx: three row-sized streams, memory bytes
again. One program per run of rows (about
four programs an SM), the row held whole as in the forward, blocks of a few
rows; each program keeps its own fp32 partial of dscale and writes it once,
and the (programs, D) partials are reduced with one ``sum``: no atomics,
the same bits on every run.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

PROGRAMS_PER_SM = 4  # backward programs an SM (each writes one dscale partial)

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


def _rmsnorm_bwd_kernel(X, S, DY, DX, DS, n_rows, D, eps, rows_per_prog,
                        BLOCK_R: "tl.constexpr", BLOCK_D: "tl.constexpr"):
    pid = tl.program_id(0)
    cols = tl.arange(0, BLOCK_D)
    cmask = cols < D
    ones = tl.full((BLOCK_R,), 1.0, tl.float32)
    Dv = ones * D
    s = tl.load(S + cols, mask=cmask, other=0.0).to(tl.float32)
    acc = tl.zeros((BLOCK_D,), dtype=tl.float32)
    row0 = pid * rows_per_prog
    for i in range(0, rows_per_prog, BLOCK_R):
        rows = row0 + i + tl.arange(0, BLOCK_R)
        mask = (rows[:, None] < n_rows) & cmask[None, :]
        offs = rows[:, None].to(tl.int64) * D + cols[None, :]
        x = tl.load(X + offs, mask=mask, other=0.0).to(tl.float32)
        g = tl.load(DY + offs, mask=mask, other=0.0).to(tl.float32)
        # IEEE square root and quotients, as the plain version's
        r = tl.div_rn(ones, tl.sqrt_rn(tl.div_rn(tl.sum(x * x, axis=1), Dv)
                                       + eps))
        xh = x * r[:, None]
        gs = g * s[None, :]
        c = tl.div_rn(tl.sum(gs * xh, axis=1), Dv)
        dx = r[:, None] * (gs - xh * c[:, None])
        tl.store(DX + offs, dx.to(DX.dtype.element_ty), mask=mask)
        acc += tl.sum(g * xh, axis=0)
    tl.store(DS + pid.to(tl.int64) * D + cols, acc, mask=cmask)


@functools.lru_cache(maxsize=None)
def _compiled():
    global triton, tl
    import triton
    import triton.language as tl
    return triton.jit(_rmsnorm_kernel)


@functools.lru_cache(maxsize=None)
def _compiled_bwd():
    _compiled()  # binds triton and tl
    return triton.jit(_rmsnorm_bwd_kernel)


def _check(x: torch.Tensor, scale: torch.Tensor, what: str) -> int:
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(f"{what}: x and scale must be on one CUDA device")
    if x.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")
    D = x.shape[-1]
    if tuple(scale.shape) != (D,):
        raise ValueError(f"scale shape {tuple(scale.shape)} != ({D},)")
    return D


def rmsnorm_triton(x: torch.Tensor, scale: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    D = _check(x, scale, "rmsnorm_triton")
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


def rmsnorm_bwd_triton(x: torch.Tensor, scale: torch.Tensor,
                       dy: torch.Tensor, eps: float = 1e-6
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx in x's dtype, dscale in scale's dtype) for the cotangent ``dy``
    of ``rmsnorm_triton(x, scale, eps)``."""
    D = _check(x, scale, "rmsnorm_bwd_triton")
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} for x "
                         f"{tuple(x.shape)} {x.dtype}")
    kern = _compiled_bwd()
    x2 = x.reshape(-1, D).contiguous()
    g2 = dy.reshape(-1, D).contiguous()
    dx = torch.empty_like(x2)
    n_rows = x2.shape[0]
    if n_rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(scale)
    block_d = triton.next_power_of_2(D)
    block_r = max(1, min(8, 4096 // block_d))
    n_prog = min(triton.cdiv(n_rows, block_r),
                 PROGRAMS_PER_SM * build.sm_count(x.device))
    rows_per_prog = triton.cdiv(triton.cdiv(n_rows, n_prog), block_r) * block_r
    n_prog = triton.cdiv(n_rows, rows_per_prog)
    partial = torch.empty((n_prog, D), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        kern[(n_prog,)](x2, scale.contiguous(), g2, dx, partial, n_rows, D,
                        float(eps), rows_per_prog, BLOCK_R=block_r,
                        BLOCK_D=block_d, num_warps=8 if block_d >= 2048
                        else 4)
    return dx.reshape(x.shape), partial.sum(0).to(scale.dtype)
