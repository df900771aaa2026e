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
again. Two launches of this file's kernels, planned by ``bwd_plan``:
  * ``_rmsnorm_bwd_kernel``: one program per run of rows, blocks of a few
    rows, each row held whole in registers and read once, as two
    power-of-two pieces that tile it (1280 = 1024 + 256, 1536 = 1024 +
    512, 80 = 64 + 16; a power of two in halves), so no lane is masked at
    the widths the configs ship; each program keeps its own fp32 partial
    of dscale and writes it once.
  * ``_dscale_kernel``: sums the (programs, D) partials in a fixed order in
    fp32 and stores them in scale's dtype.
No atomics: the same bits on every run.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from repro_torch.kernels import build

# the backward's grid (each program writes one dscale partial): programs an
# SM, rows a block and warps a program, chosen by graph replay on the H100
# at (8,224, 1,280) f32 and (4,096, 1,536) bf16
PROGRAMS_PER_SM, BWD_BLOCK_R, BWD_WARPS = 4, 2, 2
# the dscale reduction's tile: partial rows a step x columns a program
DS_BLOCK_P, DS_BLOCK_C = 256, 8

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


def _rmsnorm_bwd_kernel(X, S, DY, DX, DS, n_rows, eps, rows_per_prog,
                        D: "tl.constexpr", WA: "tl.constexpr",
                        WB: "tl.constexpr", BLOCK_R: "tl.constexpr"):
    # a row is columns [0, WA) and [WA, WA + WB), masked past D
    pid = tl.program_id(0)
    ca = tl.arange(0, WA)
    cb = WA + tl.arange(0, WB)
    ma = ca < D
    mb = cb < D
    ones = tl.full((BLOCK_R,), 1.0, tl.float32)
    Dv = ones * D
    sa = tl.load(S + ca, mask=ma, other=0.0).to(tl.float32)
    sb = tl.load(S + cb, mask=mb, other=0.0).to(tl.float32)
    acc_a = tl.zeros((WA,), dtype=tl.float32)
    acc_b = tl.zeros((WB,), dtype=tl.float32)
    row0 = pid * rows_per_prog
    for i in range(0, rows_per_prog, BLOCK_R):
        rows = row0 + i + tl.arange(0, BLOCK_R)
        live = rows[:, None] < n_rows
        base = rows[:, None].to(tl.int64) * D
        xa = tl.load(X + base + ca[None, :], mask=live & ma[None, :],
                     other=0.0).to(tl.float32)
        xb = tl.load(X + base + cb[None, :], mask=live & mb[None, :],
                     other=0.0).to(tl.float32)
        ga = tl.load(DY + base + ca[None, :], mask=live & ma[None, :],
                     other=0.0).to(tl.float32)
        gb = tl.load(DY + base + cb[None, :], mask=live & mb[None, :],
                     other=0.0).to(tl.float32)
        # IEEE square root and quotients, as the plain version's
        ss = tl.sum(xa * xa, axis=1) + tl.sum(xb * xb, axis=1)
        r = tl.div_rn(ones, tl.sqrt_rn(tl.div_rn(ss, Dv) + eps))
        xha = xa * r[:, None]
        xhb = xb * r[:, None]
        gsa = ga * sa[None, :]
        gsb = gb * sb[None, :]
        c = tl.div_rn(tl.sum(gsa * xha, axis=1) + tl.sum(gsb * xhb, axis=1),
                      Dv)
        dxa = r[:, None] * (gsa - xha * c[:, None])
        dxb = r[:, None] * (gsb - xhb * c[:, None])
        tl.store(DX + base + ca[None, :], dxa.to(DX.dtype.element_ty),
                 mask=live & ma[None, :])
        tl.store(DX + base + cb[None, :], dxb.to(DX.dtype.element_ty),
                 mask=live & mb[None, :])
        acc_a += tl.sum(ga * xha, axis=0)
        acc_b += tl.sum(gb * xhb, axis=0)
    out = DS + pid.to(tl.int64) * D
    tl.store(out + ca, acc_a, mask=ma)
    tl.store(out + cb, acc_b, mask=mb)


def _dscale_kernel(P, OUT, n_part, D, BLOCK_P: "tl.constexpr",
                   BLOCK_C: "tl.constexpr"):
    # columns [pid BLOCK_C, + BLOCK_C) of the (n_part, D) partials: a
    # (BLOCK_P, BLOCK_C) fp32 sum over steps of BLOCK_P partial rows, then
    # over its rows; the same order on every run
    cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
    cm = cols < D
    acc = tl.zeros((BLOCK_P, BLOCK_C), dtype=tl.float32)
    for p0 in range(0, n_part, BLOCK_P):
        prow = p0 + tl.arange(0, BLOCK_P)
        acc += tl.load(P + prow[:, None].to(tl.int64) * D + cols[None, :],
                       mask=(prow[:, None] < n_part) & cm[None, :],
                       other=0.0)
    tl.store(OUT + cols, tl.sum(acc, axis=0).to(OUT.dtype.element_ty),
             mask=cm)


class BwdPlan(NamedTuple):
    programs: int          # programs of the first kernel = dscale partials
    rows_per_program: int  # a multiple of block_r
    block_r: int           # rows a program holds at once
    num_warps: int         # warps a program
    pieces: Tuple[Tuple[int, int], Tuple[int, int]]  # (start, width) of a row's two pieces


def row_pieces(D: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """A row of D columns as two power-of-two pieces (start, width): the
    largest power of two below D, then the next power of two at or above
    what is left (a power of two D in halves). They tile D exactly when D
    is a sum of two powers of two (every width the configs ship); past D
    the second piece is masked."""
    wa = 1 << max(0, (D - 1).bit_length() - 1)
    rest = D - wa
    wb = 1 << max(0, (rest - 1).bit_length()) if rest > 0 else 1
    return (0, wa), (wa, wb)


def bwd_plan(n_rows: int, D: int, sms: int) -> BwdPlan:
    """The backward's grid: at most ``PROGRAMS_PER_SM`` programs an SM,
    each over a run of whole blocks of ``BWD_BLOCK_R`` rows."""
    block_r = BWD_BLOCK_R
    n_prog = max(1, min(-(-n_rows // block_r), PROGRAMS_PER_SM * sms))
    rows_per_prog = -(-(-(-n_rows // n_prog)) // block_r) * block_r
    return BwdPlan(-(-n_rows // rows_per_prog), rows_per_prog, block_r,
                   BWD_WARPS, row_pieces(D))


@functools.lru_cache(maxsize=None)
def _compiled():
    global triton, tl
    import triton
    import triton.language as tl
    return triton.jit(_rmsnorm_kernel)


@functools.lru_cache(maxsize=None)
def _compiled_bwd():
    _compiled()  # binds triton and tl
    return triton.jit(_rmsnorm_bwd_kernel), triton.jit(_dscale_kernel)


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
    kern, reduce_kern = _compiled_bwd()
    x2 = x.reshape(-1, D).contiguous()
    g2 = dy.reshape(-1, D).contiguous()
    dx = torch.empty_like(x2)
    n_rows = x2.shape[0]
    if n_rows == 0:
        return dx.reshape(x.shape), torch.zeros_like(scale)
    plan = bwd_plan(n_rows, D, build.sm_count(x.device))
    (_, wa), (_, wb) = plan.pieces
    partial = torch.empty((plan.programs, D), dtype=torch.float32,
                          device=x.device)
    ds = torch.empty_like(scale)
    with torch.cuda.device(x.device):
        kern[(plan.programs,)](x2, scale.contiguous(), g2, dx, partial,
                               n_rows, float(eps), plan.rows_per_program,
                               D=D, WA=wa, WB=wb, BLOCK_R=plan.block_r,
                               num_warps=plan.num_warps)
        reduce_kern[(triton.cdiv(D, DS_BLOCK_C),)](
            partial, ds, plan.programs, D, BLOCK_P=DS_BLOCK_P,
            BLOCK_C=DS_BLOCK_C, num_warps=4)
    return dx.reshape(x.shape), ds
