"""ctypes binding of the CUDA grouped expert GEMM (``csrc/moe_gemm.cu``).

Takes the plan's sorted, block-padded layout as it is (xs (T_pad, d),
block_expert (T_pad // bt,) int32, used () int32 on the device,
w (E, d, F)), allocates the output and launches on PyTorch's current stream.
The used row count stays on the device: blocks past it exit there.

Two kernels compute the function; ``kernel_for`` picks one from the
dtype, the token block and the widths alone: ``"wgmma"`` (TMA ring and
wgmma, the prefill's bf16 blocks of 64 or 128 rows; TMA needs d and F
multiples of 8) or ``"mma_sync"`` (the decode regime's 16-row blocks, f32,
and any other shape). The gradients of xs (``moe_gemm_cuda(..., dx=True)``)
and of w (``moe_gemm_dw_cuda``) have two kernels each, picked by the same
rule: ``"wgmma"`` (a persistent TMA and wgmma kernel with a TMA-store
epilogue, one for dX and one for dW) or ``"mma_sync"`` (dX on the forward's
``mma.sync`` kernel with w read transposed, dW on a kernel of its own).
``moe_gemm_swiglu_cuda`` runs the MoE layer's gate and up with SiLU·up in
one launch (``moe_gemm_wgmma_swiglu``), on the shapes ``kernel_for`` gives
the wgmma kernel.

The row kernels (``csrc/moe_rows.cu``, their own library) move rows
between token order and the sorted layout through the plan's ``slot_of``:
``moe_dispatch_rows_cuda`` writes each token's row to its ``top_k`` slots
and zeroes the groups' padding rows, ``moe_combine_rows_cuda`` sums each
token's ``top_k`` sorted rows by their weights.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build

DTYPES = (torch.float32, torch.bfloat16)

KERNELS = ("wgmma", "mma_sync")

_P = ctypes.c_void_p
_I = ctypes.c_int


def kernel_for(dtype: torch.dtype, block_t: int, d: int, F: int) -> str:
    """The kernel that runs a call: ``"wgmma"`` for bf16 with 64- or
    128-row token blocks and d, F multiples of 8, else ``"mma_sync"``."""
    if dtype == torch.bfloat16 and block_t in (64, 128) and d % 8 == 0 \
            and F % 8 == 0:
        return "wgmma"
    return "mma_sync"


def _lib() -> ctypes.CDLL:
    lib = build.load("moe_gemm")
    lib.moe_gemm_launch.restype = ctypes.c_int
    lib.moe_gemm_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.moe_gemm_wgmma_launch.restype = ctypes.c_int
    lib.moe_gemm_wgmma_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.moe_gemm_dx_launch.restype = ctypes.c_int
    lib.moe_gemm_dx_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.moe_gemm_dx_wgmma_launch.restype = ctypes.c_int
    lib.moe_gemm_dx_wgmma_launch.argtypes = [_P] * 5 + [_I] * 5 + [_P]
    lib.moe_gemm_dw_launch.restype = ctypes.c_int
    lib.moe_gemm_dw_launch.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.moe_gemm_dw_wgmma_launch.restype = ctypes.c_int
    lib.moe_gemm_dw_wgmma_launch.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.moe_gemm_swiglu_wgmma_launch.restype = ctypes.c_int
    lib.moe_gemm_swiglu_wgmma_launch.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    return lib


def _rows_lib() -> ctypes.CDLL:
    lib = build.load("moe_rows")
    lib.moe_dispatch_rows_launch.restype = ctypes.c_int
    lib.moe_dispatch_rows_launch.argtypes = [_P] * 5 + [_I] * 4 + [_P]
    lib.moe_combine_rows_launch.restype = ctypes.c_int
    lib.moe_combine_rows_launch.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    return lib


def _check_device(*tensors) -> torch.device:
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("moe_gemm_cuda: every tensor must be on one CUDA "
                         "device")
    return dev


def _check_kernel(kernel: Optional[str], dtype: torch.dtype, block_t: int,
                  d: int, F: int) -> str:
    """``kernel``, or ``kernel_for``'s choice where it is None; raises for
    a name not in ``KERNELS`` and for ``"wgmma"`` where ``kernel_for``
    does not give it."""
    chosen = kernel_for(dtype, block_t, d, F)
    kernel = kernel or chosen
    if kernel not in KERNELS or (kernel == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"kernel {kernel!r} does not take {dtype}, "
                         f"block_t {block_t}, d {d}, F {F}")
    return kernel


def _check_used(used: torch.Tensor, *index: torch.Tensor) -> None:
    if any(t.dtype != torch.int32 for t in (used, *index)) or \
            used.numel() != 1:
        raise TypeError(f"the plan's index tensors and used must be int32 "
                        f"(used one value), got "
                        f"{[t.dtype for t in (used, *index)]}, used "
                        f"{tuple(used.shape)}")


def _check_sorted(xs: torch.Tensor, block_expert: torch.Tensor,
                  block_t: int, used: torch.Tensor, *ws: torch.Tensor,
                  k_dim: int = 1) -> None:
    """The checks every sorted-layout wrapper makes: dtypes, xs's width
    against each w's dim ``k_dim``, the token block, contiguous and 16-byte
    aligned inputs."""
    if xs.dtype not in DTYPES or any(w.dtype != xs.dtype for w in ws):
        raise TypeError(f"moe_gemm_cuda takes f32 or bf16 (x and w alike), "
                        f"got {xs.dtype}, {[w.dtype for w in ws]}")
    if xs.dim() != 2 or any(w.dim() != 3 or w.shape[k_dim] != xs.shape[1]
                            or w.shape != ws[0].shape for w in ws):
        raise ValueError(f"shapes xs {tuple(xs.shape)}, w "
                         f"{[tuple(w.shape) for w in ws]}"
                         + (" (dx)" if k_dim == 2 else ""))
    T_pad = xs.shape[0]
    if block_t < 16 or block_t % 16 or T_pad % block_t or \
            tuple(block_expert.shape) != (T_pad // block_t,):
        raise ValueError(f"block_t {block_t} (a multiple of 16 dividing "
                         f"T_pad {T_pad}), block_expert "
                         f"{tuple(block_expert.shape)}")
    _check_used(used, block_expert)
    if not (xs.is_contiguous() and all(w.is_contiguous() for w in ws) and
            block_expert.is_contiguous()):
        raise ValueError("moe_gemm_cuda wants contiguous inputs")
    if xs.data_ptr() % 16 or any(w.data_ptr() % 16 for w in ws):
        raise ValueError("moe_gemm_cuda wants 16-byte aligned xs and w")


def moe_gemm_cuda(xs: torch.Tensor, block_expert: torch.Tensor,
                  w: torch.Tensor, block_t: int, used: torch.Tensor, *,
                  kernel: Optional[str] = None,
                  dx: bool = False) -> torch.Tensor:
    """(T_pad, F) in xs's dtype; rows from ``used`` on are left
    unwritten. ``kernel`` (default ``kernel_for``'s choice) names the
    kernel; ``"mma_sync"`` takes every shape, ``"wgmma"`` only those
    ``kernel_for`` gives it. With ``dx`` the gradient of xs instead: xs is
    dys (T_pad, F) and the result (T_pad, d) = dys @ w[e]^T, 0 from
    ``used`` on, where dys is not read; ``"wgmma"`` then names the
    persistent dX kernel (``moe_gemm_dx_wgmma``), ``"mma_sync"`` the
    forward's ``mma.sync`` kernel with w read transposed."""
    dev = _check_device(xs, block_expert, w, used)
    _check_sorted(xs, block_expert, block_t, used, w, k_dim=2 if dx else 1)
    T_pad = xs.shape[0]
    E, d, F = w.shape
    kernel = _check_kernel(kernel, xs.dtype, block_t, d, F)
    ys = torch.empty((T_pad, d if dx else F), dtype=xs.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (xs.data_ptr(), block_expert.data_ptr(), w.data_ptr(),
                used.data_ptr(), ys.data_ptr(), T_pad, d, F)
        if kernel == "wgmma":
            fn = lib.moe_gemm_dx_wgmma_launch if dx else \
                lib.moe_gemm_wgmma_launch
            err = fn(*args, E, int(block_t), stream)
        else:
            fn = lib.moe_gemm_dx_launch if dx else lib.moe_gemm_launch
            err = fn(*args, int(block_t), int(xs.dtype == torch.bfloat16),
                     stream)
    build.check(err, f"moe_gemm{' dx' if dx else ''} ({kernel})")
    return ys


def moe_gemm_swiglu_cuda(xs: torch.Tensor, block_expert: torch.Tensor,
                         w_gate: torch.Tensor, w_up: torch.Tensor,
                         block_t: int, used: torch.Tensor) -> torch.Tensor:
    """h (T_pad, F) bf16 = SiLU(xs @ w_gate[e]) * (xs @ w_up[e]) in one
    launch of ``moe_gemm_wgmma_swiglu``, with the roundings of the three
    steps it replaces (g and u in bf16, SiLU in fp32 cast back, the product
    rounded once); rows from ``used`` on are left unwritten. Only the
    shapes ``kernel_for`` gives the wgmma kernel: it raises for others."""
    dev = _check_device(xs, block_expert, w_gate, w_up, used)
    _check_sorted(xs, block_expert, block_t, used, w_gate, w_up)
    T_pad = xs.shape[0]
    E, d, F = w_gate.shape
    if kernel_for(xs.dtype, block_t, d, F) != "wgmma":
        raise ValueError(f"moe_gemm_swiglu_cuda does not take {xs.dtype}, "
                         f"block_t {block_t}, d {d}, F {F}")
    h = torch.empty((T_pad, F), dtype=xs.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.moe_gemm_swiglu_wgmma_launch(
            xs.data_ptr(), block_expert.data_ptr(), w_gate.data_ptr(),
            w_up.data_ptr(), used.data_ptr(), h.data_ptr(), T_pad, d, F, E,
            int(block_t), stream)
    build.check(err, "moe_gemm swiglu (wgmma)")
    return h


def moe_gemm_dw_cuda(xs: torch.Tensor, dys: torch.Tensor,
                     ends: torch.Tensor, block_t: int, used: torch.Tensor, *,
                     kernel: Optional[str] = None) -> torch.Tensor:
    """(E, d, F) in xs's dtype: expert e's xs^T @ dys over its group's rows
    [ends[e - 1], ends[e]) (from 0 for e = 0), cut at ``used``; 0 for an
    expert with no rows. No row from ``used`` on is read. ``ends`` and
    ``used`` are the plan's for token blocks of ``block_t`` rows (each a
    multiple of it). ``kernel`` (default ``kernel_for``'s choice) names the
    kernel; ``"mma_sync"`` takes every shape, ``"wgmma"`` only those
    ``kernel_for`` gives it."""
    if xs.dtype not in DTYPES or dys.dtype != xs.dtype:
        raise TypeError(f"moe_gemm_dw_cuda takes f32 or bf16 (xs and dys "
                        f"alike), got {xs.dtype}, {dys.dtype}")
    if xs.dim() != 2 or dys.dim() != 2 or dys.shape[0] != xs.shape[0] or \
            ends.dim() != 1:
        raise ValueError(f"shapes xs {tuple(xs.shape)}, dys "
                         f"{tuple(dys.shape)}, ends {tuple(ends.shape)}")
    T_pad, d, F, E = xs.shape[0], xs.shape[1], dys.shape[1], ends.shape[0]
    if block_t < 16 or block_t % 16 or T_pad % block_t:
        raise ValueError(f"block_t {block_t} (a multiple of 16 dividing "
                         f"T_pad {T_pad})")
    kernel = _check_kernel(kernel, xs.dtype, block_t, d, F)
    dev = _check_device(xs, dys, ends, used)
    _check_used(used, ends)
    if not (xs.is_contiguous() and dys.is_contiguous() and
            ends.is_contiguous()):
        raise ValueError("moe_gemm_dw_cuda wants contiguous inputs")
    if xs.data_ptr() % 16 or dys.data_ptr() % 16:
        raise ValueError("moe_gemm_dw_cuda wants 16-byte aligned xs and dys")
    dw = torch.empty((E, d, F), dtype=xs.dtype, device=dev)
    lib = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        args = (xs.data_ptr(), dys.data_ptr(), ends.data_ptr(),
                used.data_ptr(), dw.data_ptr())
        if kernel == "wgmma":
            err = lib.moe_gemm_dw_wgmma_launch(*args, T_pad, d, F, E, stream)
        else:
            err = lib.moe_gemm_dw_launch(*args, d, F, E,
                                         int(xs.dtype == torch.bfloat16),
                                         stream)
    build.check(err, f"moe_gemm dw ({kernel})")
    return dw


def _check_slots(slot_of: torch.Tensor, T: int, top_k: int,
                 *index: torch.Tensor) -> None:
    """slot_of (T * top_k,) and the plan's other index tensors: contiguous
    int32."""
    tensors = (slot_of, *index)
    if any(t.dtype != torch.int32 or not t.is_contiguous()
           for t in tensors) or tuple(slot_of.shape) != (T * top_k,):
        raise ValueError(f"slot_of must be ({T} * {top_k},) and the plan's "
                         f"index tensors contiguous int32, got "
                         f"{[(tuple(t.shape), t.dtype) for t in tensors]}")


def moe_dispatch_rows_cuda(x: torch.Tensor, slot_of: torch.Tensor,
                           counts: torch.Tensor, ends: torch.Tensor,
                           T_pad: int, top_k: int) -> torch.Tensor:
    """The sorted buffer (T_pad, d) in one launch of ``moe_dispatch_rows``:
    token t's row of x (T, d) at rows ``slot_of[t * top_k + k]``, each
    expert group's padding rows (from its start plus ``counts[e]`` to
    ``ends[e]``) zeroed, rows from ``ends[-1]`` (the plan's ``used``) on
    left unwritten."""
    dev = _check_device(x, slot_of, counts, ends)
    if x.dtype not in DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"moe_dispatch_rows_cuda takes contiguous (T, d) "
                         f"f32 or bf16 rows, got {x.dtype} "
                         f"{tuple(x.shape)}")
    T, d = x.shape
    _check_slots(slot_of, T, top_k, counts, ends)
    if counts.shape != ends.shape or counts.dim() != 1:
        raise ValueError(f"counts {tuple(counts.shape)} and ends "
                         f"{tuple(ends.shape)} must be (E,)")
    xs = torch.empty((T_pad, d), dtype=x.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _rows_lib().moe_dispatch_rows_launch(
            x.data_ptr(), slot_of.data_ptr(), counts.data_ptr(),
            ends.data_ptr(), xs.data_ptr(), T, int(top_k), counts.shape[0],
            d * x.element_size(), torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "moe_dispatch_rows")
    return xs


def moe_combine_rows_cuda(ys: torch.Tensor, slot_of: torch.Tensor,
                          w: torch.Tensor) -> torch.Tensor:
    """y (T, d) in ys's dtype in one launch of ``moe_combine_rows``: token
    t's ``K`` rows ``ys[slot_of[t * K + k]]`` times w[t, k] (w (T, K) fp32,
    each rounded to ys's dtype), summed in fp32 in the order k = 0 .. K - 1
    and rounded once. No row of ys that ``slot_of`` does not name is
    read."""
    dev = _check_device(ys, slot_of, w)
    if ys.dtype not in DTYPES or ys.dim() != 2 or not ys.is_contiguous():
        raise ValueError(f"moe_combine_rows_cuda takes contiguous (T_pad, "
                         f"d) f32 or bf16 rows, got {ys.dtype} "
                         f"{tuple(ys.shape)}")
    if w.dtype != torch.float32 or w.dim() != 2 or not w.is_contiguous():
        raise ValueError(f"w must be contiguous (T, K) float32, got "
                         f"{w.dtype} {tuple(w.shape)}")
    T, K = w.shape
    _check_slots(slot_of, T, K)
    y = torch.empty((T, ys.shape[1]), dtype=ys.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _rows_lib().moe_combine_rows_launch(
            ys.data_ptr(), slot_of.data_ptr(), w.data_ptr(), y.data_ptr(), T,
            K, ys.shape[1], int(ys.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "moe_combine_rows")
    return y
