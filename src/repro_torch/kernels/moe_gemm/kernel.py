"""ctypes binding of the CUDA grouped expert GEMM (``csrc/moe_gemm.cu``).

Takes the plan's sorted, block-padded layout as it is (xs (T_pad, d),
block_expert (T_pad // bt,) int32, used () int32 on the device,
w (E, d, F)), allocates the output and launches on PyTorch's current stream.
The used row count stays on the device: blocks past it exit there.

Two kernels compute the function; ``kernel_for`` picks one from the
dtype, the token block and the widths alone: ``"wgmma"`` (TMA ring and
wgmma, the prefill's bf16 blocks of 64 or 128 rows; TMA needs d and F
multiples of 8) or ``"mma_sync"`` (the decode regime's 16-row blocks, f32,
and any other shape).
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
    return lib


def moe_gemm_cuda(xs: torch.Tensor, block_expert: torch.Tensor,
                  w: torch.Tensor, block_t: int, used: torch.Tensor, *,
                  kernel: Optional[str] = None) -> torch.Tensor:
    """(T_pad, F) in xs's dtype; rows from ``used`` on are left
    unwritten. ``kernel`` (default ``kernel_for``'s choice) names the
    kernel; ``"mma_sync"`` takes every shape, ``"wgmma"`` only those
    ``kernel_for`` gives it."""
    dev = xs.device
    if dev.type != "cuda" or any(t.device != dev
                                 for t in (block_expert, w, used)):
        raise ValueError("moe_gemm_cuda: xs, block_expert, w, used must be "
                         "on one CUDA device")
    if xs.dtype not in DTYPES or w.dtype != xs.dtype:
        raise TypeError(f"moe_gemm_cuda takes f32 or bf16 (x and w alike), "
                        f"got {xs.dtype}, {w.dtype}")
    if xs.dim() != 2 or w.dim() != 3 or w.shape[1] != xs.shape[1]:
        raise ValueError(f"shapes xs {tuple(xs.shape)}, w {tuple(w.shape)}")
    T_pad, d = xs.shape
    F = w.shape[2]
    if block_t < 16 or block_t % 16 or T_pad % block_t or \
            tuple(block_expert.shape) != (T_pad // block_t,):
        raise ValueError(f"block_t {block_t} (a multiple of 16 dividing "
                         f"T_pad {T_pad}), block_expert "
                         f"{tuple(block_expert.shape)}")
    if block_expert.dtype != torch.int32 or used.dtype != torch.int32 or \
            used.numel() != 1:
        raise TypeError(f"block_expert and used must be int32 (used one "
                        f"value), got {block_expert.dtype}, {used.dtype} "
                        f"{tuple(used.shape)}")
    if not (xs.is_contiguous() and w.is_contiguous() and
            block_expert.is_contiguous()):
        raise ValueError("moe_gemm_cuda wants contiguous inputs")
    if xs.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("moe_gemm_cuda wants 16-byte aligned xs and w")
    chosen = kernel_for(xs.dtype, block_t, d, F)
    kernel = kernel or chosen
    if kernel not in KERNELS or (kernel == "wgmma" and chosen != "wgmma"):
        raise ValueError(f"kernel {kernel!r} does not take {xs.dtype}, "
                         f"block_t {block_t}, d {d}, F {F}")
    ys = torch.empty((T_pad, F), dtype=xs.dtype, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel == "wgmma":
            err = _lib().moe_gemm_wgmma_launch(
                xs.data_ptr(), block_expert.data_ptr(), w.data_ptr(),
                used.data_ptr(), ys.data_ptr(), T_pad, d, F, w.shape[0],
                int(block_t), stream)
        else:
            err = _lib().moe_gemm_launch(
                xs.data_ptr(), block_expert.data_ptr(), w.data_ptr(),
                used.data_ptr(), ys.data_ptr(), T_pad, d, F, int(block_t),
                int(xs.dtype == torch.bfloat16), stream)
    build.check(err, f"moe_gemm ({kernel})")
    return ys
