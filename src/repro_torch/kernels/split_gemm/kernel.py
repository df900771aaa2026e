"""ctypes binding of the split GEMMs (``csrc/split_gemm.cu``): fp32
activations times bf16 weights on the tensor cores, each activation split
exactly into three bf16 terms. Checks device, types, shapes, contiguity
and alignment, allocates the fp32 output and launches on PyTorch's current
stream.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int


def takes(K: int, N: int) -> bool:
    """Widths the kernels take: fp32 rows of K and bf16 rows of N a whole
    number of 16 bytes (TMA's strides), K and N at least 8."""
    return K >= 8 and N >= 8 and K % 8 == 0 and N % 8 == 0


def _lib() -> ctypes.CDLL:
    lib = build.load("split_gemm")
    lib.split_gemm_gate_up_launch.restype = ctypes.c_int
    lib.split_gemm_gate_up_launch.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    lib.split_gemm_matmul_launch.restype = ctypes.c_int
    lib.split_gemm_matmul_launch.argtypes = [_P] * 3 + [_I] * 3 + [_P]
    return lib


def _check(x: torch.Tensor, *ws: torch.Tensor) -> None:
    dev = x.device
    if dev.type != "cuda" or any(w.device != dev for w in ws):
        raise ValueError("split_gemm: x and the weights must be on one CUDA "
                         "device")
    if x.dtype != torch.float32 or any(w.dtype != torch.bfloat16 for w in ws):
        raise TypeError(f"split_gemm takes float32 x and bfloat16 weights, "
                        f"got {x.dtype}, {[w.dtype for w in ws]}")
    if x.dim() != 2 or any(w.dim() != 2 or w.shape != ws[0].shape
                           or w.shape[0] != x.shape[1] for w in ws):
        raise ValueError(f"shapes x {tuple(x.shape)}, weights "
                         f"{[tuple(w.shape) for w in ws]}")
    if not takes(*ws[0].shape):
        raise ValueError(f"split_gemm: K, N {tuple(ws[0].shape)} must be "
                         f"multiples of 8, at least 8")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (x, *ws)):
        raise ValueError("split_gemm wants contiguous, 16-byte aligned "
                         "inputs")


def _run(fn, what: str, x: torch.Tensor, *ws: torch.Tensor) -> torch.Tensor:
    _check(x, *ws)
    (M, K), N = x.shape, ws[0].shape[1]
    out = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), *(w.data_ptr() for w in ws), out.data_ptr(),
                 M, K, N, stream)
    build.check(err, f"split_gemm {what}")
    return out


def swiglu_gate_up_cuda(x: torch.Tensor, w_gate: torch.Tensor,
                        w_up: torch.Tensor) -> torch.Tensor:
    """h (M, N) fp32 = SiLU(x @ w_gate) * (x @ w_up) in one launch."""
    return _run(_lib().split_gemm_gate_up_launch, "gate_up", x, w_gate, w_up)


def matmul_cuda(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """y (M, N) fp32 = x (M, K) fp32 @ w (K, N) bf16."""
    return _run(_lib().split_gemm_matmul_launch, "down", x, w)
