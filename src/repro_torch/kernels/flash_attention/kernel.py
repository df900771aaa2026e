"""ctypes binding of the CUDA flash-attention forward (``csrc/flash_fwd.cu``).

Takes the wrapper's layout as it is (q (B, Sq, H, D), k/v (B, Skv, KV, D),
contiguous) and returns (out (B, Sq, H, D) in the input dtype, lse
(B, H, Sq) f32).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIMS = (64, 80, 128)
DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_fwd")
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_fwd_launch.argtypes = ([_P] * 5 + [_I] * 7 + [ctypes.c_float]
                                     + [_I] * 3 + [_P])
    return lib


def flash_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool, window: int = 0, q_offset: int = 0,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_fwd_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_fwd_cuda takes f32 or bf16 (all alike), got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV or Skv == 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} / kv "
                         f"{tuple(k.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda wants contiguous q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if B * Sq == 0:
        return out, lse
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, H, KV, D,
            int(q.dtype == torch.bfloat16), float(scale), int(bool(causal)),
            int(window), int(q_offset), stream)
    build.check(err, "flash_fwd")
    return out, lse
