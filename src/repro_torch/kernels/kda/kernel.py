"""ctypes binding of the KDA chunked-forward kernel (``csrc/kda_fwd.cu``).

Takes the layer's layout as it is: q, k, v (B, S, H, 128) bf16, g (B, S,
H, 128) fp32, beta (B, S, H) fp32 and an optional fp32 initial state (B,
H, 128, 128), all contiguous on one CUDA device; allocates o (bf16, q's
shape) and the final state (fp32) and launches one block a (sequence,
head) on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

HEAD_DIM = 128   # dk = dv, the only width the kernel takes

_P = ctypes.c_void_p
_I = ctypes.c_int
_LAUNCH = None


def _launch_fn():
    global _LAUNCH
    if _LAUNCH is None:
        fn = build.load("kda_fwd").kda_fwd_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 8 + [_I] * 3 + [ctypes.c_float, _P]
        _LAUNCH = fn
    return _LAUNCH


def kda_fwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, beta: torch.Tensor, *, scale: float,
                 initial_state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    dev = q.device
    ts = (q, k, v, g, beta) + (() if initial_state is None
                               else (initial_state,))
    if dev.type != "cuda" or any(t.device != dev for t in ts):
        raise ValueError("kda_fwd_cuda: every input on one CUDA device")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)) or \
            g.dtype != torch.float32 or beta.dtype != torch.float32 or \
            (initial_state is not None
             and initial_state.dtype != torch.float32):
        raise TypeError("kda_fwd_cuda takes bf16 q, k, v and fp32 g, beta "
                        "and initial state")
    B, S, H, dk = q.shape
    if dk != HEAD_DIM or k.shape != q.shape or v.shape != q.shape or \
            g.shape != q.shape or tuple(beta.shape) != (B, S, H):
        raise ValueError(f"kda_fwd_cuda takes q, k, v, g (B, S, H, "
                         f"{HEAD_DIM}) and beta (B, S, H); got "
                         f"{[tuple(t.shape) for t in ts]}")
    if initial_state is not None and \
            tuple(initial_state.shape) != (B, H, dk, dk):
        raise ValueError(f"initial state {tuple(initial_state.shape)}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("kda_fwd_cuda wants contiguous inputs")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("kda_fwd_cuda wants 16-byte aligned inputs")
    o = torch.empty_like(q)
    state = torch.empty((B, H, dk, dk), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            beta.data_ptr(),
            None if initial_state is None else initial_state.data_ptr(),
            o.data_ptr(), state.data_ptr(), B, S, H, float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "kda_fwd")
    return o, state
