"""ctypes binding of the CUDA int4 top-k scan (``csrc/topk_int4.cu``).

The wrapper checks devices, types, shapes and contiguity, allocates the
outputs and the pass-1 scratch, and launches on PyTorch's current stream.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

K_MAX = 64
E_MAX = 2048
CHUNK_ROWS = 4096  # bank rows per pass-1 block

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("topk_int4")
    lib.topk_int4_launch.restype = ctypes.c_int
    lib.topk_int4_launch.argtypes = [_P] * 7 + [_I] * 7 + [_P]
    return lib


def retrieval_topk_int4_cuda(query: torch.Tensor, packed: torch.Tensor,
                             scales: torch.Tensor, k: int, *,
                             normalize: bool = False,
                             n_valid: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E) f32; packed (N, E//2) int8; scales (N, 1) f32, all on
    one CUDA device -> ((Q, k) f32 scores, (Q, k) int32 row ids)."""
    dev = packed.device
    if dev.type != "cuda" or query.device != dev or scales.device != dev:
        raise ValueError("retrieval_topk_int4_cuda: query, packed and scales "
                         "must be on one CUDA device, got "
                         f"{query.device}, {packed.device}, {scales.device}")
    if query.dtype != torch.float32 or packed.dtype != torch.int8 \
            or scales.dtype != torch.float32:
        raise TypeError("retrieval_topk_int4_cuda wants f32 query, int8 "
                        "packed, f32 scales; got "
                        f"{query.dtype}, {packed.dtype}, {scales.dtype}")
    if query.dim() != 2 or packed.dim() != 2:
        raise ValueError(f"shapes {tuple(query.shape)}, {tuple(packed.shape)}")
    Q, E = query.shape
    N = packed.shape[0]
    if E % 2 or E > E_MAX or packed.shape[1] * 2 != E:
        raise ValueError(f"E={E} must be even, <= {E_MAX}, and match "
                         f"packed width {packed.shape[1]}")
    if tuple(scales.shape) != (N, 1):
        raise ValueError(f"scales shape {tuple(scales.shape)} != ({N}, 1)")
    if not 1 <= k <= min(K_MAX, N):
        raise ValueError(f"k={k} must be in [1, min({K_MAX}, N={N})]")
    if not (query.is_contiguous() and packed.is_contiguous()
            and scales.is_contiguous()):
        raise ValueError("retrieval_topk_int4_cuda wants contiguous inputs")
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    nv = N if n_valid is None else max(0, min(int(n_valid), N))
    n_chunks = max(1, -(-nv // CHUNK_ROWS))
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().topk_int4_launch(
            query.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), Q, E, k, nv, int(bool(normalize)), CHUNK_ROWS,
            n_chunks, stream)
    build.check(err, "retrieval_topk_int4")
    return out_s, out_i
