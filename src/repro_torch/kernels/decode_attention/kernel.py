"""ctypes binding of the CUDA flash-decoding kernel (``csrc/decode_attn.cu``).

Takes the model's layout as it is (q (B, H, D), k/v (B, S, KV, D) caches,
lengths (B,) int32, all contiguous on one CUDA device), allocates the
split partials and the output, and launches both passes on PyTorch's current
stream. Lengths stay on the device: each split finds its own range there.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 8   # query heads per kv head (GMAX in the source)
WARPS = 4       # splits per block
WARPS_PER_SM = 16

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attn")
    lib.decode_attn_launch.restype = ctypes.c_int
    lib.decode_attn_launch.argtypes = ([_P] * 7 + [_I] * 8 + [ctypes.c_float]
                                       + [_P])
    return lib


def n_splits(B: int, KV: int, S: int, n_sm: int) -> int:
    """Splits per (sequence, kv head): enough warps to give every SM
    ``WARPS_PER_SM`` of them, no more than one 32-key step of the cache
    each, a multiple of ``WARPS``."""
    want = -(-n_sm * WARPS_PER_SM // (B * KV))
    cap = -(-S // 32)
    n = max(1, min(want, cap))
    return -(-n // WARPS) * WARPS


def decode_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor, *, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev or \
            lengths.device != dev:
        raise ValueError("decode_attn_cuda: q, k, v, lengths must be on one "
                         "CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attn_cuda takes f32 or bf16 (all alike), "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if lengths.dtype != torch.int32:
        raise TypeError(f"lengths must be int32, got {lengths.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV or S == 0 or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"incompatible q {tuple(q.shape)} / kv "
                         f"{tuple(k.shape)} / lengths {tuple(lengths.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if H // KV > MAX_GROUP:
        raise ValueError(f"{H // KV} query heads per kv head > {MAX_GROUP}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("decode_attn_cuda wants contiguous inputs")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("decode_attn_cuda wants 16-byte aligned q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    ns = n_splits(B, KV, S, n_sm)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, ns, D), dtype=torch.float32, device=dev)
    part_ml = torch.empty((B, H, ns, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().decode_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, S, H,
            KV, D, int(q.dtype == torch.bfloat16), ns, int(window),
            float(scale), stream)
    build.check(err, "decode_attn")
    return out
