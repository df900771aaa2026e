"""ctypes binding of the CUDA flash-decoding kernel (``csrc/decode_attn.cu``).

Takes the model's layout as it is (q (B, H, D), k/v (B, S, KV, D) caches,
lengths (B,) int32, all contiguous on one CUDA device), allocates the
split partials and the output, and launches both passes on PyTorch's current
stream. Lengths stay on the device: each split finds its own range there,
and the wrapper never reads them (no host sync). Pass 1 is one block per
(split, kv head, sequence) streaming 32-key tiles of K and V through a
shared-memory ring; ``n_splits`` sizes the grid from the SM count, which is
queried once per device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

HEAD_DIMS = (16, 32, 64, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 8      # query heads per kv head (GMAX in the source)
TILE = 32          # keys per ring tile (BT in the source)
BLOCKS_PER_SM = 4  # pass-1 blocks an SM at bf16 (54 KB of ring each)
WAVES = 4          # waves of pass-1 blocks: splits short enough that
                   # sequences of unequal length even out across the SMs
SPLIT_TILES = 16   # but no split of a full cache under this many tiles
                   # (on the device none under 128 keys, MIN_CHUNK in the
                   # source: a short sequence leaves its last splits empty)

_P = ctypes.c_void_p
_I = ctypes.c_int


_LAUNCH = None  # the C launch function, typed once (the decode step calls
                # this wrapper every layer)


def _launch_fn():
    global _LAUNCH
    if _LAUNCH is None:
        fn = build.load("decode_attn").decode_attn_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [_P] * 7 + [_I] * 8 + [ctypes.c_float] + [_P]
        _LAUNCH = fn
    return _LAUNCH


def n_splits(B: int, KV: int, S: int, n_sm: int) -> int:
    """Splits per (sequence, kv head): enough pass-1 blocks for ``WAVES``
    full waves of ``BLOCKS_PER_SM`` blocks on every SM, but none shorter
    than ``SPLIT_TILES`` tiles of a full cache (a block's fixed cost)."""
    want = -(-WAVES * n_sm * BLOCKS_PER_SM // (B * KV))
    return max(1, min(want, -(-S // (SPLIT_TILES * TILE))))


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
    ns = n_splits(B, KV, S, build.sm_count(dev))
    out = torch.empty_like(q)
    # one scratch block: the splits' (B, H, ns, D) f32 partial sums, then
    # their (B, H, ns) float2 (max, sum) pairs
    part = torch.empty(B * H * ns * (D + 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _launch_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            out.data_ptr(), part.data_ptr(),
            part.data_ptr() + 4 * B * H * ns * D, B, S, H, KV, D,
            int(q.dtype == torch.bfloat16), ns, int(window), float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check(err, "decode_attn")
    return out
