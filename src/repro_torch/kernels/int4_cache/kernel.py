"""ctypes bindings of the CUDA int4 activation-cache kernels
(``csrc/int4_cache.cu``): per-row quantize + nibble pack, and its inverse.

Each wrapper checks device, dtype, shape and contiguity, allocates its
outputs, and launches on PyTorch's current stream. The quantize keeps a
row in registers where ``quant_path`` says so, and reads it twice in a
loop otherwise.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

QUANT_VECTORS = 12  # 16-byte vectors of a row a lane keeps on the
                    # quantize's register path (csrc/int4_cache.cu VMAX)


@functools.cache  # typed once: the quantize runs a dozen times a drain
def _lib() -> ctypes.CDLL:
    lib = build.load("int4_cache")
    lib.int4_quant_launch.restype = ctypes.c_int
    lib.int4_quant_launch.argtypes = [_P, _I, _P, _P, _L, _I, _P]
    lib.int4_dequant_launch.restype = ctypes.c_int
    lib.int4_dequant_launch.argtypes = [_P, _P, _P, _I, _L, _I, _P]
    lib.int4_quant_path.restype = ctypes.c_int
    lib.int4_quant_path.argtypes = [_I, _I, _P]
    return lib


def quant_path(D: int, dtype: torch.dtype, aligned: bool = True) -> str:
    """The quantize's path for rows of width D, as
    ``csrc/int4_cache.cu::quant_in_registers`` picks it: "registers" (the
    row read once into a warp's registers, packed words stored 128 bytes
    an instruction) for D a multiple of 8 within 32 lanes x QUANT_VECTORS
    16-byte vectors and x 16-byte aligned, else "looped" (two reads)."""
    per_vector = 16 // (4 if dtype == torch.float32 else 2)
    fits = D % 8 == 0 and D <= 32 * QUANT_VECTORS * per_vector
    return "registers" if fits and aligned else "looped"


def quant_path_cuda(x: torch.Tensor) -> str:
    """The path the card's launch takes for ``x`` (``int4_quant_path``)."""
    return ("registers" if _lib().int4_quant_path(
        x.shape[-1], int(x.dtype == torch.bfloat16), x.data_ptr())
        else "looped")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def int4_quant_cuda(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) f32 or bf16 on a CUDA device, D even, contiguous ->
    (packed (N, D//2) int8, scale (N, 1) f32)."""
    if x.device.type != "cuda":
        raise ValueError(f"int4_quant_cuda: x is on {x.device}, not CUDA")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_quant_cuda takes f32 or bf16, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] < 2 or x.shape[1] % 2:
        raise ValueError(f"int4_quant_cuda wants (N, D) with D even, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("int4_quant_cuda wants a contiguous x")
    N, D = x.shape
    packed = torch.empty((N, D // 2), dtype=torch.int8, device=x.device)
    scale = torch.empty((N, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = _lib().int4_quant_launch(
            x.data_ptr(), int(x.dtype == torch.bfloat16), packed.data_ptr(),
            scale.data_ptr(), N, D, _stream(x.device))
    build.check(err, "int4_quant")
    return packed, scale


def int4_dequant_cuda(packed: torch.Tensor, scale: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """packed (N, D//2) int8 + scale (N, 1) f32 on one CUDA device ->
    (N, D) ``dtype`` (f32 or bf16)."""
    dev = packed.device
    if dev.type != "cuda" or scale.device != dev:
        raise ValueError(f"int4_dequant_cuda: packed on {dev}, scale on "
                         f"{scale.device}; both must be on one CUDA device")
    if packed.dtype != torch.int8 or scale.dtype != torch.float32:
        raise TypeError(f"int4_dequant_cuda takes int8 packed and f32 scale, "
                        f"got {packed.dtype}, {scale.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"int4_dequant_cuda writes f32 or bf16, not {dtype}")
    if packed.dim() != 2 or packed.shape[1] < 1 or \
            tuple(scale.shape) != (packed.shape[0], 1):
        raise ValueError(f"int4_dequant_cuda wants packed (N, D//2) and "
                         f"scale (N, 1), got {tuple(packed.shape)}, "
                         f"{tuple(scale.shape)}")
    if not (packed.is_contiguous() and scale.is_contiguous()):
        raise ValueError("int4_dequant_cuda wants contiguous inputs")
    N, D2 = packed.shape
    out = torch.empty((N, 2 * D2), dtype=dtype, device=dev)
    with torch.cuda.device(dev):
        err = _lib().int4_dequant_launch(
            packed.data_ptr(), scale.data_ptr(), out.data_ptr(),
            int(dtype == torch.bfloat16), N, D2, _stream(dev))
    build.check(err, "int4_dequant")
    return out
