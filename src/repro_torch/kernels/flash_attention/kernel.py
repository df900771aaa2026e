"""ctypes binding of the CUDA flash-attention forward (``csrc/flash_fwd.cu``).

Takes the wrapper's layout as it is (q (B, Sq, H, D), k/v (B, Skv, KV, D),
contiguous) and returns (out (B, Sq, H, D) in the input dtype, lse
(B, H, Sq) f32). The dtype picks the path: bf16 runs the wgmma kernel
(128-row q tiles, 128-key tiles), f32 the FMA kernel (64 and 64).

``flash_bwd_cuda`` binds the backward (``csrc/flash_bwd.cu``): the same
layouts plus out, lse and dout, returning (dq, dk, dv) in the input dtype.
bf16 runs two wgmma kernels (dQ, then dK/dV), f32 one pass on the FMA
units: a block per key tile of ``BWD_KEY_TILE`` keys accumulates its dK and
dV and writes its fp32 share of dQ to a slab, and a last kernel sums the
slabs in key-tile order (``sum_key_tile_partials`` is the plain mirror of
that sum). Under GQA the dK/dV grid has a block per query head, each
writing fp32 partials that another kernel sums over the group in head
order (``reduce_head_partials`` is the plain mirror of that sum).

A v head dim other than q's (MLA: q/k 192, v 128, bf16; ``MLA_HEAD_DIMS``)
runs the bf16 kernel's body as ``flash_fwd_mla``, a kernel of its own name
(the same entry, ``flash_fwd_launch``), out (B, Sq, H, 128).

``kv_tile_range`` and ``keyless_row`` mirror the CUDA arithmetic that
decides which key tiles a q tile visits, ``tiles_meet`` the backward's
test of a (q tile, key tile) pair and ``needs_mask`` its test of whether
a pair needs the element mask at all; the CPU tests hold them against the
reference's ``_kv_block_live`` and the element mask.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import attention_fwd_reference

HEAD_DIMS = (64, 80, 128)
# (q/k, v) head dims of the MLA forward (bf16 only)
MLA_HEAD_DIMS = ((192, 128),)
DTYPES = (torch.float32, torch.bfloat16)
# (q rows, keys) of a tile, by path
TILES = {torch.bfloat16: (128, 128), torch.float32: (64, 64)}
# keys of the backward's key tile (the f32 path writes one dQ share each)
BWD_KEY_TILE = 64

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_fwd")
    lib.flash_fwd_launch.restype = ctypes.c_int
    lib.flash_fwd_launch.argtypes = ([_P] * 5 + [_I] * 8 + [ctypes.c_float]
                                     + [_I] * 3 + [_P])
    return lib


@functools.lru_cache(maxsize=None)
def _bwd_fn():
    fn = build.load("flash_bwd").flash_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [_P] * 13 + [_I] * 7 + [ctypes.c_float] + [_I] * 3 + [_P]
    return fn


def keyless_row(q0: int, bq: int, Sq: int, Skv: int, *, causal: bool,
                window: int, q_offset: int) -> bool:
    """Does a real row of the q tile [q0, q0 + bq) see no key? (Such a row
    gets the reference's uniform softmax over the Skv keys.)"""
    first = q0 + q_offset
    last = min(q0 + bq, Sq) - 1 + q_offset
    return bool((causal and first < 0)
                or (window > 0 and last - window >= Skv - 1))


def kv_tile_range(q0: int, bq: int, bk: int, Sq: int, Skv: int, *,
                  causal: bool, window: int, q_offset: int) -> Tuple[int, int]:
    """[lo, hi): the bk-key tiles the q tile [q0, q0 + bq) visits, as
    ``csrc/flash_fwd.cu::kv_tile_range`` computes them: every tile when a
    row sees no key, else the tiles where the reference's
    ``_kv_block_live`` holds."""
    nkt = -(-Skv // bk)
    if keyless_row(q0, bq, Sq, Skv, causal=causal, window=window,
                   q_offset=q_offset):
        return 0, nkt
    hi = min(nkt, (q0 + bq - 1 + q_offset) // bk + 1) if causal else nkt
    x = q0 + q_offset - window + 1
    lo = x // bk if window > 0 and x > 0 else 0
    return lo, hi


def tiles_meet(q0: int, bq: int, k0: int, bk: int, Sq: int, *, causal: bool,
               window: int, q_offset: int) -> bool:
    """Can a query of [q0, q0 + bq) (rows below Sq) see a key of
    [k0, k0 + bk)? ``csrc/flash_bwd.cu::tiles_meet``: true whenever one pair
    is visible; both backward kernels skip the pairs where it fails."""
    p_lo = q0 + q_offset
    p_hi = min(q0 + bq, Sq) - 1 + q_offset
    if causal and k0 > p_hi:
        return False
    return not (window > 0 and k0 + bk - 1 <= p_lo - window)


def needs_mask(q0: int, nq: int, k0: int, nk: int, Sq: int, Skv: int, *,
               causal: bool, window: int, q_offset: int) -> bool:
    """Does some (query, key) pair of rows [q0, q0 + nq) and keys
    [k0, k0 + nk) lie past Sq or Skv, or outside the causal or window mask?
    ``csrc/flash_bwd.cu::needs_mask``: where it is false the bf16 backward
    skips the element mask, so every pair must be visible there."""
    return (q0 + nq > Sq or k0 + nk > Skv
            or (causal and k0 + nk - 1 > q0 + q_offset)
            or (window > 0 and k0 <= q0 + nq - 1 + q_offset - window))


def reduce_head_partials(part: torch.Tensor, KV: int,
                         dtype: torch.dtype) -> torch.Tensor:
    """dk or dv (B, Skv, KV, D) in ``dtype`` from the per-query-head fp32
    partials (B, Skv, H, D) of the GQA backward: the partials of heads
    kvh G .. kvh G + G - 1 summed in that order, then cast, as
    ``csrc/flash_bwd.cu::reduce_heads`` sums them."""
    B, Skv, H, D = part.shape
    p = part.reshape(B, Skv, KV, H // KV, D)
    acc = p[:, :, :, 0]
    for g in range(1, H // KV):
        acc = acc + p[:, :, :, g]
    return acc.to(dtype)


def sum_key_tile_partials(part: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """dq (B, Sq, H, D) in ``dtype`` from the key tiles' fp32 shares
    (B, n_kt, Sq, H, D) of the f32 backward: summed in key-tile order
    kt = 0 .. n_kt - 1, then cast, as ``csrc/flash_bwd.cu::sum_key_tiles``
    sums them (it skips the tiles ``tiles_meet`` rules out for a row's q
    tile, whose shares are 0)."""
    acc = part[:, 0]
    for t in range(1, part.shape[1]):
        acc = acc + part[:, t]
    return acc.to(dtype)


def plain_like_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      **kw) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version that rounds as this kernel does: a bf16 input
    rounds P to bf16 against the running max of each key tile (as the
    wgmma kernel and the TPU kernel do), f32 keeps P in fp32."""
    if q.dtype == torch.bfloat16:
        kw.update(p_dtype=torch.bfloat16, block_kv=TILES[torch.bfloat16][1])
    return attention_fwd_reference(q, k, v, **kw)


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
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 or \
            k.shape[:3] != v.shape[:3]:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[3]
    if k.shape[0] != B or k.shape[3] != D or H % KV or Skv == 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} / kv "
                         f"{tuple(k.shape)}")
    mla = Dv != D
    if mla and (q.dtype != torch.bfloat16 or (D, Dv) not in MLA_HEAD_DIMS):
        raise ValueError(f"head dims (q/k {D}, v {Dv}), {q.dtype}: the MLA "
                         f"kernel takes bf16 at {MLA_HEAD_DIMS}")
    if not mla and D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_fwd_cuda wants contiguous q, k, v")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd_cuda wants 16-byte aligned q, k, v")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    out = q.new_empty((B, Sq, H, Dv))
    lse = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    if B * Sq == 0:
        return out, lse
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().flash_fwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), B, Sq, Skv, H, KV, D, Dv,
            int(q.dtype == torch.bfloat16), float(scale), int(bool(causal)),
            int(window), int(q_offset), stream)
    build.check(err, "flash_fwd")
    return out, lse


def _check_like(ref: torch.Tensor, *ts: torch.Tensor, what: str) -> None:
    for t in ts:
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(f"{what}: {t.dtype} on {t.device}, want "
                             f"{ref.dtype} on {ref.device}")


def flash_bwd_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                   *, causal: bool, window: int = 0, q_offset: int = 0,
                   scale: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention at (q, k, v), given the forward's ``out``
    and ``lse`` and the cotangent ``dout`` of ``out`` (any strides: it is
    made contiguous here)."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError("flash_bwd_cuda: q, k, v must be on one CUDA device")
    if q.dtype not in DTYPES:
        raise TypeError(f"flash_bwd_cuda takes f32 or bf16, got {q.dtype}")
    _check_like(q, k, v, out, dout, what="flash_bwd_cuda")
    if lse.device != dev or lse.dtype != torch.float32:
        raise ValueError("flash_bwd_cuda: lse must be f32 on q's device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"shapes {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or H % KV or Skv == 0:
        raise ValueError(f"incompatible q {tuple(q.shape)} / kv "
                         f"{tuple(k.shape)}")
    if out.shape != q.shape or dout.shape != q.shape or \
            tuple(lse.shape) != (B, H, Sq):
        raise ValueError(f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, "
                         f"lse {tuple(lse.shape)} for q {tuple(q.shape)}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    dout = dout.contiguous()
    ins = (q, k, v, out, lse, dout)
    if not all(t.is_contiguous() for t in ins):
        raise ValueError("flash_bwd_cuda wants contiguous q, k, v, out, lse")
    if any(t.data_ptr() % 16 for t in ins):
        raise ValueError("flash_bwd_cuda wants 16-byte aligned inputs")
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if B * Sq == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
    # per-query-head fp32 dK and dV under GQA, summed over the group by the
    # kernel's last pass
    part = (torch.empty((2, B, Skv, H, D), dtype=torch.float32, device=dev)
            if H > KV else None)
    # f32: each key tile's fp32 share of dQ, summed in key-tile order
    dq_part = (None if q.dtype == torch.bfloat16 else torch.empty(
        (B, -(-Skv // BWD_KEY_TILE), Sq, H, D), dtype=torch.float32,
        device=dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _bwd_fn()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(),
            None if part is None else part[0].data_ptr(),
            None if part is None else part[1].data_ptr(),
            None if dq_part is None else dq_part.data_ptr(), B, Sq, Skv, H,
            KV, D, int(q.dtype == torch.bfloat16), float(scale),
            int(bool(causal)), int(window), int(q_offset), stream)
    build.check(err, "flash_bwd")
    return dq, dk, dv
