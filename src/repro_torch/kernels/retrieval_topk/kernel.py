"""ctypes bindings of the CUDA top-k scans: the exhaustive int4 scan
(``csrc/topk_int4.cu``), the gathered int4 scan over per-query candidate
ids (``csrc/topk_int4_gather.cu``, the IVF pruned path) and the dense fp32
scan (``csrc/topk_dense.cu``).

Each wrapper checks devices, types, shapes, contiguity and alignment,
allocates the outputs and the pass-1 scratch, and launches on PyTorch's
current stream. The two exhaustive scans share one pass-1 tile
(``csrc/topk_tile.cuh``: 96 or 64 queries x 128 bank rows a block, two
blocks an SM); ``query_tile`` and ``chunk_rows`` size their grids as one
wave of it. The gathered scan's pass 1 is a block of four warps on a share
of one query's candidates, as many blocks an SM as its shared memory
allows (``gather_blocks_per_sm``); ``gather_blocks`` sizes its grid as one
wave of them.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build

K_MAX = 64
E_MAX = 2048       # the int4 scans' widest row (the gathered scan stages
                   # whole query rows in shared memory)
TILE_ROWS = 128    # bank rows per tile of the exhaustive scans' pass 1
BLOCKS_PER_SM = 2  # their pass-1 occupancy (256 threads, 128 registers)
GATHER_WARPS = 4   # warps (and partial lists) per gathered pass-1 block
                   # (csrc/topk_int4_gather.cu; the launch refuses another
                   # count)
# the gathered pass 1's shared memory, as csrc/topk_int4_gather.cu lays it
# out: the query row, each warp's 2-stage ring of 32 row slices of 256
# bytes at a 272-byte stride, each warp's list and count, 5 decode keys
GATHER_RING_BYTES = GATHER_WARPS * 2 * 32 * 272
SMEM_PER_SM = 233_472           # an H100 SM's shared memory (228 KB, the
                                # whole carveout, as the kernel asks)
SMEM_RESERVED_PER_BLOCK = 1024  # of it kept back for each resident block

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name: str) -> ctypes.CDLL:
    lib = build.load(name)
    fn = getattr(lib, f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = {"topk_int4": [_P] * 7 + [_I] * 7 + [_P],
                   "topk_int4_gather": [_P] * 8 + [_I] * 7 + [_P],
                   "topk_dense": [_P] * 6 + [_I] * 7 + [_P]}[name]
    if name == "topk_int4_gather":
        lib.topk_int4_gather_occupancy.restype = ctypes.c_int
        lib.topk_int4_gather_occupancy.argtypes = [_I, ctypes.POINTER(_I)]
    return lib


def _check_common(what: str, query: torch.Tensor, bank: torch.Tensor,
                  others, k: int, n_rows: int) -> None:
    """Device, query dtype/shape, contiguity, 16-byte alignment and k."""
    dev = bank.device
    if dev.type != "cuda" or any(t.device != dev for t in (query, *others)):
        raise ValueError(f"{what}: every input must be on one CUDA device, "
                         f"got {[str(t.device) for t in (query, bank, *others)]}")
    if query.dtype != torch.float32 or query.dim() != 2:
        raise TypeError(f"{what} wants a 2-D f32 query, got {query.dtype} "
                        f"{tuple(query.shape)}")
    if not all(t.is_contiguous() for t in (query, bank, *others)):
        raise ValueError(f"{what} wants contiguous inputs")
    if bank.data_ptr() % 16:
        raise ValueError(f"{what}: the bank must be 16-byte aligned")
    if not 1 <= k <= min(K_MAX, n_rows):
        raise ValueError(f"k={k} must be in [1, min({K_MAX}, {n_rows})]")


def retrieval_topk_int4_cuda(query: torch.Tensor, packed: torch.Tensor,
                             scales: torch.Tensor, k: int, *,
                             normalize: bool = False,
                             n_valid: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E) f32; packed (N, E//2) int8; scales (N, 1) f32, all on
    one CUDA device -> ((Q, k) f32 scores, (Q, k) int32 row ids)."""
    what = "retrieval_topk_int4_cuda"
    Q, E, N = _check_int4(what, query, packed, scales, k, packed.shape[0])
    if query.data_ptr() % 16:
        raise ValueError(f"{what}: the query must be 16-byte aligned")
    dev = packed.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    nv = N if n_valid is None else max(0, min(int(n_valid), N))
    rows = chunk_rows(Q, nv, build.sm_count(dev))
    n_chunks = max(1, -(-nv // rows))
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib("topk_int4").topk_int4_launch(
            query.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            part_s.data_ptr(), part_i.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), Q, E, k, nv, int(bool(normalize)), rows,
            n_chunks, stream)
    build.check(err, "retrieval_topk_int4")
    return out_s, out_i


def _check_int4(what: str, query: torch.Tensor, packed: torch.Tensor,
                scales: torch.Tensor, k: int, n_rows: int,
                others=()) -> Tuple[int, int, int]:
    _check_common(what, query, packed, (scales, *others), k, n_rows)
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"{what} wants int8 packed and f32 scales, got "
                        f"{packed.dtype}, {scales.dtype}")
    Q, E = query.shape
    N = packed.shape[0]
    if packed.dim() != 2 or E % 2 or E > E_MAX or packed.shape[1] * 2 != E:
        raise ValueError(f"E={E} must be even, <= {E_MAX}, and match "
                         f"packed {tuple(packed.shape)}")
    if tuple(scales.shape) != (N, 1):
        raise ValueError(f"scales shape {tuple(scales.shape)} != ({N}, 1)")
    return Q, E, N


def retrieval_topk_int4_gathered_cuda(query: torch.Tensor,
                                      packed: torch.Tensor,
                                      scales: torch.Tensor,
                                      row_ids: torch.Tensor, k: int, *,
                                      n_valid: Optional[int] = None
                                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E) f32; packed (N, E//2) int8; scales (N, 1) f32; row_ids
    (Q, L) int32 candidate bank rows (< 0 or >= n_valid: dead), L >= k, all
    on one CUDA device -> ((Q, k) f32 scores, (Q, k) int32 global row ids);
    slots with no live candidate hold (-1e30, -1)."""
    what = "retrieval_topk_int4_gathered_cuda"
    if row_ids.dtype != torch.int32 or row_ids.dim() != 2 \
            or row_ids.shape[0] != query.shape[0]:
        raise ValueError(f"{what} wants (Q, L) int32 row ids, got "
                         f"{row_ids.dtype} {tuple(row_ids.shape)}")
    L = row_ids.shape[1]
    Q, E, N = _check_int4(what, query, packed, scales, k, L, (row_ids,))
    dev = packed.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    nv = N if n_valid is None else max(0, min(int(n_valid), N))
    n_blocks = gather_blocks(Q, L, E, build.sm_count(dev))
    n_parts = n_blocks * GATHER_WARPS
    part_s = torch.empty((Q, n_parts, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_parts, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib("topk_int4_gather").topk_int4_gather_launch(
            query.data_ptr(), packed.data_ptr(), scales.data_ptr(),
            row_ids.data_ptr(), part_s.data_ptr(), part_i.data_ptr(),
            out_s.data_ptr(), out_i.data_ptr(), Q, E, L, k, nv, n_blocks,
            n_parts, stream)
    build.check(err, "retrieval_topk_int4_gathered")
    return out_s, out_i


def gather_smem_bytes(E: int) -> int:
    """Shared memory of one gathered pass-1 block at width E
    (``csrc/topk_int4_gather.cu::smem_bytes``)."""
    return (-(-E // 4) * 16 + GATHER_RING_BYTES
            + GATHER_WARPS * K_MAX * 8 + GATHER_WARPS * 4 + 5 * 4)


def gather_blocks_per_sm(E: int) -> int:
    """Gathered pass-1 blocks an H100 SM holds at width E: its shared
    memory is the limit (the kernel's launch bounds keep its registers
    within three blocks; ``chip_smoke.py`` holds this to the card's
    occupancy query)."""
    return SMEM_PER_SM // (gather_smem_bytes(E) + SMEM_RESERVED_PER_BLOCK)


def gather_blocks(Q: int, L: int, E: int, n_sm: int) -> int:
    """Pass-1 blocks per query of the gathered scan: as many as one wave of
    ``gather_blocks_per_sm`` blocks on ``n_sm`` SMs gives each query (one
    if Q alone fills the wave), and no more than give every warp one group
    of 32 of the L candidates (the kernel deals the groups round-robin)."""
    per_q = max(1, gather_blocks_per_sm(E) * n_sm // Q)
    return min(per_q, -(-L // (GATHER_WARPS * 32)))


def gather_occupancy(E: int, device=None) -> int:
    """The card's own count of gathered pass-1 blocks an SM holds at width
    E (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    blocks = _I(0)
    with torch.cuda.device(device):
        build.check(_lib("topk_int4_gather").topk_int4_gather_occupancy(
            E, ctypes.byref(blocks)), "topk_int4_gather_occupancy")
    return blocks.value


def query_tile(Q: int) -> int:
    """Query rows per pass-1 block of the exhaustive scans (int4 and
    dense), as ``csrc/topk_tile.cuh::wide_query_tile`` picks them: 96, or
    64 where that pads Q less."""
    return 96 if -(-Q // 96) * 96 <= -(-Q // 64) * 64 else 64


def chunk_rows(Q: int, n_valid: int, n_sm: int) -> int:
    """Bank rows per pass-1 block of the exhaustive scans: the live rows
    split in whole tiles so that the grid (query blocks x chunks, the query
    blocks of a chunk side by side) is one wave at ``BLOCKS_PER_SM``."""
    parts = max(1, BLOCKS_PER_SM * n_sm // -(-Q // query_tile(Q)))
    return max(TILE_ROWS, -(-n_valid // (parts * TILE_ROWS)) * TILE_ROWS)


def retrieval_topk_cuda(query: torch.Tensor, bank: torch.Tensor, k: int, *,
                        normalize: bool = True,
                        n_valid: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query (Q, E) f32; bank (N, E) f32, both on one CUDA device ->
    ((Q, k) f32 scores, (Q, k) int32 row ids); rows >= n_valid masked."""
    what = "retrieval_topk_cuda"
    _check_common(what, query, bank, (), k, bank.shape[0])
    Q, E = query.shape
    if bank.dtype != torch.float32 or bank.dim() != 2 or bank.shape[1] != E:
        raise ValueError(f"{what} wants an (N, {E}) f32 bank, got "
                         f"{bank.dtype} {tuple(bank.shape)}")
    if query.data_ptr() % 16:
        raise ValueError(f"{what}: the query must be 16-byte aligned")
    N = bank.shape[0]
    dev = bank.device
    out_s = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((Q, k), dtype=torch.int32, device=dev)
    if Q == 0:
        return out_s, out_i
    nv = N if n_valid is None else max(0, min(int(n_valid), N))
    rows = chunk_rows(Q, nv, build.sm_count(dev))
    n_chunks = max(1, -(-nv // rows))
    part_s = torch.empty((Q, n_chunks, k), dtype=torch.float32, device=dev)
    part_i = torch.empty((Q, n_chunks, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib("topk_dense").topk_dense_launch(
            query.data_ptr(), bank.data_ptr(), part_s.data_ptr(),
            part_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(), Q, E, k,
            nv, int(bool(normalize)), rows, n_chunks, stream)
    build.check(err, "retrieval_topk_dense")
    return out_s, out_i
