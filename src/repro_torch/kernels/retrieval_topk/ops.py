"""Dispatch for the retrieval top-k scans.

The device of the bank decides: a CPU bank takes the plain version
(``ref.py``, streamed in chunks), a CUDA bank launches the hand-written
kernel (``kernel.py``) or raises. One plain-int launch counter per kernel:
``launches`` (the exhaustive int4 scan, which the IVF union strategy also
runs), ``launches_gathered`` (the per-query gathered int4 scan) and
``launches_dense`` (the dense fp32 scan). The kernels have no backward
(nor has the reference): under grad mode an input that needs a gradient
raises (``grad_guard``).

  * ``retrieval_topk``: dense fp32 bank.
  * ``retrieval_topk_int4``: packed int4 bank, the device bank's scan.
  * ``retrieval_topk_int4_gathered``: per-query candidate rows of a packed
    int4 bank (IVF pruned scan, ``strategy="gathered"``).
  * ``retrieval_topk_int4_rows``: one candidate-row set shared by the whole
    batch (IVF pruned scan, ``strategy="union"``, over one unsharded bank;
    ``DeviceBank.search_rows`` makes the same gather a shard): the rows are
    gathered with ``index_select`` and scanned by the exhaustive int4
    kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels.grad_guard import NO_REFERENCE_GRAD, refuse_grad
from repro_torch.kernels.retrieval_topk.ref import (
    retrieval_topk_int4_gathered_reference, retrieval_topk_int4_reference,
    retrieval_topk_reference)

PLAIN_BLOCK_N = 65536   # bank rows per chunk of the plain versions
PLAIN_BLOCK_L = 4096    # candidates per chunk of the plain gathered version
launches = 0
launches_gathered = 0
launches_dense = 0


def _on_cuda(t: torch.Tensor, what: str, *inputs) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for {t.device}")
    refuse_grad(what, NO_REFERENCE_GRAD, t, *inputs)


def retrieval_topk(query: torch.Tensor, bank: torch.Tensor, k: int, *,
                   normalize: bool = True, n_valid: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a dense fp32 bank (N, E); rows ``>= n_valid`` score
    -1e30. Returns ((Q, k) f32 scores, (Q, k) int32 row ids), descending,
    ties to the lower id."""
    global launches_dense
    if bank.device.type == "cpu":
        return retrieval_topk_reference(query, bank, k, normalize=normalize,
                                        n_valid=n_valid, block_n=PLAIN_BLOCK_N)
    _on_cuda(bank, "retrieval_topk", query)
    from repro_torch.kernels.retrieval_topk.kernel import retrieval_topk_cuda
    out = retrieval_topk_cuda(query, bank, k, normalize=normalize,
                              n_valid=n_valid)
    launches_dense += 1
    return out


def retrieval_topk_int4(query: torch.Tensor, packed: torch.Tensor,
                        scales: torch.Tensor, k: int, *,
                        normalize: bool = False,
                        n_valid: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over a packed int4 bank: ``packed`` (N, E//2) int8 nibble rows
    + ``scales`` (N, 1) per-row absmax (``quantize_int4`` layout); rows
    ``>= n_valid`` score -1e30. Returns ((Q, k) f32 scores, (Q, k) int32
    row ids), descending, ties to the lower id."""
    global launches
    if packed.device.type == "cpu":
        return retrieval_topk_int4_reference(query, packed, scales, k,
                                             normalize=normalize,
                                             n_valid=n_valid,
                                             block_n=PLAIN_BLOCK_N)
    _on_cuda(packed, "retrieval_topk_int4", query, scales)
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_cuda)
    out = retrieval_topk_int4_cuda(query, packed, scales, k,
                                   normalize=normalize, n_valid=n_valid)
    launches += 1
    return out


def retrieval_topk_int4_gathered(query: torch.Tensor, packed: torch.Tensor,
                                 scales: torch.Tensor, row_ids: torch.Tensor,
                                 k: int, *, normalize: bool = False,
                                 n_valid: Optional[int] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over per-query candidate rows of a packed int4 bank: ``row_ids``
    (Q, L) int32, -1 = padding, ids >= ``n_valid`` (past a snapshot's fill)
    dead. L < k is padded with -1. Returns ((Q, k) scores, (Q, k) global
    row ids); slots with no live candidate hold (-1e30, -1). The kernel
    scans raw inner products: ``normalize`` is for the plain version only,
    as in the reference's Pallas path."""
    global launches_gathered
    row_ids = row_ids.to(torch.int32)
    if row_ids.shape[1] < k:  # top-k needs >= k columns; -1 pads are dead
        row_ids = torch.nn.functional.pad(row_ids, (0, k - row_ids.shape[1]),
                                          value=-1)
    if packed.device.type == "cpu":
        return retrieval_topk_int4_gathered_reference(
            query, packed, scales, row_ids, k, normalize=normalize,
            n_valid=n_valid, block_l=PLAIN_BLOCK_L)
    _on_cuda(packed, "retrieval_topk_int4_gathered", query, scales)
    if normalize:
        raise ValueError("the gathered int4 kernel scans raw inner products; "
                         "normalize=True is for CPU tensors (plain version)")
    from repro_torch.kernels.retrieval_topk.kernel import (
        retrieval_topk_int4_gathered_cuda)
    out = retrieval_topk_int4_gathered_cuda(query, packed, scales,
                                            row_ids.contiguous(), k,
                                            n_valid=n_valid)
    launches_gathered += 1
    return out


def pow2_bucket(m: int, *, floor: int = 1, refine_above: int = 8192) -> int:
    """Shape bucket for a candidate set of ``m`` rows: the next power of two
    >= max(m, floor), refined with a 3/4 step above ``refine_above`` (scan
    cost tracks the padded size, so a 21k union should not pay for 32k
    rows)."""
    m = max(int(m), int(floor), 1)
    bucket = 1 << (m - 1).bit_length()
    if bucket >= refine_above and m <= 3 * bucket // 4:
        bucket = 3 * bucket // 4
    return bucket


def retrieval_topk_int4_rows(query: torch.Tensor, packed: torch.Tensor,
                             scales: torch.Tensor, rows, k: int, *,
                             normalize: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over ONE candidate-row set shared by the whole query batch (the
    IVF batch-union strategy): ``rows`` (m,) names the candidate bank rows.
    They are padded to a ``pow2_bucket`` (pad slots gather row 0 and are
    masked by ``n_valid = m``), gathered on the bank's device with
    ``index_select`` and scanned by ``retrieval_topk_int4``, whose per-row
    arithmetic is the exhaustive scan's. Returns ((Q, k) scores, (Q, k)
    LOCAL indices into ``rows``). Requires 0 < k <= len(rows)."""
    rows = np.asarray(rows, np.int64).ravel()
    m = rows.size
    if not 0 < k <= m:
        raise ValueError(f"k={k} must be in [1, {m}] (the union's size)")
    # pad in numpy, not with CPU torch ops: those wake torch's OpenMP pool,
    # which then competes with numpy's BLAS threads on the query path
    idx = np.zeros(pow2_bucket(m, floor=k), np.int64)
    idx[:m] = rows
    idx = torch.from_numpy(idx).to(packed.device)
    return retrieval_topk_int4(query, packed.index_select(0, idx),
                               scales.index_select(0, idx), k,
                               normalize=normalize, n_valid=m)
