"""Device-resident embedding bank: the searchable copy of the store's int4
slab, kept on the device and refreshed *incrementally*.

  * ``packed`` (cap, E//2) int8 + ``scales`` (cap, 1) fp32 live on the
    bank's device; queries run the fused dequant-and-scan
    ``retrieval_topk_int4`` (the CUDA kernel on a CUDA bank), so the fp32
    bank never exists in device memory;
  * a refresh scatters ONLY the rows dirtied since the last one
    (``index_copy_`` of the dirty rows' packed nibbles + scales — the host
    payload is just those rows), and grows by slab doubling *on device* in
    lockstep with the host slab (a device-to-device copy, no re-upload);
  * every refresh publishes a generation-counted ``BankSnapshot``;
  * the IVF pruned scans read the same slab: ``search_rows`` (one candidate
    union for the batch) and ``search_gathered`` (per-query candidates).

Single device, synchronous refresh. The scatter updates the published
buffers in place (the reference publishes a fresh copy-on-write buffer
instead); the store therefore runs refresh and scan under one lock hold,
so no scan can see a half-scattered slab.

Transfer accounting: ``h2d_bytes`` / ``h2d_rows`` count the actual
host-to-device payload (scattered rows + scales + the row index).
Steady-state queries transfer nothing but the query batch.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.retrieval_topk.ops import (
    retrieval_topk_int4, retrieval_topk_int4_gathered,
    retrieval_topk_int4_rows)


class BankSnapshot(NamedTuple):
    """One published generation of the device bank."""
    packed: torch.Tensor   # (cap, E//2) int8
    scales: torch.Tensor   # (cap, 1) fp32
    n: int                 # valid rows; rows >= n are masked at query time
    uids: np.ndarray       # (n,) int64, row i -> uid, aligned with this epoch
    generation: int        # monotonically increasing refresh counter


class DeviceBank:
    """Device-resident int4 slab mirror (see module docstring)."""

    def __init__(self, embed_dim: int, *, device="cuda"):
        if embed_dim % 2:
            raise ValueError(f"int4 bank needs an even embed_dim, got "
                             f"{embed_dim}")
        self.embed_dim = embed_dim
        self.device = resolve_device(device)
        self._row_width = embed_dim // 2
        self._cap = 0
        self._packed: Optional[torch.Tensor] = None
        self._scales: Optional[torch.Tensor] = None
        self._published: Optional[BankSnapshot] = None
        self._gen = 0
        self.h2d_bytes = 0
        self.h2d_rows = 0
        self.n_syncs = 0
        self.n_grows = 0

    # -- state ---------------------------------------------------------------

    def __len__(self) -> int:
        st = self._published
        return 0 if st is None else st.n

    @property
    def capacity(self) -> int:
        return self._cap

    @property
    def published(self) -> Optional[BankSnapshot]:
        return self._published

    @property
    def generation(self) -> int:
        st = self._published
        return 0 if st is None else st.generation

    def stats(self) -> Dict[str, int]:
        return {"h2d_bytes": self.h2d_bytes, "h2d_rows": self.h2d_rows,
                "n_syncs": self.n_syncs, "n_grows": self.n_grows,
                "capacity": self._cap, "n": len(self), "n_shards": 1,
                "generation": self.generation,
                "device_bytes": 0 if self._packed is None else
                int(self._packed.nbytes + self._scales.nbytes)}

    # -- refresh -------------------------------------------------------------

    def _grow_to(self, cap: int) -> None:
        """Slab doubling on device: allocate the grown buffers and copy the
        old content device-to-device — never a host re-upload."""
        new_p = torch.zeros((cap, self._row_width), dtype=torch.int8,
                            device=self.device)
        new_s = torch.zeros((cap, 1), dtype=torch.float32, device=self.device)
        if self._cap:
            new_p[:self._cap].copy_(self._packed)
            new_s[:self._cap].copy_(self._scales)
            self.n_grows += 1
        self._packed, self._scales, self._cap = new_p, new_s, cap

    def sync(self, host_packed: np.ndarray, host_scales: np.ndarray, n: int,
             dirty_rows: np.ndarray,
             uids: Optional[np.ndarray] = None) -> BankSnapshot:
        """Bring the device slab up to date with the host slab and publish.
        ``dirty_rows`` are the row indices written since the last refresh —
        only those rows travel. The caller serializes refreshes and scans
        (the store holds its lock across both)."""
        if host_packed.shape[0] > self._cap:
            self._grow_to(int(host_packed.shape[0]))
        rows = np.asarray(dirty_rows, np.int64).ravel()
        if rows.size:
            vals = torch.from_numpy(np.ascontiguousarray(host_packed[rows]))
            scs = torch.from_numpy(np.ascontiguousarray(host_scales[rows]))
            idx = torch.from_numpy(rows)
            idx_d = idx.to(self.device)
            self._packed.index_copy_(0, idx_d, vals.to(self.device))
            self._scales.index_copy_(0, idx_d, scs.to(self.device))
            self.h2d_bytes += int(vals.nbytes + scs.nbytes + idx.nbytes)
            self.h2d_rows += int(rows.size)
        self._gen += 1
        uids = (np.zeros((int(n),), np.int64) if uids is None
                else np.asarray(uids, np.int64))
        self._published = BankSnapshot(self._packed, self._scales, int(n),
                                       uids, self._gen)
        self.n_syncs += 1
        return self._published

    # -- search --------------------------------------------------------------

    def _state(self, state: Optional[BankSnapshot]) -> BankSnapshot:
        state = self._published if state is None else state
        if state is None:
            raise RuntimeError("DeviceBank search before the first sync()")
        return state

    def _queries(self, queries: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(queries, np.float32)).to(self.device)

    def search(self, queries: np.ndarray, k: int,
               state: Optional[BankSnapshot] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused top-k over the device-resident bank: (Q, E) queries ->
        (row indices (Q, k) int64, scores (Q, k) fp32), descending score.
        Only the query batch travels host-to-device."""
        state = self._state(state)
        k = min(k, state.n)
        s, i = retrieval_topk_int4(self._queries(queries), state.packed,
                                   state.scales, k, normalize=False,
                                   n_valid=state.n)
        return i.cpu().numpy().astype(np.int64), s.cpu().numpy()

    def search_gathered(self, queries: np.ndarray, row_ids: np.ndarray,
                        k: int, state: Optional[BankSnapshot] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """IVF pruned scan, per-query strategy: top-k over each query's own
        candidate rows ``row_ids`` (Q, L) int32 (-1 padded) of one
        snapshot; ids past its fill are masked. Device work scales with L,
        not the bank size, and the kernel reads the candidates by id, so
        no gathered copy is made. Returns ((Q, k) GLOBAL row ids, (Q, k)
        scores); slots with no live candidate hold id -1 / score -1e30."""
        state = self._state(state)
        k = min(k, state.n)
        ids = torch.from_numpy(np.ascontiguousarray(row_ids, np.int32))
        s, i = retrieval_topk_int4_gathered(
            self._queries(queries), state.packed, state.scales,
            ids.to(self.device), k, normalize=False, n_valid=state.n)
        return i.cpu().numpy().astype(np.int64), s.cpu().numpy()

    def search_rows(self, queries: np.ndarray, rows: np.ndarray, k: int,
                    state: Optional[BankSnapshot] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """IVF pruned scan, batch-union strategy: one candidate-row set for
        the whole batch (the caller keeps ``rows`` < ``state.n``), gathered
        on the device and scanned by the exhaustive int4 kernel over
        ``len(rows)`` instead of ``n`` rows. Returns ((Q, k) GLOBAL row
        ids, (Q, k) scores). Requires k <= len(rows)."""
        state = self._state(state)
        rows = np.asarray(rows, np.int64)
        s, i = retrieval_topk_int4_rows(self._queries(queries), state.packed,
                                        state.scales, rows, k,
                                        normalize=False)
        return rows[i.cpu().numpy()], s.cpu().numpy()
