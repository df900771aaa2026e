"""Device-resident embedding bank: the searchable copy of the store's int4
slab, kept on the device and refreshed *incrementally*.

  * ``packed`` (cap, E//2) int8 + ``scales`` (cap, 1) fp32 live on the
    bank's device; queries run the fused dequant-and-scan
    ``retrieval_topk_int4`` (the CUDA kernel on a CUDA bank), so the fp32
    bank never exists in device memory;
  * a refresh moves ONLY the rows dirtied since the last one (``index_copy_``
    of the dirty rows' packed nibbles + scales; the host payload is just
    those rows), and grows by slab doubling *on device* in lockstep with
    the host slab (a device-to-device copy, no re-upload);
  * the IVF pruned scans read the same slab: ``search_rows`` (one candidate
    union for the batch) and ``search_gathered`` (per-query candidates).

Refresh protocol (shared by the sync path and the async scheduler of
``core.bank_refresh``): ``apply_rows`` builds a SHADOW snapshot (grown
buffers, or a device-side clone of the published ones, then the dirty-row
scatter) without touching the published state, and ``publish`` flips the
published pointer to it in one attribute write, with a new generation.
A published snapshot's tensors are never written again, so a scan pinned
to one (``state=``) needs no lock and sees exactly one generation.
Refreshes are serialized by ``refresh_lock`` (``sync`` takes it; the
scheduler holds it across apply + publish); scans never take it.

On a CUDA bank the refresh runs on a side stream: the pinned host payload
is copied and scattered there, and ``publish`` records an event on that
stream into the snapshot. A scan makes its own stream wait on that event
before it launches, and marks the snapshot's tensors as used by its stream
(``record_stream``), so the caching allocator cannot hand their memory to
the refresher while the scan still reads them. On the CPU the same phases
run inline.

Transfer accounting: ``h2d_bytes`` / ``h2d_rows`` count the actual
host-to-device payload (scattered rows + scales + the row index).
Steady-state queries transfer nothing but the query batch.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.retrieval_topk.ops import (
    retrieval_topk_int4, retrieval_topk_int4_gathered,
    retrieval_topk_int4_rows)


class BankSnapshot(NamedTuple):
    """One published generation of the device bank. Its tensors are never
    written after the flip, and ``uids`` is a private host copy."""
    packed: torch.Tensor   # (cap, E//2) int8
    scales: torch.Tensor   # (cap, 1) fp32
    n: int                 # valid rows; rows >= n are masked at query time
    uids: np.ndarray       # (n,) int64, row i -> uid, aligned with this epoch
    generation: int        # monotonically increasing flip counter
    # CUDA only: recorded on the refresh stream at the flip; scans wait on it
    ready: Optional[torch.cuda.Event] = None


class DeviceBank:
    """Device-resident int4 slab mirror (see module docstring)."""

    def __init__(self, embed_dim: int, *, device="cuda"):
        if embed_dim % 2:
            raise ValueError(f"int4 bank needs an even embed_dim, got "
                             f"{embed_dim}")
        self.embed_dim = embed_dim
        self.device = resolve_device(device)
        self._row_width = embed_dim // 2
        self._published: Optional[BankSnapshot] = None
        self._gen = 0
        self._stream: Optional[torch.cuda.Stream] = None
        # serializes whole refreshes (apply + publish) across callers: the
        # in-lock sync path and an async epoch must never mint generations
        # concurrently (each bases its shadow on the latest published
        # state; unserialized, one would drop the other's rows)
        self.refresh_lock = threading.RLock()
        self.h2d_bytes = 0
        self.h2d_rows = 0
        self.n_syncs = 0
        self.n_grows = 0
        self.n_warms = 0

    # -- state ---------------------------------------------------------------

    def __len__(self) -> int:
        st = self._published
        return 0 if st is None else st.n

    @property
    def capacity(self) -> int:
        """Rows of the published buffers (a grown shadow counts once it is
        published, so a failed grow epoch leaves it unchanged)."""
        st = self._published
        return 0 if st is None else int(st.packed.shape[0])

    @property
    def published(self) -> Optional[BankSnapshot]:
        """The live snapshot (atomic read; may lag the host in async
        mode)."""
        return self._published

    @property
    def generation(self) -> int:
        st = self._published
        return 0 if st is None else st.generation

    def stats(self) -> Dict[str, int]:
        st = self._published
        return {"h2d_bytes": self.h2d_bytes, "h2d_rows": self.h2d_rows,
                "n_syncs": self.n_syncs, "n_grows": self.n_grows,
                "capacity": self.capacity, "n": len(self), "n_shards": 1,
                "generation": self.generation,
                "device_bytes": 0 if st is None else
                int(st.packed.nbytes + st.scales.nbytes)}

    # -- refresh -------------------------------------------------------------

    def _refresh_stream(self):
        """The context the refresh's device work runs in: the bank's side
        stream on CUDA (made at first use), nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
        return torch.cuda.stream(self._stream)

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host rows -> the bank's device: staged through pinned memory and
        copied without blocking (on the refresh stream) on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _grow_to(self, base: Optional[BankSnapshot], cap: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Slab doubling on device: new buffers with the published rows
        copied device-to-device, never a host re-upload."""
        new_p = torch.zeros((cap, self._row_width), dtype=torch.int8,
                            device=self.device)
        new_s = torch.zeros((cap, 1), dtype=torch.float32, device=self.device)
        if base is not None:
            old = base.packed.shape[0]
            new_p[:old].copy_(base.packed)
            new_s[:old].copy_(base.scales)
        return new_p, new_s

    @staticmethod
    def _scatter(dst: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> None:
        dst.index_copy_(0, rows, vals)

    def apply_rows(self, host_cap: int, dirty_rows: np.ndarray,
                   vals: np.ndarray, scs: np.ndarray, n: int,
                   uids: np.ndarray) -> BankSnapshot:
        """Build the SHADOW snapshot: buffers grown to ``host_cap`` if the
        host slab doubled, else a device-side clone of the published ones
        (copy-on-write), then the dirty rows' payload scattered in
        (``vals``/``scs`` are host copies of those rows). The published
        state is untouched; ``publish`` flips it. Callers serialize
        refreshes (``refresh_lock``)."""
        base = self._published
        rows = np.asarray(dirty_rows, np.int64).ravel()
        grow = base is None or int(host_cap) > base.packed.shape[0]
        with self._refresh_stream():
            if grow:
                packed, scales = self._grow_to(base, int(host_cap))
            elif rows.size:
                packed, scales = base.packed.clone(), base.scales.clone()
            else:
                packed, scales = base.packed, base.scales
            if rows.size:
                idx = self._upload(rows)
                self._scatter(packed, idx, self._upload(vals))
                self._scatter(scales, idx, self._upload(scs))
        if rows.size:
            self.h2d_bytes += int(np.asarray(vals).nbytes +
                                  np.asarray(scs).nbytes + rows.nbytes)
            self.h2d_rows += int(rows.size)
        if grow and base is not None:
            self.n_grows += 1
        self._gen += 1
        return BankSnapshot(packed, scales, int(n),
                            np.asarray(uids, np.int64), self._gen)

    def publish(self, snap: BankSnapshot) -> BankSnapshot:
        """Atomically flip the published pointer to ``snap``; on CUDA first
        record the refresh stream's event into it. Generations must
        advance: an out-of-order flip means two refreshes ran concurrently
        and one dropped the other's rows."""
        cur = self._published
        if cur is not None and snap.generation <= cur.generation:
            raise RuntimeError(f"out-of-order flip: generation "
                               f"{snap.generation} after {cur.generation}; "
                               "refresh epochs must be serialized")
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(self._stream)
            snap = snap._replace(ready=ready)
        self._published = snap
        self.n_syncs += 1
        return snap

    def warm(self, state: BankSnapshot) -> bool:
        """Ready the scan for ``state`` before it is published. The CUDA
        kernels take any capacity without a rebuild, so this only makes
        sure the scan's library is built and loaded (a first scan would
        otherwise build it on the query path). False on the CPU."""
        if self.device.type != "cuda" or state.n == 0:
            return False
        from repro_torch.kernels import build
        build.load("topk_int4")
        self.n_warms += 1
        return True

    def sync(self, host_packed: np.ndarray, host_scales: np.ndarray, n: int,
             dirty_rows: np.ndarray,
             uids: Optional[np.ndarray] = None) -> BankSnapshot:
        """Fused apply + publish (the sync path): bring the device slab up
        to date with the host slab. ``dirty_rows`` are the row indices
        written since the last refresh; only those rows travel."""
        rows = np.asarray(dirty_rows, np.int64).ravel()
        uids = (np.zeros((int(n),), np.int64) if uids is None
                else np.asarray(uids, np.int64))
        with self.refresh_lock:
            return self.publish(self.apply_rows(
                host_packed.shape[0], rows, host_packed[rows],
                host_scales[rows], n, uids))

    # -- search --------------------------------------------------------------

    def _state(self, state: Optional[BankSnapshot]) -> BankSnapshot:
        """The snapshot to scan, ordered after its refresh on this
        thread's stream."""
        state = self._published if state is None else state
        if state is None:
            raise RuntimeError("DeviceBank search before the first sync()")
        if state.ready is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(state.ready)
            state.packed.record_stream(cur)
            state.scales.record_stream(cur)
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
