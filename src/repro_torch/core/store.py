"""Slab-backed embedding store: coarse embeddings + exit metadata + INT4
activation cache.

Host-side component of the serving runtime — the analogue of the paper's
on-flash store (§5.4). Embeddings live in contiguous growable slabs:

  * ``_packed``  (cap, E//2) int8  — two INT4 nibbles per byte (or (cap, E)
    fp32 rows with scales of 1 when ``store_int4=False``),
  * ``_scales``  (cap, 1)   fp32   — per-row absmax scales,
  * ``_meta``    (cap,) structured — uid / exit_idx / exit_layer / modality /
    fine,
  * ``_dense``   (cap, E)  fp32    — incrementally maintained dequantized
    matrix for the host paths: only rows dirtied since the last refresh are
    re-dequantized.

Capacity grows by amortized doubling; a uid->row hash index finds rows.
Inserts quantize embeddings on the host with ``quantize_int4_np``. Cached
activations handed over as a tensor are quantized where they lie (on a
CUDA device by the int4_cache kernel; only the packed bytes and scales come
to the host); numpy activations take ``quantize_int4_np`` as in the
reference. The activation cache itself stays host-resident. ``search_batch`` is
the serving hot path: on a store that lives on a CUDA device,
``impl='auto'`` resolves to the device-resident bank (``core.device_bank``,
row-sharded over every visible card by default), refreshed from a
dirty-row bitmap and scanned by the fused dequant-top-k kernel (the dense
kernel in fp32 mode), and to the IVF pruned scan once an
attached index (``attach_ivf``) is trained and the store holds its
``min_rows``; a store the caller put on the CPU resolves to the numpy
matmul path. Queried items are permanently upgraded to their fine-grained
embeddings (§5.3) via ``upgrade_batch``.

The device bank refreshes in sync mode (under the store lock on the query
path, the default) or in async mode (``set_bank_refresh("async")``:
epochs outside the lock, ``core.bank_refresh``), where queries serve a
published generation within the configured staleness bounds.

The IVF index (``index.ivf``) follows every mutation under the store lock
(``add_batch`` trains then assigns, ``upgrade_batch`` re-assigns,
``delete_batch`` mirrors the swap-with-last); its re-cluster jobs run in
three phases whose middle one holds no lock (``ivf_maybe_recluster``,
inline on the sync query path, on the refresh thread in async mode).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

import torch

from repro_torch import resolve_device
from repro_torch.core.quantize import dequantize_int4_np, quantize_int4_np
from repro_torch.kernels.int4_cache import ops as int4_ops
from repro_torch.kernels.retrieval_topk.ops import retrieval_topk
from repro_torch.tracing import span

_META_DTYPE = np.dtype([("uid", np.int64), ("exit_idx", np.int32),
                        ("exit_layer", np.int32), ("fine", np.bool_),
                        ("modality_id", np.int32)])  # index into _modalities


@dataclasses.dataclass
class StoreEntry:
    """A row's metadata, materialized on demand from the meta slab."""
    uid: int
    exit_idx: int          # index into the exit list (not the layer number)
    exit_layer: int        # layer depth of the coarse embedding
    modality: str
    fine: bool             # already refined to full depth?


def _empty(nq: int) -> Tuple[np.ndarray, np.ndarray]:
    return np.zeros((nq, 0), np.int64), np.zeros((nq, 0), np.float32)


class EmbeddingStore:
    def __init__(self, embed_dim: int, store_int4: bool = True,
                 capacity: int = 64, *, device="cuda"):
        if store_int4 and embed_dim % 2:  # fp32 rows need no even width
            raise ValueError(f"int4 packing needs an even embed_dim, got "
                             f"{embed_dim}")
        self.embed_dim = embed_dim
        self.store_int4 = store_int4
        self.device = resolve_device(device)
        self._row_width = embed_dim // 2 if store_int4 else embed_dim
        self._row_dtype = np.int8 if store_int4 else np.float32
        self._cap = max(int(capacity), 1)
        self._n = 0
        self._packed = np.zeros((self._cap, self._row_width), self._row_dtype)
        self._scales = np.ones((self._cap, 1), np.float32)
        self._meta = np.zeros(self._cap, _META_DTYPE)
        self._dense = np.zeros((self._cap, embed_dim), np.float32)
        self._dirty = np.zeros(self._cap, np.bool_)
        self._any_dirty = False
        # second dirty bitmap, consumed by the device bank's refresh (the
        # dense cache and the bank sync independently)
        self._bank_dirty = np.zeros(self._cap, np.bool_)
        self._any_bank_dirty = False
        self._bank = None  # DeviceBank, created lazily / via attach
        # bounded-staleness accounting for the async refresh: distinct rows
        # dirty but unpublished, and since when
        self._bank_pending_rows = 0
        self._bank_first_dirty_t: Optional[float] = None
        self._bank_refresher = None  # RefreshScheduler in async mode
        # online IVF coarse-filter index (attach_ivf); mutations keep its
        # assignment/posting lists in lockstep under this same lock
        self._ivf = None
        self.ivf_fallbacks = 0  # impl='ivf' queries served exhaustively
        # fp32 slab uploads of the dense kernel path (impl 'pallas'/'xla'),
        # the bytes the int4 device bank exists to avoid
        self.upload_bytes = 0
        self.upload_calls = 0
        # packed activation bytes + scales copied from a device to the host
        self.act_d2h_bytes = 0
        self._escaped_n = 0  # rows visible to views handed out to readers
        self._uid_to_row: Dict[int, int] = {}
        self._modalities: List[str] = [""]  # interned names; id 0 = unset
        # (packed, scale, shape, exit_layer) per uid; packed is (S, d//2) int8
        self._act_cache: Dict[int, Tuple[np.ndarray, np.ndarray,
                                         Tuple[int, ...], int]] = {}
        self._lock = threading.RLock()

    def _modality_id_locked(self, name: str) -> int:
        try:
            return self._modalities.index(name)
        except ValueError:
            self._modalities.append(name)
            return len(self._modalities) - 1

    # -- capacity ------------------------------------------------------------

    def _ensure_capacity(self, n_needed: int) -> None:
        if n_needed <= self._cap:
            return
        cap = self._cap
        while cap < n_needed:
            cap *= 2
        for name in ("_packed", "_scales", "_meta", "_dense", "_dirty",
                     "_bank_dirty"):
            old = getattr(self, name)
            new = np.zeros((cap,) + old.shape[1:], old.dtype)
            new[:self._n] = old[:self._n]
            setattr(self, name, new)
        self._cap = cap
        self._escaped_n = 0  # the fresh dense buffer has no outside readers
        if self._ivf is not None:
            self._ivf.ensure_capacity(cap)

    def _quantize_rows(self, embs: np.ndarray) -> Tuple[np.ndarray,
                                                        np.ndarray]:
        """(B, E) fp32 -> (slab rows, scales) on the host:
        ``quantize_int4_np`` in int4 mode, the rows and scales of 1 in fp32
        mode."""
        if self.store_int4:
            return quantize_int4_np(embs)
        return embs, np.ones((len(embs), 1), np.float32)

    # -- mutation ------------------------------------------------------------

    def add(self, uid: int, emb: np.ndarray, *, exit_idx: int, exit_layer: int,
            modality: str = "", fine: bool = False, cached_h=None) -> None:
        """One-row ``add_batch``; ``cached_h`` is numpy or a tensor."""
        if cached_h is not None and not isinstance(cached_h, torch.Tensor):
            cached_h = np.asarray(cached_h, np.float32)
        self.add_batch([uid], np.asarray(emb, np.float32)[None],
                       [exit_idx], [exit_layer], modality=modality, fine=fine,
                       cached_hs=None if cached_h is None else cached_h[None])

    def _quantize_activations(self, hs) -> Tuple[np.ndarray, np.ndarray,
                                                 Tuple[int, ...]]:
        """(B, ..., d) activations -> host (packed, scales, per-item shape).
        A tensor is quantized where it lies (``int4_cache.ops``: the kernel
        on a CUDA device, the plain version on the CPU) and only the packed
        bytes and scales leave the device; numpy takes
        ``quantize_int4_np``. Both give the same bits."""
        if not isinstance(hs, torch.Tensor):
            with span("store.quantize_acts"):
                ch = np.asarray(hs, np.float32)
                return (*quantize_int4_np(ch), tuple(ch.shape[1:]))
        with span("store.quantize_acts"):
            p, s = int4_ops.quantize(hs)
        with span("store.acts_to_host"):
            p, s = p.cpu().numpy(), s.cpu().numpy()
        if hs.device.type != "cpu":
            self.act_d2h_bytes += int(p.nbytes + s.nbytes)
        return p, s, tuple(hs.shape[1:])

    def add_batch(self, uids, embs, exit_idxs, exit_layers, *, modality="",
                  fine: bool = False, cached_hs=None) -> None:
        """Vectorized insert: one quantize call for the embedding batch and
        (optionally) one for the activation batch (numpy or a tensor, see
        ``_quantize_activations``). Re-adding an existing uid overwrites its
        row in place (last write wins)."""
        with span("store.add_batch"):
            uids = np.asarray(uids, np.int64).ravel()
            embs = np.asarray(embs, np.float32).reshape(len(uids),
                                                        self.embed_dim)
            with span("store.quantize_rows"):
                packed, scales = self._quantize_rows(embs)
            act = (None if cached_hs is None
                   else self._quantize_activations(cached_hs))
            exit_idxs = np.asarray(exit_idxs, np.int32).ravel()
            exit_layers = np.asarray(exit_layers, np.int32).ravel()
            with span("store.insert"), self._lock:
                mod_id = self._modality_id_locked(modality)
                rows = np.empty(len(uids), np.int64)
                nxt = self._n
                for j, u in enumerate(uids.tolist()):
                    row = self._uid_to_row.get(u)
                    if row is None:
                        row = nxt
                        nxt += 1
                        self._uid_to_row[u] = row
                    elif act is None:
                        # re-add without fresh activations: evict the previous
                        # content's cache so refinement can't resume from it
                        self._act_cache.pop(u, None)
                    rows[j] = row
                self._ensure_capacity(nxt)
                self._packed[rows] = packed
                self._scales[rows] = scales
                self._meta["uid"][rows] = uids
                self._meta["exit_idx"][rows] = exit_idxs
                self._meta["exit_layer"][rows] = exit_layers
                self._meta["modality_id"][rows] = mod_id
                self._meta["fine"][rows] = fine
                self._dirty[rows] = True
                self._any_dirty = True
                self._mark_bank_dirty_locked(rows)
                if act is not None:
                    ap, ascale, shape = act
                    for j, u in enumerate(uids.tolist()):
                        self._act_cache[u] = (ap[j], ascale[j], shape,
                                              int(exit_layers[j]))
                self._n = nxt
                if self._ivf is not None:  # train then assign, one argmin each
                    self._ivf.observe(embs)
                    self._ivf.assign_rows(rows, embs, nxt)

    def upgrade(self, uid: int, fine_emb: np.ndarray) -> None:
        """Permanently replace a coarse embedding with its refined one."""
        self.upgrade_batch([uid], np.asarray(fine_emb, np.float32)[None])

    def upgrade_batch(self, uids: Sequence[int], fine_embs: np.ndarray) -> None:
        """Vectorized §5.3 upgrade: requantize the batch in one call, mark
        only the touched rows dirty, free their activation cache."""
        uids = np.asarray(uids, np.int64).ravel()
        if uids.size == 0:
            return
        embs = np.asarray(fine_embs, np.float32).reshape(len(uids),
                                                         self.embed_dim)
        packed, scales = self._quantize_rows(embs)
        with self._lock:
            rows = self._rows_of_locked(uids)
            self._packed[rows] = packed
            self._scales[rows] = scales
            self._meta["fine"][rows] = True
            self._dirty[rows] = True
            self._any_dirty = True
            self._mark_bank_dirty_locked(rows)
            if self._ivf is not None:  # content changed -> cluster may too
                self._ivf.assign_rows(rows, embs, self._n)
            for u in uids.tolist():
                self._act_cache.pop(u, None)  # §3.4: storage freed once refined

    def delete(self, uid: int) -> None:
        self.delete_batch([uid])

    def delete_batch(self, uids: Sequence[int]) -> None:
        """Remove uids, keeping the slab dense: each deleted row is filled by
        swapping the current last row down, so the scan paths stay a
        contiguous [0, n) range. The moved row is marked dirty in both
        bitmaps; the vacated tail rows are masked everywhere by the shrunken
        ``n``. Raises KeyError (before mutating anything) if any uid is
        absent."""
        uids = list(dict.fromkeys(int(u) for u in np.asarray(uids,
                                                             np.int64).ravel()))
        if not uids:
            return
        with self._lock:
            self._rows_of_locked(np.asarray(uids, np.int64))  # validate all
            for u in uids:
                row = self._uid_to_row.pop(u)
                self._act_cache.pop(u, None)
                last = self._n - 1
                if row != last:
                    self._packed[row] = self._packed[last]
                    self._scales[row] = self._scales[last]
                    self._meta[row] = self._meta[last]
                    self._uid_to_row[int(self._meta["uid"][row])] = row
                    self._dirty[row] = True
                    self._any_dirty = True
                    self._mark_bank_dirty_locked(np.array([row], np.int64))
                # the vacated tail slot must not leak into the next refresh
                self._dirty[last] = False
                self._unmark_bank_dirty_locked(last)
                self._n = last
                if self._ivf is not None:  # assignment swaps with the row
                    self._ivf.on_delete(row, last)

    # -- index ---------------------------------------------------------------

    def _rows_of_locked(self, uids: np.ndarray) -> np.ndarray:
        try:
            return np.fromiter((self._uid_to_row[int(u)] for u in uids),
                               np.int64, len(uids))
        except KeyError as e:
            raise KeyError(f"uid {e.args[0]} not in store") from None

    def rows_of(self, uids) -> np.ndarray:
        with self._lock:
            return self._rows_of_locked(np.asarray(uids, np.int64).ravel())

    def contains(self, uids) -> np.ndarray:
        """(len(uids),) bool mask of uids currently in the store."""
        uids = np.asarray(uids, np.int64).ravel()
        with self._lock:
            idx = self._uid_to_row
            return np.fromiter((int(u) in idx for u in uids), np.bool_,
                               len(uids))

    def row_of(self, uid: int) -> int:
        with self._lock:
            return self._uid_to_row[int(uid)]

    def __len__(self) -> int:
        return self._n

    def uids(self) -> np.ndarray:
        with self._lock:
            return self._meta["uid"][:self._n].copy()

    def is_fine(self, uids) -> np.ndarray:
        with self._lock:
            return self._meta["fine"][self._rows_of_locked(
                np.asarray(uids, np.int64).ravel())].copy()

    @property
    def n_fine(self) -> int:
        with self._lock:
            return int(self._meta["fine"][:self._n].sum())

    @property
    def entries(self) -> List[StoreEntry]:
        """Every row's metadata as ``StoreEntry`` objects (O(N); changing
        them does not write back)."""
        with self._lock:
            m = self._meta[:self._n]
            return [StoreEntry(int(r["uid"]), int(r["exit_idx"]),
                               int(r["exit_layer"]),
                               self._modalities[int(r["modality_id"])],
                               bool(r["fine"])) for r in m]

    # -- access --------------------------------------------------------------

    def _refresh_dense_locked(self) -> None:
        """Dequantize only rows touched since the last refresh; copy-on-write
        first if a view handed to a reader covers a dirtied row."""
        if not self._any_dirty:
            return
        rows = np.nonzero(self._dirty[:self._n])[0]
        if rows.size:
            if self._escaped_n and (rows < self._escaped_n).any():
                self._dense = self._dense.copy()
                self._escaped_n = 0
            self._dense[rows] = (
                dequantize_int4_np(self._packed[rows], self._scales[rows])
                if self.store_int4 else self._packed[rows])
        self._dirty[:self._n] = False
        self._any_dirty = False

    def dense_matrix(self) -> np.ndarray:
        """(N, E) fp32 dequantized rows: a read-only snapshot view."""
        with self._lock:
            self._refresh_dense_locked()
            self._escaped_n = max(self._escaped_n, self._n)
            v = self._dense[:self._n]
            v.setflags(write=False)
            return v

    def get_embeddings(self, uids) -> np.ndarray:
        """(len(uids), E) fp32 dequantized rows — a lock-consistent copy."""
        uids = np.asarray(uids, np.int64).ravel()
        with self._lock:
            if uids.size == 0:
                return np.zeros((0, self.embed_dim), np.float32)
            self._refresh_dense_locked()
            return self._dense[self._rows_of_locked(uids)].copy()

    def _cached_packed(self, uids) -> Dict[int, Tuple[np.ndarray, np.ndarray,
                                                      Tuple[int, ...], int]]:
        """{uid: (packed, scales, shape, layer)} of the cached activations,
        still quantized: the refinement hook dequantizes them where it runs
        the continuation."""
        with self._lock:
            return {int(u): self._act_cache[int(u)] for u in uids
                    if int(u) in self._act_cache}

    def cached_activation(self, uid: int) -> Optional[Tuple[np.ndarray, int]]:
        """The dequantized cached hidden state (h, exit_layer), or None."""
        return self.cached_activations([uid]).get(int(uid))

    def has_cached(self, uid: int) -> bool:
        with self._lock:
            return int(uid) in self._act_cache

    def cached_activations(self, uids) -> Dict[int, Tuple[np.ndarray, int]]:
        """Batched host dequant of cached activations, one call per distinct
        activation shape. Returns {uid: (h, layer)}."""
        by_shape: Dict[Tuple[int, ...], list] = {}
        for u, (p, s, shape, layer) in self._cached_packed(uids).items():
            by_shape.setdefault(shape, []).append((u, p, s, layer))
        out: Dict[int, Tuple[np.ndarray, int]] = {}
        for shape, group in by_shape.items():
            hs = dequantize_int4_np(np.stack([g[1] for g in group]),
                                    np.stack([g[2] for g in group]))
            for (u, _, _, layer), h in zip(group, hs):
                out[u] = (h.reshape(shape), layer)
        return out

    # -- device bank ---------------------------------------------------------

    def _mark_bank_dirty_locked(self, rows: np.ndarray) -> None:
        """Record freshly dirtied bank rows, keeping the staleness counters
        exact (distinct rows; the time of the oldest unpublished write),
        and wake the async refresher, if any."""
        rows = np.unique(rows)  # a batch may hit one row twice (dup uids)
        fresh = int(np.count_nonzero(~self._bank_dirty[rows]))
        self._bank_dirty[rows] = True
        self._any_bank_dirty = True
        if fresh:
            self._bank_pending_rows += fresh
            if self._bank_first_dirty_t is None:
                self._bank_first_dirty_t = time.monotonic()
        ref = self._bank_refresher
        if ref is not None:
            ref.notify()

    def _unmark_bank_dirty_locked(self, row: int) -> None:
        if self._bank_dirty[row]:
            self._bank_dirty[row] = False
            self._bank_pending_rows -= 1
            if self._bank_pending_rows == 0:
                # nothing pending: the next write must not inherit this age
                self._bank_first_dirty_t = None

    def _take_bank_dirty_locked(self) -> np.ndarray:
        """Consume the dirty slice for one refresh: rows dirtied after this
        call belong to the next one. Resets the staleness counters."""
        if self._any_bank_dirty:  # steady-state queries skip the O(N) scan
            rows = np.nonzero(self._bank_dirty[:self._n])[0]
            self._bank_dirty[:self._n] = False
            self._any_bank_dirty = False
        else:
            rows = np.zeros((0,), np.int64)
        self._bank_pending_rows = 0
        self._bank_first_dirty_t = None
        return rows

    def _requeue_bank_rows(self, rows: np.ndarray) -> None:
        """Put a consumed dirty slice back (a refresh epoch failed after its
        begin): the rows must land in a later epoch, not vanish."""
        with self._lock:
            live = np.asarray(rows, np.int64)
            live = live[live < self._n]
            if live.size:
                self._mark_bank_dirty_locked(live)

    def attach_device_bank(self, devices=None):
        """Create (or replace) the device-resident searchable bank, its
        rows sharded across ``devices`` (a list; one shard an entry, and an
        entry may repeat). The default is every visible card for a CUDA
        store, one shard on the CPU for a CPU store. Existing rows are
        marked for upload on the next sync; after that only dirty rows
        travel. Returns the bank (``core.device_bank``)."""
        from repro_torch.core.device_bank import DeviceBank
        if devices is None:
            devices = ([torch.device("cuda", i)
                        for i in range(torch.cuda.device_count())]
                       if self.device.type == "cuda" else [self.device])
        with self._lock:
            self._bank = DeviceBank(self.embed_dim,
                                    store_int4=self.store_int4,
                                    devices=devices)
            if self._n:
                self._mark_bank_dirty_locked(np.arange(self._n))
            return self._bank

    @property
    def device_bank(self):
        """The attached DeviceBank, or None."""
        return self._bank

    @property
    def bank_refresher(self):
        """The async RefreshScheduler, or None in sync mode."""
        return self._bank_refresher

    def set_bank_refresh(self, mode: str = "sync", *,
                         max_lag_rows: Optional[int] = None,
                         max_lag_ms: Optional[float] = None,
                         thread: bool = True, **scheduler_kw):
        """Choose the device-bank refresh policy.

        ``"sync"`` (default): every device query brings the bank exactly up
        to date under the store lock first; tears down an async scheduler
        (draining its pending rows into one last flip).

        ``"async"``: refresh runs as epochs outside the lock
        (``core.bank_refresh``), on a background thread unless
        ``thread=False`` (then the caller steps the returned scheduler).
        Queries serve the published, possibly lagging, snapshot while the
        dirt stays within ``max_lag_rows`` / ``max_lag_ms`` (None =
        unbounded, 0 = fresh-blocking) and block for a refresh otherwise.
        Returns the scheduler (async) or None (sync)."""
        from repro_torch.core.bank_refresh import RefreshScheduler
        if mode not in ("sync", "async"):
            raise ValueError(mode)
        old = self._bank_refresher
        if old is not None:
            # drain while queries still route through the scheduler; the
            # bank's refresh_lock serializes it against a sync refresh
            old.stop(drain=True)
            self._bank_refresher = None
        if mode == "sync":
            return None
        ref = RefreshScheduler(self, max_lag_rows=max_lag_rows,
                               max_lag_ms=max_lag_ms, thread=thread,
                               **scheduler_kw)
        self._bank_refresher = ref
        return ref

    def kick_bank_refresh(self) -> bool:
        """Hint that now is a good moment to refresh (right after a drain,
        so the scatter hides behind host work instead of landing on the
        first query). No-op in sync mode."""
        ref = self._bank_refresher
        if ref is None:
            return False
        ref.notify()
        return True

    def _sync_bank_locked(self):
        """In-lock refresh (sync mode): move only the dirty rows and
        publish. Returns (bank, snapshot), the point the scan is pinned
        to."""
        if self._bank is None:
            self.attach_device_bank()
        bank = self._bank
        rows = self._take_bank_dirty_locked()
        snap = bank.sync(self._packed, self._scales, self._n, rows,
                         self._meta["uid"][:self._n].copy())
        return bank, snap

    # -- IVF coarse-filter index ---------------------------------------------

    def attach_ivf(self, *, n_clusters: int = 64, nprobe: int = 8,
                   min_rows: int = 32_768, seed: int = 0, **kw):
        """Create (or replace) the online IVF coarse-filter index
        (``index.ivf``). Existing rows seed the centroids and are assigned
        at once when there are enough of them; otherwise training starts
        from the insert stream. ``search_batch`` gains ``impl='ivf'`` (the
        pruned scan over the device bank), and ``'auto'`` on a CUDA store
        cuts over to it once the store holds ``min_rows`` rows. Returns
        the index. Needs the int4 slab (the pruned scans are int4 kernels)."""
        from repro_torch.index.ivf import IVFIndex
        if not self.store_int4:
            raise ValueError("IVF pruned search needs store_int4=True")
        with self._lock:
            idx = IVFIndex(self.embed_dim, n_clusters=n_clusters,
                           nprobe=nprobe, min_rows=min_rows, seed=seed, **kw)
            idx.ensure_capacity(self._cap)
            if self._n:
                self._refresh_dense_locked()
                if self._n >= n_clusters:
                    idx.init_from(self._dense[:self._n])
                else:  # too few rows to seed: buffer them as training data
                    idx.observe(self._dense[:self._n])
                idx.assign_rows(np.arange(self._n), self._dense[:self._n],
                                self._n)
            self._ivf = idx
            return idx

    @property
    def ivf_index(self):
        """The attached IVFIndex, or None."""
        return self._ivf

    def ivf_recluster_begin(self):
        """Phase 1 of a re-cluster job: take the index's recluster lock
        (non-blocking: one job in flight at a time), check the trigger, and
        snapshot under the store lock. Returns a ``ReclusterJob`` or None
        (no index / too few rows / no trigger / a job already running).
        The caller MUST finish with ``ivf_recluster_commit`` or
        ``ivf_recluster_abort``."""
        idx = self._ivf
        if idx is None or not idx.recluster_lock.acquire(blocking=False):
            return None
        try:
            with self._lock:
                if not idx.trained:
                    # late init: the index was attached before enough rows
                    # existed and inserts never filled its buffer. Seed from
                    # a bounded subsample (this holds the store lock); the
                    # unassigned-rows trigger then fires this job, whose
                    # unlocked compute phase assigns the whole corpus
                    if self._n < idx.n_clusters:
                        idx.recluster_lock.release()
                        return None
                    self._refresh_dense_locked()
                    m = min(self._n,
                            max(idx.n_clusters + 1,
                                int(idx.n_clusters * idx.init_oversample)))
                    sel = (np.arange(self._n) if m == self._n else
                           idx._rng.choice(self._n, m, replace=False))
                    idx.init_from(self._dense[sel])
                if not idx.needs_recluster():
                    idx.recluster_lock.release()
                    return None
                # COW view: rows < n stay stable while compute runs unlocked
                self._refresh_dense_locked()
                self._escaped_n = max(self._escaped_n, self._n)
                return idx.begin_recluster(self._dense)
        except BaseException:
            idx.recluster_lock.release()
            raise

    def ivf_recluster_commit(self, job) -> None:
        """Phase 3: apply the computed assignment under the store lock and
        release the job lock. Targets the index the job belongs to
        (``job.owner``): if ``attach_ivf`` replaced it mid-job, the result
        is dropped."""
        idx = job.owner
        try:
            with self._lock:
                if idx is self._ivf:
                    idx.commit_recluster(job, self._n)
                else:
                    idx.abort_recluster()
        finally:
            idx.recluster_lock.release()

    def ivf_recluster_abort(self, job) -> None:
        idx = job.owner
        try:
            with self._lock:
                idx.abort_recluster()
        finally:
            idx.recluster_lock.release()

    def ivf_maybe_recluster(self) -> bool:
        """Run one whole re-cluster job if the index wants one: begin ->
        unlocked O(n·C) argmin -> commit. The sync ``impl='ivf'`` query
        path calls it inline, as it pays the bank refresh inline; in async
        mode the refresh thread runs it after each epoch."""
        from repro_torch.index.ivf import IVFIndex
        job = self.ivf_recluster_begin()
        if job is None:
            return False
        try:
            IVFIndex.compute_assignments(job)  # no locks held
        except BaseException:
            self.ivf_recluster_abort(job)
            raise
        self.ivf_recluster_commit(job)
        return True

    # -- search --------------------------------------------------------------

    def _search_snapshot(self) -> Tuple[np.ndarray, int, np.ndarray]:
        """(full dense slab, row count, uid copy) taken under the lock; the
        numpy scan runs outside it (copy-on-write keeps the view whole)."""
        with self._lock:
            self._refresh_dense_locked()
            self._escaped_n = max(self._escaped_n, self._n)
            return (self._dense, self._n,
                    self._meta["uid"][:self._n].copy())

    def search(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k by inner product (numpy path): (uids, scores)."""
        q = np.asarray(query, np.float32)
        if self._n == 0:
            return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
        slab, n, uids = self._search_snapshot()
        scores = slab[:n] @ q
        k = min(k, n)
        idx = np.argpartition(-scores, k - 1)[:k]
        idx = idx[np.argsort(-scores[idx])]
        return uids[idx], scores[idx]

    def resolve_impl(self, impl: str) -> str:
        """``'auto'`` follows the device the caller put the store on: numpy
        for the CPU; for CUDA the IVF pruned scan once an attached index is
        trained and the store holds its ``min_rows``, the device bank's
        exhaustive scan below that."""
        if impl != "auto":
            return impl
        if self.device.type == "cpu":
            return "numpy"
        if self._ivf is not None and self._ivf.searchable(self._n):
            return "ivf"
        return "device"

    def search_batch(self, queries: np.ndarray, k: int, *, impl: str = "auto",
                     freshness: Optional[str] = None,
                     nprobe: Optional[int] = None, strategy: str = "union"
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused batched top-k over the whole store: queries (Q, E) ->
        (uids (Q, k), scores (Q, k)), both sorted by descending score; raw
        inner products. ``impl``:

          * ``'device'``: the int4 device bank (incremental refresh, fused
            dequant scan);
          * ``'ivf'``: the coarse-filtered pruned scan over the device bank
            (needs ``attach_ivf``); a query returns the exact top-k of its
            probed clusters, and slots past its live candidate count hold
            uid -1 / score -1e30. ``nprobe`` overrides the index's default
            (ignored by the other impls); ``strategy`` is ``'union'`` (one
            shared candidate union, the exhaustive kernel) or
            ``'gathered'`` (each query's own candidates, the gathered
            kernel);
          * ``'pallas'`` / ``'xla'``: the dense fp32 kernel over the host
            slab, uploaded per call (``upload_bytes``/``upload_calls``);
            the reference's two names compute the same function;
          * ``'numpy'``: host matmul + argpartition;
          * ``'auto'``: see ``resolve_impl``.

        ``freshness`` applies to the device and ivf paths under the async
        refresh policy: None obeys the configured staleness bounds,
        ``"fresh"`` blocks for a refresh, ``"stale"`` serves the published
        generation as is. In sync mode every device query is exact and
        ``freshness`` is ignored, as in the reference."""
        impl = self.resolve_impl(impl)
        if impl not in ("device", "ivf", "numpy", "pallas", "xla"):
            raise ValueError(f"search impl {impl!r}")
        queries = np.asarray(queries, np.float32).reshape(-1, self.embed_dim)
        nq = len(queries)
        if self._n == 0 or nq == 0:
            return _empty(nq)
        if impl == "ivf":
            return self._search_ivf(queries, k, freshness=freshness,
                                    nprobe=nprobe, strategy=strategy)
        if impl == "device":
            ref = self._bank_refresher
            if ref is not None:
                # async: no store lock across the refresh; the scheduler
                # hands back a published generation
                bank, snap, _ = self._async_bank_coherent(ref, freshness)
            else:
                with self._lock:
                    bank, snap = self._sync_bank_locked()
            if snap.n == 0:
                return _empty(nq)
            # the scan runs outside the lock, pinned to the refresh-point
            # bank and snapshot (never written again), so row indices stay
            # aligned with the snapshot's uid copy
            idx, top_s = bank.search(queries, min(k, snap.n), state=snap)
            return snap.uids[idx], top_s
        slab, n, uids = self._search_snapshot()
        k = min(k, n)
        if impl == "numpy":
            scores = queries @ slab[:n].T                       # (Q, N)
            idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
            part = np.take_along_axis(scores, idx, axis=1)
            order = np.argsort(-part, axis=1)
            idx = np.take_along_axis(idx, order, axis=1)
            top_s = np.take_along_axis(part, order, axis=1)
            return uids[idx], top_s
        # the whole capacity slab + a row count, as the reference hands its
        # kernel; the upload is what the device bank avoids
        self.upload_bytes += int(slab.nbytes)
        self.upload_calls += 1
        s, i = retrieval_topk(torch.from_numpy(queries).to(self.device),
                              torch.from_numpy(slab).to(self.device), k,
                              normalize=False, n_valid=n)
        return uids[i.cpu().numpy().astype(np.int64)], s.cpu().numpy()

    def _async_bank_coherent(self, ref, freshness: Optional[str],
                             cand_fn=None):
        """A coherent (bank, snapshot, candidates) triple on the async query
        path, without holding the store lock across a (possibly blocking)
        refresh: the snapshot must belong to the bank the scan runs on, and
        a concurrent ``attach_device_bank`` swaps ``self._bank``. Banks are
        never reused, so seeing ``self._bank is bank`` under the lock after
        taking the snapshot proves no swap happened; ``cand_fn`` (candidate
        building) runs in that same lock hold. After 8 lost races the
        in-lock sync refresh serves the query (the bank's refresh_lock
        serializes it against an in-flight epoch)."""
        for _ in range(8):
            bank = self._bank
            snap = ref.snapshot_for_query(freshness)
            with self._lock:
                if bank is not None and self._bank is bank:
                    return bank, snap, (None if cand_fn is None
                                        else cand_fn())
        with self._lock:
            bank, snap = self._sync_bank_locked()
            return bank, snap, (None if cand_fn is None else cand_fn())

    def _ivf_candidates_locked(self, queries, k, nprobe, strategy):
        if not self._ivf.trained:
            return None
        if strategy == "union":
            return self._ivf.candidate_union(queries, nprobe=nprobe)
        return self._ivf.candidate_rows(queries, k, nprobe=nprobe)

    def _search_ivf(self, queries: np.ndarray, k: int, *,
                    freshness: Optional[str], nprobe: Optional[int],
                    strategy: str) -> Tuple[np.ndarray, np.ndarray]:
        """IVF pruned scan over the device bank (see ``search_batch``).
        Sync mode runs a due re-cluster job first, inline, then takes the
        bank refresh and the candidates in one lock hold, so they agree
        exactly. Async mode leaves re-clustering to the refresh thread and
        pairs the snapshot with the candidates through
        ``_async_bank_coherent``; the posting lists may then run ahead of a
        stale generation: candidate ids past ``snap.n`` are dropped
        (union) or masked by the kernel (gathered). An untrained index, or
        a batch whose probed clusters are all empty, is served by the
        exhaustive scan and counted in ``ivf_fallbacks``."""
        if self._ivf is None:
            raise ValueError("impl='ivf' requires attach_ivf() first")
        if strategy not in ("union", "gathered"):
            raise ValueError(f"ivf strategy={strategy!r}")
        nq = len(queries)
        ref = self._bank_refresher
        cand_fn = (lambda: self._ivf_candidates_locked(queries, k, nprobe,
                                                       strategy))
        if ref is None:
            self.ivf_maybe_recluster()
            with self._lock:
                bank, snap = self._sync_bank_locked()
                cand = cand_fn()
        else:
            bank, snap, cand = self._async_bank_coherent(ref, freshness,
                                                         cand_fn)
        if snap.n == 0:
            return _empty(nq)
        k = min(k, snap.n)
        if strategy == "union" and cand is not None:
            cand = cand[cand < snap.n]  # postings ahead of a stale snapshot
        if cand is None or cand.size == 0:
            self.ivf_fallbacks += 1
            ridx, top_s = bank.search(queries, k, state=snap)
            return snap.uids[ridx], top_s
        if strategy == "union":
            k2 = min(k, int(cand.size))
            rows, top_s = bank.search_rows(queries, cand, k2, state=snap)
            # a sharded merge can surface sentinel slots (a shard short of
            # candidates); they map to uid -1, as on the gathered path
            live = top_s > -5e29
            uids = np.where(live, snap.uids[np.clip(rows, 0, snap.n - 1)],
                            -1)
            if k2 < k:  # union smaller than k: pad with the sentinel
                uids = np.pad(uids, ((0, 0), (0, k - k2)),
                              constant_values=-1)
                top_s = np.pad(top_s, ((0, 0), (0, k - k2)),
                               constant_values=-1e30)
            return uids, top_s
        rows, top_s = bank.search_gathered(queries, cand, k, state=snap)
        live = top_s > -5e29  # the kernel's sentinel for dead slots
        return np.where(live, snap.uids[np.clip(rows, 0, snap.n - 1)],
                        -1), top_s

    # -- accounting ----------------------------------------------------------

    def storage_bytes(self) -> Dict[str, int]:
        with self._lock:
            emb = int(self._packed[:self._n].nbytes +
                      self._scales[:self._n].nbytes)
            act = sum(p.nbytes + s.nbytes
                      for p, s, _, _ in self._act_cache.values())
            return {"embeddings": emb, "act_cache": act, "total": emb + act,
                    "per_item": emb // max(self._n, 1)}

    def exit_histogram(self, n_exits: int) -> np.ndarray:
        with self._lock:
            return np.bincount(self._meta["exit_idx"][:self._n],
                               minlength=n_exits).astype(np.int64)[:n_exits]
