"""Slab-backed embedding store: coarse embeddings + exit metadata + INT4
activation cache.

Host-side component of the serving runtime — the analogue of the paper's
on-flash store (§5.4). Embeddings live in contiguous growable slabs:

  * ``_packed``  (cap, E//2) int8  — two INT4 nibbles per byte,
  * ``_scales``  (cap, 1)   fp32   — per-row absmax scales,
  * ``_meta``    (cap,) structured — uid / exit_idx / exit_layer / modality /
    fine,
  * ``_dense``   (cap, E)  fp32    — incrementally maintained dequantized
    matrix for the host paths: only rows dirtied since the last refresh are
    re-dequantized.

Capacity grows by amortized doubling; a uid->row hash index finds rows.
Inserts quantize on the host with ``quantize_int4_np``. ``search_batch`` is
the serving hot path: on a store that lives on a CUDA device,
``impl='auto'`` resolves to the device-resident int4 bank
(``core.device_bank``), refreshed from a dirty-row bitmap and scanned by
the fused dequant-top-k kernel; a store the caller put on the CPU resolves
to the numpy matmul path. Queried items are permanently upgraded to their
fine-grained embeddings (§5.3) via ``upgrade_batch``.
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.quantize import dequantize_int4_np, quantize_int4_np

_META_DTYPE = np.dtype([("uid", np.int64), ("exit_idx", np.int32),
                        ("exit_layer", np.int32), ("fine", np.bool_),
                        ("modality_id", np.int32)])  # index into _modalities

_NOT_PORTED = {
    "ivf": "the IVF coarse-filter index and pruned scan are not ported yet "
           "(ROADMAP queue A, pruned-search slice)",
    "async": "async bank refresh is not ported yet (ROADMAP queue A, "
             "async-refresh slice)",
    "shard": "sharded device banks are not ported yet (ROADMAP queue A, "
             "multi-GPU slice)",
    "lora": "LoRA deltas (P-LoRA) are not ported yet (ROADMAP queue A, "
            "training slice)",
    "dense": "the dense fp32 top-k kernel (search impl 'pallas'/'xla') is "
             "not ported yet (ROADMAP queue B)",
}


def not_ported(feature: str) -> NotImplementedError:
    return NotImplementedError(_NOT_PORTED[feature])


class EmbeddingStore:
    def __init__(self, embed_dim: int, capacity: int = 64, *, device="cuda"):
        if embed_dim % 2:
            raise ValueError(f"int4 packing needs an even embed_dim, got "
                             f"{embed_dim}")
        self.embed_dim = embed_dim
        self.device = resolve_device(device)
        self._row_width = embed_dim // 2
        self._cap = max(int(capacity), 1)
        self._n = 0
        self._packed = np.zeros((self._cap, self._row_width), np.int8)
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

    # -- mutation ------------------------------------------------------------

    def add(self, uid: int, emb: np.ndarray, *, exit_idx: int, exit_layer: int,
            modality: str = "", fine: bool = False,
            cached_h: Optional[np.ndarray] = None) -> None:
        self.add_batch([uid], np.asarray(emb, np.float32)[None],
                       [exit_idx], [exit_layer], modality=modality, fine=fine,
                       cached_hs=None if cached_h is None
                       else np.asarray(cached_h, np.float32)[None])

    def add_batch(self, uids, embs, exit_idxs, exit_layers, *, modality="",
                  fine: bool = False, cached_hs=None) -> None:
        """Vectorized insert: one quantize call for the embedding batch and
        (optionally) one for the activation batch. Re-adding an existing uid
        overwrites its row in place (last write wins)."""
        uids = np.asarray(uids, np.int64).ravel()
        embs = np.asarray(embs, np.float32).reshape(len(uids), self.embed_dim)
        packed, scales = quantize_int4_np(embs)
        act = None
        if cached_hs is not None:
            ch = np.asarray(cached_hs, np.float32)  # (B, ..., d)
            p, s = quantize_int4_np(ch)
            act = (p, s, tuple(ch.shape[1:]))
        exit_idxs = np.asarray(exit_idxs, np.int32).ravel()
        exit_layers = np.asarray(exit_layers, np.int32).ravel()
        with self._lock:
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

    def upgrade_batch(self, uids: Sequence[int], fine_embs: np.ndarray) -> None:
        """Vectorized §5.3 upgrade: requantize the batch in one call, mark
        only the touched rows dirty, free their activation cache."""
        uids = np.asarray(uids, np.int64).ravel()
        if uids.size == 0:
            return
        embs = np.asarray(fine_embs, np.float32).reshape(len(uids),
                                                         self.embed_dim)
        packed, scales = quantize_int4_np(embs)
        with self._lock:
            rows = self._rows_of_locked(uids)
            self._packed[rows] = packed
            self._scales[rows] = scales
            self._meta["fine"][rows] = True
            self._dirty[rows] = True
            self._any_dirty = True
            self._mark_bank_dirty_locked(rows)
            for u in uids.tolist():
                self._act_cache.pop(u, None)  # §3.4: storage freed once refined

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
                self._bank_dirty[last] = False
                self._n = last

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

    def __len__(self) -> int:
        return self._n

    def uids(self) -> np.ndarray:
        with self._lock:
            return self._meta["uid"][:self._n].copy()

    def is_fine(self, uids) -> np.ndarray:
        with self._lock:
            return self._meta["fine"][self._rows_of_locked(
                np.asarray(uids, np.int64).ravel())].copy()

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
            self._dense[rows] = dequantize_int4_np(self._packed[rows],
                                                   self._scales[rows])
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

    def cached_activations(self, uids) -> Dict[int, Tuple[np.ndarray, int]]:
        """Batched host dequant of cached activations, one call per distinct
        activation shape. Returns {uid: (h, layer)}."""
        with self._lock:
            items = [(int(u), self._act_cache[int(u)]) for u in uids
                     if int(u) in self._act_cache]
        by_shape: Dict[Tuple[int, ...], list] = {}
        for u, (p, s, shape, layer) in items:
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
        self._bank_dirty[rows] = True
        self._any_bank_dirty = True

    def _take_bank_dirty_locked(self) -> np.ndarray:
        """Consume the dirty rows for one refresh."""
        if not self._any_bank_dirty:  # steady-state queries skip the O(N) scan
            return np.zeros((0,), np.int64)
        rows = np.nonzero(self._bank_dirty[:self._n])[0]
        self._bank_dirty[:self._n] = False
        self._any_bank_dirty = False
        return rows

    def attach_device_bank(self, devices=None, *, device=None):
        """Create (or replace) the device-resident searchable bank on
        ``device`` (default: the store's device). Existing rows are marked
        for upload on the next sync; after that only dirty rows travel.
        ``devices`` (a list, for a sharded bank) is not ported yet."""
        from repro_torch.core.device_bank import DeviceBank
        if devices is not None:
            raise not_ported("shard")
        with self._lock:
            self._bank = DeviceBank(self.embed_dim,
                                    device=self.device if device is None
                                    else device)
            if self._n:
                self._mark_bank_dirty_locked(np.arange(self._n))
            return self._bank

    @property
    def device_bank(self):
        """The attached DeviceBank, or None."""
        return self._bank

    def set_bank_refresh(self, mode: str = "sync", **kw):
        """Only ``"sync"`` (refresh under the store lock per query) is
        ported."""
        if mode == "async":
            raise not_ported("async")
        if mode != "sync":
            raise ValueError(mode)
        return None

    def _sync_bank_locked(self):
        if self._bank is None:
            self.attach_device_bank()
        bank = self._bank
        rows = self._take_bank_dirty_locked()
        snap = bank.sync(self._packed, self._scales, self._n, rows,
                         self._meta["uid"][:self._n].copy())
        return bank, snap

    def attach_ivf(self, **kw):
        raise not_ported("ivf")

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
        """``'auto'`` follows the device the caller put the store on: the
        device bank for CUDA, numpy for the CPU."""
        if impl != "auto":
            return impl
        return "numpy" if self.device.type == "cpu" else "device"

    def search_batch(self, queries: np.ndarray, k: int, *, impl: str = "auto",
                     freshness: Optional[str] = None,
                     nprobe: Optional[int] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Fused batched top-k over the whole store: queries (Q, E) ->
        (uids (Q, k), scores (Q, k)), both sorted by descending score; raw
        inner products. ``impl``: 'device' (int4 bank, incremental refresh,
        fused dequant scan), 'numpy' (host matmul + argpartition), or
        'auto' (see ``resolve_impl``)."""
        if freshness is not None:
            raise not_ported("async")
        if nprobe is not None:
            raise not_ported("ivf")
        impl = self.resolve_impl(impl)
        if impl == "ivf":
            raise not_ported("ivf")
        if impl in ("pallas", "xla"):
            raise not_ported("dense")
        if impl not in ("device", "numpy"):
            raise ValueError(f"search impl {impl!r}")
        queries = np.asarray(queries, np.float32).reshape(-1, self.embed_dim)
        nq = len(queries)
        if self._n == 0 or nq == 0:
            return (np.zeros((nq, 0), np.int64),
                    np.zeros((nq, 0), np.float32))
        if impl == "device":
            # refresh + scan under one lock hold: the bank's scatter is in
            # place, so a scan must not overlap the next refresh
            with self._lock:
                bank, snap = self._sync_bank_locked()
                if snap.n == 0:
                    return (np.zeros((nq, 0), np.int64),
                            np.zeros((nq, 0), np.float32))
                idx, top_s = bank.search(queries, min(k, snap.n), state=snap)
            return snap.uids[idx], top_s
        slab, n, uids = self._search_snapshot()
        k = min(k, n)
        scores = queries @ slab[:n].T                       # (Q, N)
        idx = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        part = np.take_along_axis(scores, idx, axis=1)
        order = np.argsort(-part, axis=1)
        idx = np.take_along_axis(idx, order, axis=1)
        top_s = np.take_along_axis(part, order, axis=1)
        return uids[idx], top_s

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
