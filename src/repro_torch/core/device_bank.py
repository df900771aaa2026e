"""Device-resident embedding bank: the searchable copy of the store's slab,
kept on the devices and refreshed *incrementally*.

  * The bank's rows are split across ``devices`` (one shard per entry, in
    one process; a device may repeat, so one card or the CPU can hold
    several shards). Shard s owns the global rows ``[s * rps, (s + 1) *
    rps)``, where ``rps`` is the capacity over the shard count; the
    capacity is the host slab's rounded up to a multiple of that count,
    and shard s's fill is ``clip(n - s * rps, 0, rps)``.
  * An int4 bank (``store_int4=True``) holds ``packed`` (rps, E//2) int8 +
    ``scales`` (rps, 1) fp32 a shard and scans it with the fused
    dequant-and-scan ``retrieval_topk_int4`` (the CUDA kernel on a CUDA
    shard), so the fp32 bank never exists in device memory. An fp32 bank
    (``store_int4=False``) mirrors fp32 rows and scans them with the dense
    ``retrieval_topk``.
  * A refresh moves ONLY the rows dirtied since the last one: they are
    split by owner, and each group's packed bytes + scales travel to its
    shard (``index_copy_``; the host payload is just those rows). The bank
    grows by slab doubling *on device* in lockstep with the host slab: the
    grown shards are built device to device from the published ones. A
    doubling doubles ``rps``, so new shard s draws its rows from old shards
    s' (rows move between shards), and nothing is uploaded again.
  * The IVF pruned scans read the same shards: ``search_rows`` (one
    candidate union for the batch) and ``search_gathered`` (per-query
    candidates); they need an int4 bank.

Refresh protocol (shared by the sync path and the async scheduler of
``core.bank_refresh``): ``apply_rows`` builds a SHADOW snapshot (grown
shards, or a device-side clone of each published shard that takes dirty
rows, then the scatters) without touching the published state, and
``publish`` flips the published pointer to it in one attribute write, with
a new generation. A published snapshot's tensors are never written again,
so a scan pinned to one (``state=``) needs no lock and sees exactly one
generation. The capacity is the published snapshot's, so a grow is
committed only when every shard's copy was issued and the shadow
published. Refreshes are serialized by ``refresh_lock`` (``sync`` takes
it; the scheduler holds it across apply + publish); scans never take it.

On a CUDA shard the refresh runs on its device's side stream: the pinned
host payload is copied and scattered there (a copy from a shard on another
card runs with both cards' side streams current, so it is ordered after
the source's writes), and ``publish`` records one event per shard into the
snapshot. A scan makes each shard's stream wait on that shard's event
before it launches, and marks every shard tensor it reads as used by that
stream (``record_stream``), so the caching allocator cannot hand their
memory to the refresher while the scan still reads them. On the CPU the
same phases run inline.

Sharded search: each shard runs the scan over its own rows (its fill as
``n_valid``), one launch a shard a scan, an empty shard included, and the
per-shard (Q, k) winners, their ids offset to global rows, merge on the
first shard's device (``distributed.collectives.topk_allgather_merge``:
what moves is k winners a shard, independent of the bank size). The IVF
pruned entries shard-route the same way: the candidate union is split by
row ownership (``index.pruned_scan.partition_rows_by_shard``) and each
shard scans only its own candidates, or each shard masks the per-query
candidates it does not own; a shard short of live candidates pads with
sentinel slots (score -1e30), which map to id -1 before the merge.

Transfer accounting: ``h2d_bytes`` / ``h2d_rows`` count the actual
host-to-device payload (scattered rows + scales + the row index).
Steady-state queries transfer nothing but the query batch.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.distributed.collectives import topk_allgather_merge
from repro_torch.index.pruned_scan import partition_rows_by_shard
from repro_torch.kernels.retrieval_topk.ops import (
    retrieval_topk, retrieval_topk_int4, retrieval_topk_int4_gathered)

SENTINEL = -5e29  # scores at or below it are the kernels' dead slots


class BankSnapshot(NamedTuple):
    """One published generation of the device bank: one packed, scales and
    event entry a shard. Its tensors are never written after the flip, and
    ``uids`` is a private host copy."""
    packed: Tuple[torch.Tensor, ...]  # per shard (rps, E//2) int8 | (rps, E)
    scales: Tuple[torch.Tensor, ...]  # per shard (rps, 1) fp32
    n: int                 # valid rows; rows >= n are masked at query time
    uids: np.ndarray       # (n,) int64, row i -> uid, aligned with this epoch
    generation: int        # monotonically increasing flip counter
    # per shard: recorded on the shard's refresh stream at the flip (CUDA),
    # None on the CPU; scans wait on it
    ready: Tuple[Optional[torch.cuda.Event], ...] = ()

    @property
    def rows_per_shard(self) -> int:
        return int(self.packed[0].shape[0])

    @property
    def capacity(self) -> int:
        return self.rows_per_shard * len(self.packed)

    def n_local(self, s: int) -> int:
        """Shard s's fill: the valid rows it holds."""
        rps = self.rows_per_shard
        return max(0, min(self.n - s * rps, rps))


def _canonical(dev: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current>``, so shards on one card share a key."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class DeviceBank:
    """Device-resident slab mirror, row-sharded across ``devices`` (see
    module docstring). ``devices`` defaults to ``[device]``; every entry
    is resolved as the entry points resolve theirs (a ``"cuda"`` entry
    without a card raises)."""

    def __init__(self, embed_dim: int, *, store_int4: bool = True,
                 devices: Optional[Sequence] = None, device="cuda"):
        if store_int4 and embed_dim % 2:
            raise ValueError(f"int4 bank needs an even embed_dim, got "
                             f"{embed_dim}")
        devs = [device] if devices is None else list(devices)
        if not devs:
            raise ValueError("a device bank needs at least one device")
        self.embed_dim = embed_dim
        self.store_int4 = store_int4
        self.devices: List[torch.device] = [_canonical(resolve_device(d))
                                            for d in devs]
        self.n_shards = len(self.devices)
        self._row_width = embed_dim // 2 if store_int4 else embed_dim
        self._row_dtype = torch.int8 if store_int4 else torch.float32
        self._published: Optional[BankSnapshot] = None
        self._gen = 0
        self._streams: Dict[torch.device, torch.cuda.Stream] = {}
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
        """Rows of the published shards together (a grown shadow counts once
        it is published, so a failed grow epoch leaves it unchanged)."""
        st = self._published
        return 0 if st is None else st.capacity

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
                "capacity": self.capacity, "n": len(self),
                "n_shards": self.n_shards, "generation": self.generation,
                "device_bytes": 0 if st is None else
                int(sum(p.nbytes + s.nbytes
                        for p, s in zip(st.packed, st.scales)))}

    # -- refresh -------------------------------------------------------------

    def _stream(self, dev: torch.device) -> torch.cuda.Stream:
        """``dev``'s refresh side stream, made at first use."""
        if dev not in self._streams:
            self._streams[dev] = torch.cuda.Stream(device=dev)
        return self._streams[dev]

    def _on(self, *devs: torch.device):
        """The context the refresh's device work runs in: the side stream
        of every CUDA device among ``devs`` current (a cross-device copy
        runs on the source's current stream, synchronized with the
        destination's); nothing on the CPU."""
        stack = contextlib.ExitStack()
        for dev in dict.fromkeys(devs):
            if dev.type == "cuda":
                stack.enter_context(torch.cuda.stream(self._stream(dev)))
        return stack

    @staticmethod
    def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
        """Host rows -> ``dev``: staged through pinned memory and copied
        without blocking (on the refresh stream) on CUDA."""
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dev.type != "cuda":
            return t
        return t.pin_memory().to(dev, non_blocking=True)

    def _grow_shard(self, base: Optional[BankSnapshot], s: int, rps: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Shard s of the grown layout (``rps`` rows a shard): new buffers
        with the published rows of its range copied device to device from
        whichever old shards hold them, never a host re-upload. Runs with
        shard s's side stream current."""
        dev = self.devices[s]
        new_p = torch.zeros((rps, self._row_width), dtype=self._row_dtype,
                            device=dev)
        new_s = torch.zeros((rps, 1), dtype=torch.float32, device=dev)
        if base is None:
            return new_p, new_s
        old_rps = base.rows_per_shard
        lo, hi = s * rps, min((s + 1) * rps, base.capacity)
        g = lo
        while g < hi:
            src, off = divmod(g, old_rps)
            take = min(hi - g, old_rps - off)
            with self._on(dev, self.devices[src]):
                new_p[g - lo:g - lo + take].copy_(
                    base.packed[src][off:off + take])
                new_s[g - lo:g - lo + take].copy_(
                    base.scales[src][off:off + take])
            g += take
        return new_p, new_s

    @staticmethod
    def _scatter(dst: torch.Tensor, rows: torch.Tensor,
                 vals: torch.Tensor) -> None:
        dst.index_copy_(0, rows, vals)

    def apply_rows(self, host_cap: int, dirty_rows: np.ndarray,
                   vals: np.ndarray, scs: np.ndarray, n: int,
                   uids: np.ndarray) -> BankSnapshot:
        """Build the SHADOW snapshot: shards grown to ``host_cap`` (rounded up
        to a multiple of the shard count) if the host slab doubled, else the
        published shards, each that takes dirty rows cloned on its device
        (copy-on-write); then the dirty rows' payload (``vals``/``scs`` are
        host copies of those rows), split by owner, scattered into their
        shards. The published state is untouched; ``publish`` flips it.
        Callers serialize refreshes (``refresh_lock``)."""
        base = self._published
        rows = np.asarray(dirty_rows, np.int64).ravel()
        vals, scs = np.asarray(vals), np.asarray(scs)
        cap = int(host_cap)
        cap += (-cap) % self.n_shards
        grow = base is None or cap > base.capacity
        rps = cap // self.n_shards if grow else base.rows_per_shard
        owner = rows // rps
        if owner.size and (np.diff(owner) < 0).any():
            order = np.argsort(owner, kind="stable")
            rows, owner, vals, scs = (rows[order], owner[order], vals[order],
                                      scs[order])
        bounds = np.searchsorted(owner, np.arange(self.n_shards + 1))
        packed, scales, n_bytes = [], [], 0
        for s, dev in enumerate(self.devices):
            a, b = int(bounds[s]), int(bounds[s + 1])
            if grow:
                with self._on(dev):
                    p, sc = self._grow_shard(base, s, rps)
            elif b > a:
                with self._on(dev):
                    p, sc = base.packed[s].clone(), base.scales[s].clone()
            else:
                p, sc = base.packed[s], base.scales[s]
            if b > a:
                local = rows[a:b] - s * rps
                with self._on(dev):
                    idx = self._upload(local, dev)
                    self._scatter(p, idx, self._upload(vals[a:b], dev))
                    self._scatter(sc, idx, self._upload(scs[a:b], dev))
                n_bytes += int(vals[a:b].nbytes + scs[a:b].nbytes
                               + local.nbytes)
            packed.append(p)
            scales.append(sc)
        self.h2d_bytes += n_bytes
        self.h2d_rows += int(rows.size)
        if grow and base is not None:
            self.n_grows += 1
        self._gen += 1
        return BankSnapshot(tuple(packed), tuple(scales), int(n),
                            np.asarray(uids, np.int64), self._gen)

    def publish(self, snap: BankSnapshot) -> BankSnapshot:
        """Atomically flip the published pointer to ``snap``; on CUDA first
        record each shard's refresh-stream event into it. Generations must
        advance: an out-of-order flip means two refreshes ran concurrently
        and one dropped the other's rows."""
        cur = self._published
        if cur is not None and snap.generation <= cur.generation:
            raise RuntimeError(f"out-of-order flip: generation "
                               f"{snap.generation} after {cur.generation}; "
                               "refresh epochs must be serialized")
        ready = []
        for dev in self.devices:
            ev = None
            if dev.type == "cuda":
                ev = torch.cuda.Event()
                ev.record(self._stream(dev))
            ready.append(ev)
        snap = snap._replace(ready=tuple(ready))
        self._published = snap
        self.n_syncs += 1
        return snap

    def warm(self, state: BankSnapshot) -> bool:
        """Ready the scan for ``state`` before it is published. The CUDA
        kernels take any capacity without a rebuild, so this only makes
        sure the scan's library is built and loaded (a first scan would
        otherwise build it on the query path). False without a CUDA
        shard."""
        if not any(d.type == "cuda" for d in self.devices) or state.n == 0:
            return False
        from repro_torch.kernels import build
        build.load("topk_int4" if self.store_int4 else "topk_dense")
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
        """The snapshot to scan, each shard ordered after its refresh on
        this thread's stream of the shard's device."""
        state = self._published if state is None else state
        if state is None:
            raise RuntimeError("DeviceBank search before the first sync()")
        for s, ev in enumerate(state.ready):
            if ev is not None:
                cur = torch.cuda.current_stream(self.devices[s])
                cur.wait_event(ev)
                state.packed[s].record_stream(cur)
                state.scales[s].record_stream(cur)
        return state

    def _queries(self, queries: np.ndarray) -> Dict[torch.device,
                                                     torch.Tensor]:
        """The query batch on every shard's device (one copy a device)."""
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        return {dev: q.to(dev) for dev in dict.fromkeys(self.devices)}

    def _need_int4(self) -> None:
        if not self.store_int4:
            raise NotImplementedError("pruned search needs an int4 bank")

    def _merge(self, scores: List[torch.Tensor], ids: List[torch.Tensor],
               k: int) -> Tuple[np.ndarray, np.ndarray]:
        """The per-shard (Q, k_loc) sets (global ids) -> host (ids (Q, k)
        int64, scores (Q, k) fp32)."""
        if len(scores) == 1:
            s, i = scores[0], ids[0]
        else:
            s, i = topk_allgather_merge(scores, ids, k)
        return i.cpu().numpy().astype(np.int64), s.cpu().numpy()

    def search(self, queries: np.ndarray, k: int,
               state: Optional[BankSnapshot] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k over the device-resident bank: (Q, E) queries -> (row
        indices (Q, k) int64, scores (Q, k) fp32), descending score. Each
        shard scans its rows (the fused int4 scan, or the dense one on an
        fp32 bank) for its best ``min(k, rps)``; the sets merge. Only the
        query batch travels host-to-device."""
        state = self._state(state)
        k = min(k, state.n)
        rps = state.rows_per_shard
        k_loc = min(k, rps)
        qs = self._queries(queries)
        out_s, out_i = [], []
        for s, dev in enumerate(self.devices):
            if self.store_int4:
                sc, i = retrieval_topk_int4(qs[dev], state.packed[s],
                                            state.scales[s], k_loc,
                                            normalize=False,
                                            n_valid=state.n_local(s))
            else:
                sc, i = retrieval_topk(qs[dev], state.packed[s], k_loc,
                                       normalize=False,
                                       n_valid=state.n_local(s))
            out_s.append(sc)
            out_i.append(i + s * rps)
        return self._merge(out_s, out_i, k)

    def search_gathered(self, queries: np.ndarray, row_ids: np.ndarray,
                        k: int, state: Optional[BankSnapshot] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """IVF pruned scan, per-query strategy: top-k over each query's own
        candidate rows ``row_ids`` (Q, L) int32 (-1 padded) of one
        snapshot; ids past its fill are masked. Each shard translates the
        ids to its own rows (ids it does not own, or past its fill, are
        dead) and runs the gathered kernel, which reads the candidates by
        id, so no gathered copy is made; device work scales with L, not the
        bank size. Returns ((Q, k) GLOBAL row ids, (Q, k) scores); slots
        with no live candidate hold id -1 / score -1e30. Needs an int4
        bank."""
        self._need_int4()
        state = self._state(state)
        k = min(k, state.n)
        ids = np.asarray(row_ids, np.int32)
        if ids.shape[1] < k:  # top-k needs >= k columns; -1 pads are dead
            ids = np.pad(ids, ((0, 0), (0, k - ids.shape[1])),
                         constant_values=-1)
        rps = state.rows_per_shard
        qs = self._queries(queries)
        out_s, out_i = [], []
        for s, dev in enumerate(self.devices):
            base = s * rps
            lid = ids
            if self.n_shards > 1:
                lid = ids - np.int32(base)
                lid = np.where((ids >= 0) & (lid >= 0) & (lid < rps), lid,
                               np.int32(-1))
            sc, i = retrieval_topk_int4_gathered(
                qs[dev], state.packed[s], state.scales[s],
                torch.from_numpy(np.ascontiguousarray(lid)).to(dev), k,
                normalize=False, n_valid=state.n_local(s))
            out_s.append(sc)
            out_i.append(torch.where(sc > SENTINEL, i + base,
                                     torch.full_like(i, -1)))
        return self._merge(out_s, out_i, k)

    def search_rows(self, queries: np.ndarray, rows: np.ndarray, k: int,
                    state: Optional[BankSnapshot] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """IVF pruned scan, batch-union strategy: one candidate-row set for
        the whole batch (the caller keeps ``rows`` < ``state.n``), routed
        to the shards that own them (``partition_rows_by_shard``); each
        shard gathers its candidates on its device and runs the exhaustive
        int4 scan over them (``n_valid`` = its live count, the padding
        masked), so the scan covers ``len(rows)`` rows instead of ``n``.
        Returns ((Q, k) GLOBAL row ids, (Q, k) scores); a slot with no live
        candidate (only when the union holds fewer than k rows) holds id
        -1 / score -1e30. Requires 0 < k <= len(rows) and an int4 bank."""
        self._need_int4()
        state = self._state(state)
        rows = np.asarray(rows, np.int64).ravel()
        if not 0 < k <= rows.size:
            raise ValueError(f"k={k} must be in [1, {rows.size}] (the "
                             "union's size)")
        rps = state.rows_per_shard
        # padding in numpy, not with CPU torch ops: those wake torch's
        # OpenMP pool, which then competes with numpy's BLAS threads
        local, counts = partition_rows_by_shard(rows, rps, self.n_shards)
        k_loc = min(k, local.shape[1])
        qs = self._queries(queries)
        out_s, out_i = [], []
        for s, dev in enumerate(self.devices):
            idx = torch.from_numpy(local[s].astype(np.int64)).to(dev)
            sc, i = retrieval_topk_int4(
                qs[dev], state.packed[s].index_select(0, idx),
                state.scales[s].index_select(0, idx), k_loc,
                normalize=False, n_valid=int(counts[s]))
            # a dead slot's id may be anything: clamp before the lookup
            gid = idx[i.long().clamp(0, idx.numel() - 1)].to(torch.int32) \
                + s * rps
            out_s.append(sc)
            out_i.append(torch.where(sc > SENTINEL, gid,
                                     torch.full_like(gid, -1)))
        return self._merge(out_s, out_i, k)
