"""Async double-buffered DeviceBank refresh scheduler.

The sync path refreshes the bank under the store's lock on the query path.
This module moves the refresh out of the lock into a three-phase epoch, so
scans and refreshes overlap:

  1. ``begin_epoch``: under the store lock, O(dirty): take the dirty slice
     (clearing it: rows dirtied afterwards belong to the NEXT epoch, so a
     racing writer is never half-included), copy just those rows' packed
     bytes + scales as numpy, and snapshot (n, uids).
  2. ``apply``: no lock: growth + the dirty-row scatter into the SHADOW
     snapshot (``DeviceBank.apply_rows``; on CUDA on the bank's side
     stream, staged through pinned memory). Published state untouched.
  3. ``flip``: one attribute write publishes the shadow with a new
     generation (on CUDA with the side stream's event, which every scan of
     it waits on). All or nothing.

``refresh_once`` runs the three phases back to back (whole epochs are
serialized by an epoch lock, apply + flip also by the bank's
``refresh_lock``). The background thread coalesces mutation bursts into
single epochs (debounced wake), runs due IVF re-cluster jobs after each
epoch, and the staleness bounds decide when a query must wait:

  * ``max_lag_rows``: serve stale while at most this many distinct rows are
    dirty but unpublished; ``0`` means every query refreshes first, and
    ``None`` means unbounded;
  * ``max_lag_ms``: ... and while the oldest unpublished write is at most
    this old; same ``0`` / ``None`` meanings.

``snapshot_for_query`` is the store's entry point: it applies the policy,
or a per-query ``freshness`` override (``"fresh"`` blocks for a refresh,
``"stale"`` serves the published generation as is), and returns the
snapshot to scan. The phases are public because the enumerated-schedule
tests drive them as separate steps.
"""
from __future__ import annotations

import dataclasses
import threading
import time
import warnings
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.device_bank import BankSnapshot


@dataclasses.dataclass
class RefreshEpoch:
    """One epoch's immutable handoff, copied under the store lock at begin.
    ``bank`` pins the DeviceBank the epoch was begun on: a concurrent
    re-attach swaps the store's bank for a fresh one, and this epoch's
    partial dirty slice must not be scattered into that one (the re-attach
    marks every row dirty, so the next epoch uploads it in full)."""
    rows: np.ndarray                       # host row indices to scatter
    vals: np.ndarray                       # packed payload copy, (m, E//2)
    scs: np.ndarray                        # scales copy, (m, 1)
    n: int                                 # store row count at begin
    uids: np.ndarray                       # (n,) uid snapshot at begin
    host_cap: int                          # host slab capacity at begin
    bank: object = None                    # DeviceBank pinned at begin
    snapshot: Optional[BankSnapshot] = None  # shadow, filled by apply()


class RefreshScheduler:
    """Drives async DeviceBank refresh for one store, one epoch in flight
    at a time. Made by ``EmbeddingStore.set_bank_refresh("async", ...)``;
    ``thread=True`` runs epochs on a daemon thread woken by mutations,
    ``thread=False`` leaves the stepping to the caller."""

    def __init__(self, store, *, max_lag_rows: Optional[int] = None,
                 max_lag_ms: Optional[float] = None, thread: bool = True,
                 debounce_ms: float = 2.0, idle_ms: float = 50.0):
        self.store = store
        self.max_lag_rows = max_lag_rows
        self.max_lag_ms = max_lag_ms
        self._epoch_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self._debounce_s = debounce_ms / 1e3
        self._idle_s = idle_ms / 1e3
        # observability (approximate under concurrency)
        self.n_epochs = 0
        self.n_blocking = 0        # queries that waited for a refresh
        self.n_stale_served = 0    # queries served a lagging snapshot
        self.max_served_lag_rows = 0  # largest row lag a policy read served
        if thread:
            self.start()

    # -- epoch phases ---------------------------------------------------------

    def begin_epoch(self) -> Optional[RefreshEpoch]:
        """Phase 1, under the store lock: take the dirty slice and copy its
        payload. None when the published snapshot is already exact."""
        st = self.store
        with st._lock:
            if st._bank is None:
                st.attach_device_bank()
            bank = st._bank
            rows = st._take_bank_dirty_locked()
            pub = bank.published
            if rows.size == 0 and pub is not None and pub.n == st._n:
                return None
            return RefreshEpoch(
                rows=rows, vals=st._packed[rows].copy(),
                scs=st._scales[rows].copy(), n=st._n,
                uids=st._meta["uid"][:st._n].copy(),
                host_cap=st._packed.shape[0], bank=bank)

    def apply(self, epoch: RefreshEpoch) -> BankSnapshot:
        """Phase 2, no locks: build the shadow on the epoch's own bank. A
        grown shadow is warmed before it is published."""
        bank = epoch.bank
        old_cap = bank.capacity
        epoch.snapshot = bank.apply_rows(
            epoch.host_cap, epoch.rows, epoch.vals, epoch.scs, epoch.n,
            epoch.uids)
        if epoch.snapshot.capacity != old_cap:
            bank.warm(epoch.snapshot)
        return epoch.snapshot

    def flip(self, epoch: RefreshEpoch) -> BankSnapshot:
        """Phase 3: publish the shadow on the epoch's own bank."""
        self.n_epochs += 1
        return epoch.bank.publish(epoch.snapshot)

    def refresh_once(self) -> bool:
        """Run one full epoch (begin -> apply -> flip); False if clean. A
        failed epoch puts its dirty slice back before re-raising."""
        with self._epoch_lock:
            epoch = self.begin_epoch()
            if epoch is None:
                return False
            try:
                with epoch.bank.refresh_lock:
                    self.apply(epoch)
                    self.flip(epoch)
            except BaseException:
                self.store._requeue_bank_rows(epoch.rows)
                raise
            return True

    # -- staleness policy -----------------------------------------------------

    def lag(self) -> Tuple[int, float]:
        """(dirty-but-unpublished row count, ms since the oldest of them)."""
        st = self.store
        with st._lock:
            rows = st._bank_pending_rows
            t0 = st._bank_first_dirty_t
        ms = 0.0 if (t0 is None or rows == 0) else \
            (time.monotonic() - t0) * 1e3
        return rows, ms

    def _within(self, rows: int, ms: float) -> bool:
        if rows == 0:
            return True
        if self.max_lag_rows is not None and rows > self.max_lag_rows:
            return False
        if self.max_lag_ms is not None and ms > self.max_lag_ms:
            return False
        return True

    def within_bound(self) -> bool:
        return self._within(*self.lag())

    def snapshot_for_query(self, freshness: Optional[str] = None
                           ) -> BankSnapshot:
        """The snapshot a query scans. ``freshness``: None -> the
        configured bounds decide; ``"fresh"`` -> always block for a
        refresh; ``"stale"`` -> the published generation without checking
        the bounds (a refresh still runs when nothing was ever
        published)."""
        if freshness not in (None, "fresh", "stale"):
            raise ValueError(f"freshness={freshness!r}")
        bank = self.store._bank
        snap = None if bank is None else bank.published
        if snap is not None and freshness == "stale":
            self.n_stale_served += 1
            return snap
        rows, ms = self.lag()
        if snap is None or freshness == "fresh" or not self._within(rows, ms):
            self.n_blocking += 1
            self.refresh_once()
            return self.store._bank.published
        self.n_stale_served += 1
        self.max_served_lag_rows = max(self.max_served_lag_rows, rows)
        return snap

    # -- background thread ----------------------------------------------------

    def notify(self) -> None:
        """Mutation hook: wake the background refresher."""
        self._wake.set()

    def start(self) -> None:
        if self._thread is not None:
            return
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="bank-refresh")
        self._thread.start()

    def stop(self, drain: bool = True) -> None:
        """Stop the thread; ``drain`` publishes any remaining dirt first."""
        self._stop = True
        self._wake.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=30)
            if t.is_alive():
                raise RuntimeError("bank refresh thread did not stop in 30 s")
        if drain:
            self.refresh_once()

    def _run(self) -> None:
        while not self._stop:
            fired = self._wake.wait(timeout=self._idle_s)
            if self._stop:
                break
            if fired:
                self._wake.clear()
                # let a mutation burst coalesce into one epoch
                time.sleep(self._debounce_s)
            try:
                self.refresh_once()
                # IVF re-clustering piggybacks on refresh epochs, off the
                # query path; loop while jobs fire (auto-grow converges over
                # several bounded steps)
                while self.store.ivf_maybe_recluster() and not self._stop:
                    pass
            except Exception as e:  # keep the daemon alive; dirt was requeued
                warnings.warn(f"bank refresh epoch failed: {e!r}",
                              RuntimeWarning)
                time.sleep(self._idle_s)
