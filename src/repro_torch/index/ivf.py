"""Online IVF coarse quantizer over the embedding store (host side, numpy).

RECALL's serving claim is coarse-grained embeddings plus query-based
filtering. This module is the filter: a mini-batch k-means quantizer kept
up to date *online* from insert traffic, with per-cluster posting lists
mapping cluster -> slab rows, so a query scans only its ``nprobe`` most
promising clusters (see ``index.pruned_scan``). It is the reference's
numpy code, so assignments, posting lists and ``check_consistency`` are
bit-identical with it on the same insert stream.

Design
------
* **Training** is incremental: ``observe`` buffers early inserts until
  enough samples exist to seed ``n_clusters`` centroids, then applies one
  Sculley mini-batch k-means update per (subsampled) insert batch, with a
  per-cluster learning rate ``1/count``.
* **Assignment** is eager: each mutated row goes to its nearest centroid
  inside the store-lock critical section that wrote the row (one blocked
  argmin per batch). ``_assign`` is the ground truth (row -> cluster, -1 =
  unassigned); posting lists are a lazily rebuilt CSR view of it,
  invalidated by any mutation, so a delete's swap-with-last costs O(1).
* **Re-clustering** is split into three phases so the O(n·C) argmin never
  holds the store lock: ``begin_recluster`` (under the lock, O(C): grow or
  reseed centroids, snapshot them, arm a dirty-during bitmap),
  ``compute_assignments`` (no locks: blocked argmin over the store's
  copy-on-write dense view, plus one Lloyd mean-update per cluster) and
  ``commit_recluster`` (under the lock: install the centroids and apply
  the new assignment to every row NOT mutated during the compute window;
  those already hold a fresher assignment from their own hook). The sync
  query path runs a job inline when a trigger fires: unassigned rows,
  posting-list imbalance, accumulated centroid drift, or a pending
  ``auto_grow`` step (C tracks ~sqrt(n) in steps of at most 2x).

Consistency contract (asserted by the enumerated-schedule tests): after
any interleaving of add/upgrade/delete and re-cluster phases, ``assign[:n]``
covers exactly the store's live rows, the CSR posting lists partition the
assigned rows, and ``assign[n:]`` is clear. The index stores no
embeddings: 4 bytes/row plus C·E fp32 centroids.

Thread-safety: every mutating method MUST be called holding the owning
store's lock (the store's hooks do); ``compute_assignments`` is pure and
runs unlocked; ``recluster_lock`` serializes whole re-cluster jobs.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.index.pruned_scan import build_candidate_rows, select_probes


def assign_l2(X: np.ndarray, centroids: np.ndarray,
              block: int = 8192) -> np.ndarray:
    """Blocked nearest-centroid assignment (squared-L2 argmin): (m, E) fp32
    -> (m,) int32. ``||x-c||^2 = ||x||^2 - 2 x.c + ||c||^2`` — the x term is
    constant per row, so argmin over ``0.5||c||^2 - x.c`` suffices and the
    (block, C) distance tile never exceeds a few MB."""
    half_c2 = 0.5 * np.einsum("ce,ce->c", centroids, centroids)
    out = np.empty(len(X), np.int32)
    for i in range(0, len(X), block):
        d = half_c2[None, :] - X[i:i + block] @ centroids.T
        out[i:i + block] = np.argmin(d, axis=1)
    return out


@dataclasses.dataclass
class ReclusterJob:
    """One re-cluster epoch's immutable handoff: the row count and centroid
    snapshot taken at begin, plus the store's copy-on-write dense view the
    unlocked compute phase reads (rows < n stay stable under COW).
    ``owner`` pins the index the job belongs to — commit/abort must target
    it even if the store's attached index was swapped mid-job."""
    n: int
    centroids: np.ndarray      # (C, E) copy at begin (post-reseed/grow)
    dense: np.ndarray          # store dense view (read rows < n only)
    owner: "IVFIndex" = None   # set by begin_recluster
    new_assign: Optional[np.ndarray] = None     # filled by compute
    new_centroids: Optional[np.ndarray] = None  # Lloyd means, ditto
    new_counts: Optional[np.ndarray] = None     # cluster mass at compute


class IVFIndex:
    """Online IVF coarse quantizer + posting lists (see module docstring).

    ``min_rows`` gates the ``search_batch(impl='auto')`` cutover: below it
    the exhaustive fused scan is faster than probe selection + gather.
    ``nprobe`` is the default cluster fan-out per query (overridable per
    call). Construct via ``EmbeddingStore.attach_ivf``.
    """

    def __init__(self, embed_dim: int, *, n_clusters: int = 64,
                 nprobe: int = 8, min_rows: int = 32_768, seed: int = 0,
                 train_batch: int = 1024, init_oversample: float = 4.0,
                 imbalance_factor: float = 4.0,
                 drift_threshold: float = 0.25,
                 auto_grow: bool = False, max_clusters: int = 4096,
                 grow_trigger: float = 1.5):
        assert n_clusters >= 2, n_clusters
        self.embed_dim = embed_dim
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.min_rows = min_rows
        self.train_batch = train_batch
        self.init_oversample = init_oversample
        self.imbalance_factor = imbalance_factor
        self.drift_threshold = drift_threshold
        # auto-grow: keep C tracking ~sqrt(n) instead of pinning it at the
        # attach-time choice — a re-cluster epoch grows the codebook (at
        # most 2x per epoch, seeded from the heaviest clusters' rows) when
        # sqrt(n) has run ``grow_trigger`` ahead of C, so the probed
        # fraction keeps SHRINKING as the store scales (scanned rows ~
        # nprobe*n/C ~ nprobe*sqrt(n), sub-linear) instead of growing
        # linearly with n at fixed C
        self.auto_grow = auto_grow
        self.max_clusters = max_clusters
        self.grow_trigger = grow_trigger
        self._rng = np.random.default_rng(seed)
        self.centroids: Optional[np.ndarray] = None   # (C, E) fp32
        self._counts = np.ones(n_clusters, np.int64)  # minibatch LR state
        self._assign = np.full(64, -1, np.int32)      # row -> cluster
        self._n = 0                                   # live-row mirror
        self._buffer: List[np.ndarray] = []           # pre-init samples
        self._buffered = 0
        self._drift = 0.0
        # lazy CSR posting lists (rebuilt from _assign on demand)
        self._csr: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._csr_stale = True
        # lazily-cached aggregate assignment stats (unassigned count, max
        # cluster size): needs_recluster() runs on EVERY sync-mode ivf
        # query, and recomputing these is two O(n) passes under the store
        # lock — a linear per-query term on the path whose whole point is
        # sub-linear work. Invalidated exactly where the CSR is.
        self._agg_stale = True
        self._agg = (0, 0)
        # re-cluster machinery
        self._recluster_active = False
        self._dirty_during = np.zeros(64, np.bool_)
        # imbalance hysteresis: the factor*mean threshold alone re-fires
        # forever on data whose geometry k-means cannot balance further
        # (reseeding splits what it can; the residual max is structural) —
        # so after a re-cluster, imbalance only re-triggers once the max
        # cluster has grown another 25% beyond the post-commit state
        self._post_recluster_max: Optional[int] = None
        self.recluster_lock = threading.Lock()  # serializes whole jobs
        # observability
        self.n_train_batches = 0
        self.n_reclusters = 0
        self.n_reseeds = 0
        self.n_grows = 0

    # -- state ---------------------------------------------------------------

    @property
    def trained(self) -> bool:
        return self.centroids is not None

    def searchable(self, n: int) -> bool:
        """Should ``impl='auto'`` cut over to the pruned path at ``n`` rows?
        (Unassigned rows don't veto: they cost recall only until the next
        re-cluster, which any unassigned row triggers.)"""
        return self.trained and n >= self.min_rows

    def _refresh_agg(self) -> Tuple[int, int]:
        """(n_unassigned, max cluster size), recomputed only after a
        mutation (one O(n) pass, amortized with the lazy CSR rebuild) —
        steady-state queries read the cache."""
        if self._agg_stale:
            a = self._assign[:self._n]
            sz = np.bincount(a[a >= 0], minlength=self.n_clusters)
            self._agg = (int((a == -1).sum()),
                         int(sz.max()) if sz.size else 0)
            self._agg_stale = False
        return self._agg

    def n_unassigned(self) -> int:
        return self._refresh_agg()[0]

    def sizes(self) -> np.ndarray:
        """(C,) rows currently assigned per cluster."""
        a = self._assign[:self._n]
        return np.bincount(a[a >= 0], minlength=self.n_clusters)

    def stats(self) -> Dict[str, float]:
        sz = self.sizes() if self._n else np.zeros(self.n_clusters, np.int64)
        return {"n_clusters": self.n_clusters, "nprobe": self.nprobe,
                "trained": self.trained, "n_rows": self._n,
                "n_unassigned": self.n_unassigned() if self._n else 0,
                "max_cluster": int(sz.max()) if self._n else 0,
                "drift": self._drift,
                "n_train_batches": self.n_train_batches,
                "n_reclusters": self.n_reclusters,
                "n_reseeds": self.n_reseeds,
                "n_grows": self.n_grows}

    def ensure_capacity(self, cap: int) -> None:
        if cap <= len(self._assign):
            return
        for name, fill in (("_assign", -1), ("_dirty_during", False)):
            old = getattr(self, name)
            new = np.full(cap, fill, old.dtype)
            new[:len(old)] = old
            setattr(self, name, new)

    # -- training (mini-batch k-means) ---------------------------------------

    def _subsample(self, embs: np.ndarray) -> np.ndarray:
        if len(embs) <= self.train_batch:
            return embs
        sel = self._rng.choice(len(embs), self.train_batch, replace=False)
        return embs[sel]

    def observe(self, embs: np.ndarray) -> None:
        """Feed an insert batch to the trainer. Pre-init batches buffer
        (subsampled) until ``n_clusters * init_oversample`` samples exist;
        afterwards each batch is one mini-batch k-means step."""
        embs = np.asarray(embs, np.float32).reshape(-1, self.embed_dim)
        if len(embs) == 0:
            return
        if self.centroids is None:
            take = self._subsample(embs)
            self._buffer.append(take.copy())
            self._buffered += len(take)
            if self._buffered >= max(self.n_clusters + 1,
                                     int(self.n_clusters *
                                         self.init_oversample)):
                X = np.concatenate(self._buffer)
                self._buffer.clear()
                self._buffered = 0
                self.init_from(X)
            return
        self._minibatch_update(self._subsample(embs))

    def init_from(self, embs: np.ndarray) -> None:
        """Seed centroids from a sample (distinct random rows) and run one
        mini-batch pass over it. Used at buffer-full time and by the store
        for late init when an index is attached to an already-big store."""
        X = np.asarray(embs, np.float32).reshape(-1, self.embed_dim)
        assert len(X) >= self.n_clusters, (len(X), self.n_clusters)
        sel = self._rng.choice(len(X), self.n_clusters, replace=False)
        self.centroids = X[sel].copy()
        self._counts[:] = 1
        self._drift = 0.0
        for i in range(0, len(X), self.train_batch):
            self._minibatch_update(X[i:i + self.train_batch])

    def _minibatch_update(self, X: np.ndarray) -> None:
        """One Sculley mini-batch step: per-cluster learning rate 1/count,
        accumulating relative centroid movement into the drift trigger."""
        a = assign_l2(X, self.centroids)
        cnt = np.bincount(a, minlength=self.n_clusters)
        upd = np.nonzero(cnt)[0]
        sums = np.zeros((self.n_clusters, self.embed_dim), np.float32)
        np.add.at(sums, a, X)
        self._counts[upd] += cnt[upd]
        eta = (cnt[upd] / self._counts[upd]).astype(np.float32)[:, None]
        target = sums[upd] / cnt[upd].astype(np.float32)[:, None]
        delta = eta * (target - self.centroids[upd])
        self.centroids[upd] += delta
        moved = float(np.linalg.norm(delta, axis=1).sum())
        base = float(np.linalg.norm(self.centroids[upd], axis=1).sum())
        self._drift += moved / max(base, 1e-9)
        self.n_train_batches += 1

    # -- assignment (store-lock hooks) ---------------------------------------

    def assign_rows(self, rows: np.ndarray, embs: np.ndarray,
                    n_after: int) -> None:
        """Assign mutated rows to their nearest centroid (-1 when untrained).
        Duplicate rows in one batch resolve last-write-wins, matching the
        slab write order. Caller holds the store lock."""
        rows = np.asarray(rows, np.int64).ravel()
        if self.centroids is None:
            self._assign[rows] = -1
        else:
            embs = np.asarray(embs, np.float32).reshape(len(rows),
                                                        self.embed_dim)
            self._assign[rows] = assign_l2(embs, self.centroids)
        if self._recluster_active:
            self._dirty_during[rows] = True
        self._n = n_after
        self._csr_stale = True
        self._agg_stale = True

    def on_delete(self, row: int, last: int) -> None:
        """Mirror the store's swap-with-last compaction: the last row's
        assignment moves down with its payload, the tail slot clears."""
        if row != last:
            self._assign[row] = self._assign[last]
            if self._recluster_active:
                self._dirty_during[row] = True
        self._assign[last] = -1
        if self._recluster_active:
            self._dirty_during[last] = False  # slot is dead, not mutated
        self._n = last
        self._csr_stale = True
        self._agg_stale = True

    # -- posting lists -------------------------------------------------------

    def posting_lists(self) -> Tuple[np.ndarray, np.ndarray]:
        """CSR view of the assignment: (rows, offsets) with cluster ``c``'s
        slab rows at ``rows[offsets[c]:offsets[c+1]]``. Rebuilt lazily (one
        stable argsort of ``assign[:n]``); unassigned rows are excluded.
        Caller holds the store lock."""
        if self._csr_stale or self._csr is None:
            a = self._assign[:self._n]
            order = np.argsort(a, kind="stable").astype(np.int32)
            n_un = int((a == -1).sum())
            sizes = np.bincount(a[a >= 0], minlength=self.n_clusters)
            offsets = np.zeros(self.n_clusters + 1, np.int64)
            np.cumsum(sizes, out=offsets[1:])
            self._csr = (order[n_un:], offsets)
            self._csr_stale = False
        return self._csr

    def candidate_rows(self, queries: np.ndarray, k: int,
                       nprobe: Optional[int] = None) -> np.ndarray:
        """(Q, L) int32 candidate slab rows per query (-1 padded; L is the
        max probed posting mass, bucketed to a power of two and >= k so the
        scan retraces O(log) shapes). Caller holds the store lock."""
        nprobe = self.nprobe if nprobe is None else nprobe
        probes = select_probes(self.centroids, queries,
                               min(nprobe, self.n_clusters))
        rows, offsets = self.posting_lists()
        return build_candidate_rows(rows, offsets, probes, min_width=k)

    def candidate_union(self, queries: np.ndarray,
                        nprobe: Optional[int] = None) -> np.ndarray:
        """Union of all probed clusters' rows across the query batch (the
        batch-shared execution strategy): one gather + ONE fused scan for
        the whole batch instead of per-query gathered blocks. A query may
        thus score rows from a batchmate's probes — strictly a recall
        bonus (every scored row carries its true score). Rows are unique
        by construction (posting lists partition). Caller holds the store
        lock."""
        nprobe = self.nprobe if nprobe is None else nprobe
        probes = select_probes(self.centroids, queries,
                               min(nprobe, self.n_clusters))
        rows, offsets = self.posting_lists()
        cells = np.unique(probes)
        if cells.size == 0:
            return np.zeros(0, np.int32)
        return np.concatenate([rows[offsets[c]:offsets[c + 1]]
                               for c in cells])

    # -- re-clustering -------------------------------------------------------

    def target_clusters(self, n: Optional[int] = None) -> int:
        """The codebook size the index wants at ``n`` rows: ~sqrt(n),
        never below the current C (no shrinking) and capped at
        ``max_clusters``."""
        n = self._n if n is None else n
        return int(np.clip(round(np.sqrt(max(n, 0))), self.n_clusters,
                           self.max_clusters))

    def wants_growth(self) -> bool:
        """Auto-grow trigger: sqrt(n) has run ``grow_trigger`` ahead of the
        current C (hysteresis — growing on every insert would churn the
        codebook; converging within grow_trigger of sqrt(n) keeps the
        probed fraction sub-linear without thrashing)."""
        return (self.auto_grow and self.trained
                and self.n_clusters < self.max_clusters
                and self.target_clusters() >=
                self.grow_trigger * self.n_clusters)

    def needs_recluster(self) -> bool:
        """Unassigned rows (inserted pre-training), posting imbalance,
        accumulated centroid drift since the last full re-assignment, or a
        pending codebook growth step (auto_grow)."""
        if not self.trained or self._n == 0 or self._recluster_active:
            return False
        if self.n_unassigned():
            return True
        if self.wants_growth():
            return True
        if self._drift > self.drift_threshold:
            return True
        if self._n >= 4 * self.n_clusters:
            mean = self._n / self.n_clusters
            mx = self._refresh_agg()[1]  # cached: no O(n) pass per query
            if mx > self.imbalance_factor * mean and (
                    self._post_recluster_max is None or
                    mx > 1.25 * self._post_recluster_max):
                return True
        return False

    def _grow_clusters_locked(self, new_c: int, dense: np.ndarray) -> None:
        """Append ``new_c - C`` centroids, seeded from rows of the heaviest
        clusters (splitting their mass is where finer cells pay off; a
        cluster-less fallback draws uniformly). Under the store lock, O(C):
        existing assignments stay valid (values only ever < the OLD C), so
        posting lists and ``_assign`` remain bit-consistent — the follow-up
        compute/commit phases migrate rows to the new cells."""
        add = new_c - self.n_clusters
        assert add > 0, (new_c, self.n_clusters)
        sizes = self.sizes() if self._n else np.zeros(self.n_clusters,
                                                      np.int64)
        rows_csr, offs = self.posting_lists()
        donors = np.argsort(-sizes)
        seeds = np.empty((add, self.embed_dim), np.float32)
        for j in range(add):
            c = int(donors[j % len(donors)])
            span = rows_csr[offs[c]:offs[c + 1]]
            if span.size:
                row = int(span[self._rng.integers(span.size)])
            else:
                row = int(self._rng.integers(max(self._n, 1)))
            seeds[j] = dense[row]
        self.centroids = np.concatenate([self.centroids, seeds])
        self._counts = np.concatenate(
            [self._counts, np.ones(add, np.int64)])
        self.n_clusters = new_c
        self._csr_stale = True   # offsets are (C+1,): the shape changed
        self._agg_stale = True   # ditto the bincount width
        self.n_grows += 1

    def begin_recluster(self, dense: np.ndarray) -> ReclusterJob:
        """Phase 1, under the store lock, O(C): grow the codebook toward
        ~sqrt(n) if auto_grow wants it (at most 2x per epoch, so each
        growth step's O(n*C) compute stays bounded and C converges across
        epochs), reseed dead clusters (and split overfull ones by
        reseeding the smallest survivors from the overfull clusters'
        rows), snapshot the centroids, and arm the dirty-during bitmap so
        the unlocked compute phase can later tell which rows it raced."""
        assert self.trained and not self._recluster_active
        n = self._n
        if self.auto_grow:
            tgt = min(self.target_clusters(n), 2 * self.n_clusters)
            if tgt > self.n_clusters:
                self._grow_clusters_locked(tgt, dense)
        if n:
            sizes = self.sizes()
            mean = max(n / self.n_clusters, 1.0)
            dead = np.nonzero(sizes == 0)[0]
            over = np.nonzero(sizes > self.imbalance_factor * mean)[0]
            cap = max(1, self.n_clusters // 4)
            targets = list(dead[:cap])
            if over.size and len(targets) < over.size:
                live = np.argsort(sizes)
                live = [c for c in live if sizes[c] > 0 and c not in over]
                targets += live[:int(over.size) - len(targets)]
            if targets:
                rows_csr, offs = self.posting_lists()
                for t in targets[:cap]:
                    if over.size:
                        d = int(over[self._rng.integers(over.size)])
                        span = rows_csr[offs[d]:offs[d + 1]]
                        row = int(span[self._rng.integers(len(span))])
                    else:
                        row = int(self._rng.integers(n))
                    self.centroids[t] = dense[row]
                    self._counts[t] = 1
                    self.n_reseeds += 1
        self._recluster_active = True
        self._dirty_during[:] = False
        return ReclusterJob(n=n, centroids=self.centroids.copy(),
                            dense=dense, owner=self)

    @staticmethod
    def compute_assignments(job: ReclusterJob) -> ReclusterJob:
        """Phase 2, NO locks: the O(n·C) argmin over the copy-on-write dense
        view at the begin point, plus one Lloyd mean-update per cluster
        (segment-sum over the sorted assignment — the re-cluster epoch is
        then a true Lloyd iteration, which matters most for auto-grown
        centroids: a freshly grown cell starts as a raw data point and
        would otherwise never move to its cell's mean, costing probe-
        ranking recall). Pure w.r.t. index state."""
        X = job.dense[:job.n]
        a = assign_l2(X, job.centroids)
        job.new_assign = a
        C = len(job.centroids)
        cnt = np.bincount(a, minlength=C)
        means = job.centroids.copy()
        if job.n:
            order = np.argsort(a, kind="stable")
            starts = np.zeros(C, np.int64)
            np.cumsum(cnt[:-1], out=starts[1:])
            live = cnt > 0
            sums = np.zeros((C, X.shape[1]), np.float32)
            sums[live] = np.add.reduceat(X[order], starts[live], axis=0)
            means[live] = sums[live] / cnt[live, None]
        job.new_centroids = means
        job.new_counts = cnt
        return job

    def commit_recluster(self, job: ReclusterJob, n_now: int) -> None:
        """Phase 3, under the store lock: install the Lloyd-refined
        centroids and apply the computed assignment to every surviving row
        the compute window did NOT race (a row mutated mid-compute already
        holds a fresher assignment from its own hook — the stale argmin
        result must not clobber it). Mini-batch steps that landed during
        the compute window are superseded by the full-corpus means; the
        learning-rate counts restart at the computed cluster mass so later
        mini-batch nudges stay proportionate."""
        assert self._recluster_active and job.new_assign is not None
        if job.new_centroids is not None:
            self.centroids = job.new_centroids
            self._counts = np.maximum(job.new_counts, 1).astype(np.int64)
        m = min(job.n, n_now)
        keep = ~self._dirty_during[:m]
        self._assign[:m] = np.where(keep, job.new_assign[:m],
                                    self._assign[:m])
        self._recluster_active = False
        self._drift = 0.0
        self._csr_stale = True
        self._agg_stale = True
        self._post_recluster_max = int(self.sizes().max()) if self._n else 0
        self.n_reclusters += 1

    def abort_recluster(self) -> None:
        """Unwind a failed job (compute raised): assignments are untouched,
        so just disarm — the trigger condition still holds and the next
        epoch retries."""
        self._recluster_active = False

    # -- invariants (property tests / concurrency harness) -------------------

    def check_consistency(self, n: int, uid_rows: Optional[np.ndarray] = None
                          ) -> None:
        """Assert the posting-list <-> assignment <-> uid-index contract:
        ``assign[:n]`` in [-1, C) with a clear tail, the CSR partition
        matching it exactly, and (when the store's uid->row values are
        given) postings+unassigned covering exactly the live rows."""
        C = self.n_clusters
        assert self._n == n, (self._n, n)
        a = self._assign
        assert ((a[:n] >= -1) & (a[:n] < C)).all(), "assignment out of range"
        assert (a[n:] == -1).all(), "stale assignment past the live rows"
        rows, offsets = self.posting_lists()
        sizes = np.diff(offsets)
        assert offsets[0] == 0 and offsets[-1] == len(rows)
        assert np.array_equal(np.sort(rows),
                              np.nonzero(a[:n] >= 0)[0]), \
            "CSR rows != assigned rows"
        assert np.array_equal(a[rows],
                              np.repeat(np.arange(C), sizes)), \
            "CSR grouping disagrees with the assignment"
        assert self.n_unassigned() == int((a[:n] == -1).sum()), \
            "cached aggregate stats diverged from the assignment"
        assert self._refresh_agg()[1] == (int(np.max(np.diff(offsets)))
                                          if self.n_clusters else 0), \
            "cached max-cluster-size diverged from the posting lists"
        assert len(rows) + self.n_unassigned() == n
        if uid_rows is not None:
            live = np.sort(np.asarray(uid_rows, np.int64))
            assert np.array_equal(live, np.arange(n)), \
                "uid->row index is not exactly [0, n)"
