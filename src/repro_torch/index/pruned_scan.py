"""IVF pruned search: probe selection, candidate building, oracle, recall.

The pruned query path is: (1) rank centroids per query and keep the top
``nprobe`` (on the host: C is tiny next to the bank), (2) concatenate the
probed clusters' posting lists into a padded (Q, L) candidate-row matrix,
(3) run the gathered int4 top-k over only those rows
(``kernels.retrieval_topk.ops.retrieval_topk_int4_gathered``, the same
per-row dequant-and-dot arithmetic as the exhaustive scan, so per-row
scores match bit for bit and pruning can only drop rows, never re-score
them).

Pure numpy, no store state: the store glues it to the device bank
(``EmbeddingStore.search_batch(impl='ivf')``); ``pruned_search_numpy`` is
the whole pipeline on the host, the oracle the parity tests and
``chip_smoke.py`` compare against. On a row-sharded bank
``partition_rows_by_shard`` routes the candidate set by shard ownership,
so each shard scans only its own candidates (``DeviceBank.search_rows``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from repro_torch.kernels.retrieval_topk.ops import pow2_bucket

INVALID_UID = -1          # uid padding for queries with < k live candidates
NEG_INF = -1e30


def select_probes(centroids: np.ndarray, queries: np.ndarray,
                  nprobe: int) -> np.ndarray:
    """(Q, nprobe) int32 cluster ids, best first. Centroids are ranked by
    cosine against the query: the bank scores raw inner products over
    ~unit-norm embeddings, and cosine ranking ignores the norm shrinkage of
    k-means means (a mean of unit vectors is shorter than they are, which
    would bias a raw inner-product ranking toward tight clusters)."""
    q = np.asarray(queries, np.float32)
    c = np.asarray(centroids, np.float32)
    nprobe = min(nprobe, len(c))
    sims = q @ c.T
    sims /= np.maximum(np.linalg.norm(c, axis=1)[None, :], 1e-9)
    part = np.argpartition(-sims, nprobe - 1, axis=1)[:, :nprobe]
    order = np.argsort(-np.take_along_axis(sims, part, axis=1), axis=1)
    return np.take_along_axis(part, order, axis=1).astype(np.int32)


def build_candidate_rows(csr_rows: np.ndarray, csr_offsets: np.ndarray,
                         probes: np.ndarray, *, min_width: int = 1
                         ) -> np.ndarray:
    """Concatenate the probed posting lists into a (Q, L) int32 candidate
    matrix, -1 padded. L = the largest probed posting mass of the batch,
    floored at ``min_width`` (callers pass k, so top-k never sees fewer
    columns than it selects) and rounded up to a power of two, so the
    scan sees O(log) distinct widths as clusters grow."""
    Q = len(probes)
    lens = (csr_offsets[probes + 1] - csr_offsets[probes]).sum(axis=1) \
        if Q else np.zeros(0, np.int64)
    L = max(int(lens.max()) if Q else 0, min_width, 1)
    L = 1 << (L - 1).bit_length()
    ids = np.full((Q, L), -1, np.int32)
    for qi in range(Q):
        off = 0
        for c in probes[qi]:
            span = csr_rows[csr_offsets[c]:csr_offsets[c + 1]]
            ids[qi, off:off + len(span)] = span
            off += len(span)
    return ids


def partition_rows_by_shard(rows: np.ndarray, rows_per_shard: int,
                            n_shards: int, *, min_width: int = 1
                            ) -> Tuple[np.ndarray, np.ndarray]:
    """Route a global candidate-row set to the bank's row shards (shard
    ``s`` owns global rows ``[s * rows_per_shard, (s + 1) *
    rows_per_shard)``). Returns ``(local (S, M) int32, counts (S,)
    int32)``: row s of ``local`` holds shard s's candidates as shard-local
    row indices, in their order in ``rows``, padded with 0 (the scan masks
    them with ``n_valid = counts[s]``). M is the largest per-shard count,
    floored at ``min_width`` and bucketed by ``pow2_bucket``."""
    rows = np.asarray(rows, np.int64).ravel()
    sid = rows // rows_per_shard
    if rows.size and not (0 <= sid.min() and sid.max() < n_shards):
        raise ValueError(f"candidate row outside the sharded slab "
                         f"({n_shards} shards of {rows_per_shard} rows)")
    counts = np.bincount(sid, minlength=n_shards).astype(np.int32)
    M = pow2_bucket(int(counts.max()) if rows.size else 0, floor=min_width)
    local = np.zeros((n_shards, M), np.int32)
    order = np.argsort(sid, kind="stable")
    sorted_local = (rows - sid * rows_per_shard)[order].astype(np.int32)
    offs = np.concatenate([[0], np.cumsum(counts)])
    for s in range(n_shards):
        span = sorted_local[offs[s]:offs[s + 1]]
        local[s, :len(span)] = span
    return local, counts


def pruned_search_numpy(dense: np.ndarray, n: int, uids: np.ndarray,
                        index, queries: np.ndarray, k: int, *,
                        nprobe: Optional[int] = None
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Host reference for the whole pruned pipeline on the store's fp32
    dense slab: probe -> gather -> dense score -> top-k. Returns ((Q, k)
    uids, (Q, k) scores); slots past a query's live candidate count hold
    (INVALID_UID, NEG_INF). The device path agrees with this up to int4
    score error and near-tie order (compare uid sets where separated)."""
    queries = np.asarray(queries, np.float32)
    Q = len(queries)
    cand = index.candidate_rows(queries, k, nprobe=nprobe)
    out_u = np.full((Q, k), INVALID_UID, np.int64)
    out_s = np.full((Q, k), NEG_INF, np.float32)
    for qi in range(Q):
        rows = cand[qi]
        rows = rows[(rows >= 0) & (rows < n)]
        if rows.size == 0:
            continue
        scores = dense[rows] @ queries[qi]
        kk = min(k, rows.size)
        sel = np.argpartition(-scores, kk - 1)[:kk]
        sel = sel[np.argsort(-scores[sel])]
        out_u[qi, :kk] = uids[rows[sel]]
        out_s[qi, :kk] = scores[sel]
    return out_u, out_s


def recall_at_k(approx_uids: np.ndarray, exact_uids: np.ndarray) -> float:
    """Mean fraction of the exact top-k that the pruned scan found, per
    query. Padding (INVALID_UID) on the approximate side never matches."""
    approx = np.asarray(approx_uids, np.int64)
    exact = np.asarray(exact_uids, np.int64)
    assert approx.shape == exact.shape, (approx.shape, exact.shape)
    hits = 0
    total = 0
    for a, e in zip(approx, exact):
        e = e[e != INVALID_UID]
        total += len(e)
        hits += len(set(a.tolist()) & set(e.tolist()))
    return hits / max(total, 1)
