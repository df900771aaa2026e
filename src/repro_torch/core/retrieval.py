"""Speculative fine-grained retrieval (paper §3.4), vectorized.

Three rounds, mirroring speculative decoding's draft→verify split:
  1. *Speculative filtering*: the query is embedded at several granularities
     (exit depths); all G granularities are stacked into ONE (G, E) batch and
     pushed through ``store.search_batch`` — a single fused top-k scan of the
     store (the int4 ``retrieval_topk`` kernel) instead of G dense matmuls.
     This fixes the unbalanced-embedding-distribution problem (a
     full-capacity query embedding alone under-retrieves shallow-exit items).
  2. *Global verifying*: candidates are merged with a vectorized numpy dedup
     (sort by score, keep first occurrence per uid) — no Python dict loop.
  3. *Fine-grained correcting*: surviving coarse candidates are refined by
     the live encoder in uid *batches* (one dense continuation per exit
     group, resumed from the INT4 activation cache) and matched against the
     fine-grained query embedding. Refined items are permanently upgraded in
     the store via one ``upgrade_batch`` call. The round-3 core is
     ``refine_round``, shared with ``QueryEngine.query_batch``: one
     parameterized implementation of the rank-order/dedup/fallback logic
     (``budget_mode="successes"`` = this module's retry-until-budget loop,
     ``"attempts"`` = the drain batch's capped single round).

``refine_fn`` contract: called with an int64 uid array, it returns a mapping
{uid: fine_emb} covering the uids it could refine.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.store import EmbeddingStore
from repro_torch.tracing import span


@dataclasses.dataclass
class RetrievalResult:
    uids: np.ndarray            # final ranking (k,)
    scores: np.ndarray
    filtered_uids: np.ndarray   # after round 2 (pre-refinement)
    n_refined: int
    latency_s: float


def speculative_filter(store: EmbeddingStore,
                       query_embs: Sequence[np.ndarray], k: int, *,
                       impl: str = "auto", freshness: Optional[str] = None,
                       nprobe: Optional[int] = None
                       ) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Round 1: per-granularity top-k, all granularities in one fused batch.
    query_embs: list of (E,) vectors. ``freshness`` is the device-path
    staleness override and ``nprobe`` the IVF probe fan-out (see
    ``EmbeddingStore.search_batch``); round 1 is where approximation pays
    off — the candidate set feeds a verify + refine stage that re-scores
    against live embeddings anyway, so both bounded staleness and coarse
    cluster pruning cost recall, never correctness."""
    Q = np.stack([np.asarray(q, np.float32) for q in query_embs])
    uids, scores = store.search_batch(Q, k, impl=impl, freshness=freshness,
                                      nprobe=nprobe)
    return list(zip(uids, scores))


def global_verify(rounds: List[Tuple[np.ndarray, np.ndarray]], k: int
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Round 2: merge + dedup keeping the best score per uid, then top-k.

    Vectorized: stable-sort all candidates by descending score, then keep the
    first (= best-scoring) occurrence of each uid."""
    if not rounds:
        return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
    u = np.concatenate([np.asarray(r[0], np.int64).ravel() for r in rounds])
    s = np.concatenate([np.asarray(r[1], np.float32).ravel() for r in rounds])
    live = s > -5e29  # drop IVF padding slots (uid -1 / score -1e30)
    u, s = u[live], s[live]
    if u.size == 0:
        return np.zeros((0,), np.int64), np.zeros((0,), np.float32)
    order = np.argsort(-s, kind="stable")
    u, s = u[order], s[order]
    _, first = np.unique(u, return_index=True)  # first hit per uid = best
    keep = np.sort(first)[:k]                   # ascending = score-descending
    return u[keep], s[keep]


def refine_batch(refine_fn: Callable, uids: np.ndarray
                 ) -> Dict[int, np.ndarray]:
    """Call ``refine_fn`` on a uid batch and read its {uid: emb} mapping."""
    uids = np.asarray(uids, np.int64).ravel()
    if uids.size == 0:
        return {}
    return {int(u): np.asarray(e, np.float32)
            for u, e in refine_fn(uids).items()}


def refine_round(store: EmbeddingStore,
                 uids_per_query: Sequence[np.ndarray],
                 refine_fn: Optional[Callable],
                 refine_budget: Optional[int] = None, *,
                 upgrade: bool = True, budget_mode: str = "successes"
                 ) -> Tuple[List[np.ndarray], List[int]]:
    """Round 3 core, shared by ``speculative_retrieve`` (one query) and
    ``QueryEngine.query_batch`` (a whole drain) — one parameterized
    implementation of the rank-order/fallback logic that used to be
    duplicated between them.

    For each query's candidate list, the non-fine candidates are refined in
    rank order through ``refine_batch``; a candidate pending for several
    queries is refined ONCE (deduplicated across the batch) and counted for
    each requesting query. Refined items are pushed to the store with a
    single ``upgrade_batch``; fallback (coarse) embeddings are snapshotted
    before any upgrade.

    ``budget_mode``:
      * ``"successes"`` — retry until ``refine_budget`` refinements *succeed*
        per query (candidates past a failed one are still attempted), the
        seed's sequential-loop semantics.
      * ``"attempts"`` — cap *attempted* candidates per query at
        ``refine_budget`` (one refinement round, no retries), the cheaper
        drain-batch semantics.

    Returns (per-query (m_q, E) fine/fallback matrices, per-query refine
    counts)."""
    if budget_mode not in ("successes", "attempts"):
        raise ValueError(budget_mode)
    uids_per_query = [np.asarray(u, np.int64).ravel() for u in uids_per_query]
    fallbacks = [store.get_embeddings(u) for u in uids_per_query]
    if refine_fn is None or not any(u.size for u in uids_per_query):
        return fallbacks, [0] * len(uids_per_query)
    pendings: List[np.ndarray] = []
    for u in uids_per_query:
        p = u[~store.is_fine(u)] if u.size else u
        if budget_mode == "attempts" and refine_budget is not None:
            p = p[:refine_budget]
        pendings.append(p)
    refined: Dict[int, np.ndarray] = {}
    offsets = [0] * len(pendings)
    while True:
        want: List[int] = []
        seen = set(refined)
        for qi, p in enumerate(pendings):
            if budget_mode == "attempts":
                take = p[offsets[qi]:]
            else:
                budget = (p.size if refine_budget is None
                          else min(refine_budget, p.size))
                done = sum(1 for x in p.tolist() if int(x) in refined)
                take = p[offsets[qi]:offsets[qi] + max(budget - done, 0)]
            offsets[qi] += take.size
            for x in take.tolist():
                if x not in seen:
                    seen.add(x)
                    want.append(x)
        if not want:
            break
        refined.update(refine_batch(refine_fn, np.asarray(want, np.int64)))
        if budget_mode == "attempts":
            break
    if refined and upgrade:
        r_uids = np.fromiter(refined.keys(), np.int64, len(refined))
        store.upgrade_batch(r_uids, np.stack([refined[int(u)]
                                              for u in r_uids]))
    n_refs: List[int] = []
    for qi, (u, embs) in enumerate(zip(uids_per_query, fallbacks)):
        pend = set(pendings[qi].tolist())
        n = 0
        for j, x in enumerate(u.tolist()):
            if x in refined and x in pend:
                embs[j] = refined[x]
                n += 1
        n_refs.append(n)
    return fallbacks, n_refs


def _refine_round(store: EmbeddingStore, uids: np.ndarray,
                  refine_fn: Optional[Callable],
                  refine_budget: Optional[int], upgrade: bool
                  ) -> Tuple[np.ndarray, int]:
    """Single-query wrapper over ``refine_round`` (seed semantics)."""
    embs, n = refine_round(store, [uids], refine_fn, refine_budget,
                           upgrade=upgrade, budget_mode="successes")
    return embs[0], n[0]


def speculative_retrieve(
        store: EmbeddingStore,
        query_embs: Sequence[np.ndarray],
        fine_query: np.ndarray,
        *, k: int = 10, final_k: int = 10,
        refine_fn: Optional[Callable] = None,
        refine_budget: Optional[int] = None,
        upgrade: bool = True, impl: str = "auto",
        freshness: Optional[str] = None,
        nprobe: Optional[int] = None) -> RetrievalResult:
    """Full pipeline (see module docstring for the ``refine_fn`` contract).
    ``refine_budget`` caps refinements (query latency budget, Fig. 15);
    ``freshness`` and ``nprobe`` are forwarded to the round-1 store scan
    (async device-bank staleness policy / IVF probe fan-out)."""
    t0 = time.perf_counter()
    with span("query.filter"):
        rounds = speculative_filter(store, query_embs, k, impl=impl,
                                    freshness=freshness, nprobe=nprobe)
    with span("query.verify"):
        uids, _ = global_verify(rounds, k)
        if uids.size:
            # a stale bank snapshot (async refresh) can surface uids deleted
            # since its generation; round 3 reads live store rows, so drop
            # the dead ones here — "no longer exists" is the correct stale
            # answer
            uids = uids[store.contains(uids)]
    with span("query.refine"):
        fine_embs, n_ref = _refine_round(store, uids, refine_fn,
                                         refine_budget, upgrade)

    with span("query.match"):
        if len(fine_embs):
            scores = fine_embs @ np.asarray(fine_query, np.float32)
            order = np.argsort(-scores)[:final_k]
            uids_f, scores_f = uids[order], scores[order]
        else:
            uids_f = np.zeros((0,), np.int64)
            scores_f = np.zeros((0,), np.float32)
    return RetrievalResult(
        uids=uids_f, scores=scores_f, filtered_uids=uids, n_refined=n_ref,
        latency_s=time.perf_counter() - t0)


def single_granularity_retrieve(store: EmbeddingStore, query_emb: np.ndarray,
                                k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
    """Baseline: one full-capacity query embedding, no refinement."""
    return store.search(query_emb, k)
