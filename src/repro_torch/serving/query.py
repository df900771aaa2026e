"""Query runtime (paper §2.2 "online recall", §3.4 speculative retrieval).

Embeds the query at several granularities (exit depths of the *query*
tower), speculatively filters the store per granularity, verifies globally,
then refines surviving coarse candidates with the live encoder under an
optional latency budget. Repeated queries hit permanently upgraded
embeddings (§5.3) and skip refinement.

Two entry points:
  * ``query``       — one query (refinement budget counts *successes*,
    retrying past failed candidates).
  * ``query_batch`` — many users per drain: ONE ``mem_embed_all_exits`` tower
    pass for the whole batch, one fused ``store.search_batch`` call over all
    B×G (query, granularity) pairs, a single deduplicated refinement batch
    shared across queries, and one store ``upgrade_batch``; the per-query
    budget caps *attempted* candidates.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import MEMConfig, RecallConfig
from repro_torch.core.retrieval import (RetrievalResult, global_verify,
                                        refine_round,
                                        single_granularity_retrieve,
                                        speculative_retrieve)
from repro_torch.core.store import EmbeddingStore
from repro_torch.models import imagebind as IB
from repro_torch.tracing import span


class QueryEngine:
    def __init__(self, params, cfg: MEMConfig, recall: RecallConfig, *,
                 store: EmbeddingStore,
                 refine_fn: Optional[Callable] = None,
                 query_modality: str = "text", lora=None,
                 search_impl: str = "auto", search_devices=None,
                 bank_refresh: str = "sync",
                 bank_max_lag_rows: Optional[int] = None,
                 bank_max_lag_ms: Optional[float] = None,
                 freshness: Optional[str] = None, index: str = "none", index_clusters: int = 64,
                 index_min_rows: Optional[int] = None,
                 nprobe: Optional[int] = None,
                 index_auto_grow: bool = False, device="cuda"):
        self.device = resolve_device(device)
        if bank_refresh not in ("sync", "async"):
            raise ValueError(f"bank_refresh={bank_refresh!r}")
        self.params, self.cfg, self.recall = params, cfg, recall
        self.store = store
        self.refine_fn = refine_fn
        self.modality = query_modality
        self.lora = lora
        # per-query default of the async staleness policy (None = obey the
        # configured bounds; "fresh"/"stale" force a side)
        self.freshness = freshness
        # IVF probe fan-out forwarded to every store scan (None = the
        # index's default; ignored on non-IVF paths)
        self.nprobe = nprobe
        # coarse-filter index: "ivf" attaches the online IVF quantizer, so
        # search_impl='auto' cuts over to the pruned scan at index_min_rows;
        # an index already attached to the store is reused
        if index == "ivf":
            if store.ivf_index is None:
                ivf_kw = {"n_clusters": index_clusters,
                          "auto_grow": index_auto_grow}
                if index_min_rows is not None:
                    ivf_kw["min_rows"] = index_min_rows
                if nprobe is not None:
                    ivf_kw["nprobe"] = nprobe
                store.attach_ivf(**ivf_kw)
        elif index != "none":
            raise ValueError(f"index={index!r}")
        if search_impl == "ivf" and store.ivf_index is None:
            raise ValueError("search_impl='ivf' needs an attached IVF index "
                             "(pass index='ivf' or attach_ivf beforehand)")
        self._search_impl = search_impl
        # device-resident bank: attach eagerly so the warm-up upload happens
        # at engine construction, not on the first query. An explicit device
        # list (one shard an entry) always attaches anew and serves the
        # exhaustive device scan: a bank attached earlier over other
        # devices must not win over the caller's request
        if search_devices is not None:
            store.attach_device_bank(search_devices)
            self._search_impl = "device"
        elif store.resolve_impl(search_impl) in ("device", "ivf") \
                and store.device_bank is None:
            store.attach_device_bank()
        # "async" moves the dirty-row refresh off the query path onto a
        # background scheduler (bounded staleness); "sync" leaves the
        # store's policy as it is
        if bank_refresh == "async":
            store.set_bank_refresh("async", max_lag_rows=bank_max_lag_rows,
                                   max_lag_ms=bank_max_lag_ms)
        t = cfg.tower(query_modality)
        exits = recall.exit_layers(t.n_layers)
        k = recall.query_granularities
        # spread query granularities across the exit range (incl. full depth)
        idx = np.unique(np.linspace(0, len(exits) - 1, k).round().astype(int))
        self.granularities = [exits[i] for i in idx]
        self._exits = exits
        self._g_rows = [exits.index(g) for g in self.granularities]

    @property
    def search_impl(self) -> str:
        """The store scan a query runs now: ``'auto'`` is resolved on every
        call, so the cut-over to the IVF path happens as the store grows
        past the index's ``min_rows``."""
        return self.store.resolve_impl(self._search_impl)

    # -- embedding -----------------------------------------------------------

    @torch.no_grad()
    def _all_exits(self, queries: np.ndarray) -> np.ndarray:
        x = torch.as_tensor(np.asarray(queries)).to(self.device)
        embs = IB.mem_embed_all_exits(self.params, self.cfg, self.recall,
                                      self.modality, x,
                                      lora=self.lora)["exit_embs"]
        return embs.float().cpu().numpy()

    def embed_query(self, query: np.ndarray) -> Dict[int, np.ndarray]:
        """One tower pass gives every granularity (exit taps are free)."""
        embs = self._all_exits(np.asarray(query)[None])[:, 0]
        return {e: embs[self._exits.index(e)] for e in self.granularities}

    def embed_query_batch(self, queries: np.ndarray) -> np.ndarray:
        """(B, ...) query batch -> (B, G, E) granularity embeddings from ONE
        tower pass (row -1 is the fine/full-depth embedding)."""
        embs = self._all_exits(queries)
        return embs[self._g_rows].transpose(1, 0, 2)  # (B, G, E)

    # -- single query --------------------------------------------------------

    def query(self, query: np.ndarray, *, k: int = 10, final_k: int = 10,
              refine_budget: Optional[int] = None,
              speculative: bool = True) -> RetrievalResult:
        with span("query.embed"):
            by_g = self.embed_query(query)
        fine = by_g[self.granularities[-1]]
        if not speculative:
            t0 = time.perf_counter()
            with span("query.filter"):
                uids, scores = single_granularity_retrieve(self.store, fine,
                                                           k)
            return RetrievalResult(uids=uids, scores=scores,
                                   filtered_uids=uids, n_refined=0,
                                   latency_s=time.perf_counter() - t0)
        return speculative_retrieve(
            self.store, [by_g[g] for g in self.granularities], fine,
            k=k, final_k=final_k, refine_fn=self.refine_fn,
            refine_budget=refine_budget, impl=self.search_impl,
            freshness=self.freshness, nprobe=self.nprobe)

    # -- batched queries -----------------------------------------------------

    def query_batch(self, queries, *, k: int = 10, final_k: int = 10,
                    refine_budget: Optional[int] = None,
                    speculative: bool = True) -> List[RetrievalResult]:
        """Serve a whole drain of queries at once (see module docstring).
        Per-result ``latency_s`` is the batch wall time amortized over the
        batch; the ``query.*`` spans time the rounds under a profiler."""
        queries = np.stack([np.asarray(q) for q in queries])
        B = len(queries)
        if B == 0:
            return []
        t0 = time.perf_counter()
        with span("query.embed"):
            QG = self.embed_query_batch(queries)        # (B, G, E)
        fine_q = QG[:, -1]                              # (B, E)
        G = QG.shape[1]
        if not speculative:
            with span("query.filter"):
                uids, scores = self.store.search_batch(
                    fine_q, k, impl=self.search_impl,
                    freshness=self.freshness, nprobe=self.nprobe)
            dt = (time.perf_counter() - t0) / B
            return [RetrievalResult(uids=uids[b], scores=scores[b],
                                    filtered_uids=uids[b], n_refined=0,
                                    latency_s=dt)
                    for b in range(B)]

        # round 1: every (query, granularity) pair in ONE fused store scan
        with span("query.filter"):
            flat_u, flat_s = self.store.search_batch(
                QG.reshape(B * G, -1), k, impl=self.search_impl,
                freshness=self.freshness, nprobe=self.nprobe)
        kk = flat_u.shape[1]
        u3 = flat_u.reshape(B, G, kk)
        s3 = flat_s.reshape(B, G, kk)

        # round 2: vectorized dedup per query; one contains() call for the
        # whole batch drops uids deleted since the scan
        with span("query.verify"):
            cands = [global_verify(list(zip(u3[b], s3[b])), k)
                     for b in range(B)]
            lens = [u.size for u, _ in cands]
            if sum(lens):
                live_all = self.store.contains(
                    np.concatenate([u for u, _ in cands]))
                offs = np.cumsum([0] + lens)
                cands = [(u[live_all[o:o + n]], s[live_all[o:o + n]])
                         for (u, s), o, n in zip(cands, offs, lens)]

        # round 3: one deduplicated refinement batch across all queries
        with span("query.refine"):
            fine_per_q, n_ref_per_q = refine_round(
                self.store, [u for u, _ in cands], self.refine_fn,
                refine_budget, upgrade=True, budget_mode="attempts")

        ranked = []
        with span("query.match"):
            for b in range(B):
                uids_b, _ = cands[b]
                fine_embs = fine_per_q[b]
                n_ref = n_ref_per_q[b]
                if len(fine_embs):
                    scores = fine_embs @ fine_q[b]
                    order = np.argsort(-scores)[:final_k]
                    ranked.append((uids_b[order], scores[order], uids_b,
                                   n_ref))
                else:
                    ranked.append((np.zeros((0,), np.int64),
                                   np.zeros((0,), np.float32), uids_b, n_ref))
        dt = (time.perf_counter() - t0) / B
        return [RetrievalResult(uids=u, scores=s, filtered_uids=fu,
                                n_refined=n, latency_s=dt)
                for u, s, fu, n in ranked]
