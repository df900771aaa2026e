"""GNN neighbor sampler (GraphSAGE-style fanout sampling, host-side).

Builds a CSR adjacency once, then samples k-hop padded subgraphs with static
shapes (so every step takes one shape): ``minibatch_lg`` uses fanout
(15, 10) from 1024 seeds, giving max 1024*(1+15+150) nodes and 1024*(15+150) edges per batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class CSRGraph:
    indptr: np.ndarray   # (N+1,)
    indices: np.ndarray  # (E,)
    n_nodes: int

    @staticmethod
    def from_edges(src: np.ndarray, dst: np.ndarray, n_nodes: int) -> "CSRGraph":
        order = np.argsort(dst, kind="stable")  # incoming-edge CSR (dst-major)
        s, d = src[order], dst[order]
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.add.at(indptr, d + 1, 1)
        np.cumsum(indptr, out=indptr)
        return CSRGraph(indptr=indptr, indices=s.astype(np.int64), n_nodes=n_nodes)

    def sample_neighbors(self, nodes: np.ndarray, fanout: int,
                         rng: np.random.Generator
                         ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """For each node sample up to ``fanout`` in-neighbors (with
        replacement where degree>0). Returns (src, dst, mask) each
        (len(nodes)*fanout,)."""
        deg = self.indptr[nodes + 1] - self.indptr[nodes]
        offs = rng.integers(0, np.maximum(deg, 1)[:, None],
                            size=(len(nodes), fanout))
        base = self.indptr[nodes][:, None]
        idx = np.minimum(base + offs, base + np.maximum(deg, 1)[:, None] - 1)
        src = self.indices[idx]  # (n, fanout)
        dst = np.repeat(nodes, fanout).reshape(len(nodes), fanout)
        mask = (deg > 0)[:, None] & np.ones_like(src, bool)
        return src.ravel(), dst.ravel(), mask.ravel()


@dataclasses.dataclass
class SampledSubgraph:
    """Padded, statically-shaped subgraph batch (local node ids)."""
    node_ids: np.ndarray    # (max_nodes,) global ids (padded w/ 0)
    node_mask: np.ndarray   # (max_nodes,)
    src: np.ndarray         # (max_edges,) local ids
    dst: np.ndarray
    edge_mask: np.ndarray
    seed_local: np.ndarray  # (n_seeds,) local indices of the seed nodes


def max_sizes(n_seeds: int, fanout: Sequence[int]) -> Tuple[int, int]:
    nodes, frontier, edges = n_seeds, n_seeds, 0
    for f in fanout:
        frontier *= f
        nodes += frontier
        edges += frontier
    return nodes, edges


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanout: Sequence[int],
                    rng: np.random.Generator) -> SampledSubgraph:
    max_n, max_e = max_sizes(len(seeds), fanout)
    all_src, all_dst, all_mask = [], [], []
    frontier = seeds
    for f in fanout:
        s, d, m = g.sample_neighbors(frontier, f, rng)
        all_src.append(s)
        all_dst.append(d)
        all_mask.append(m)
        frontier = s
    src = np.concatenate(all_src)
    dst = np.concatenate(all_dst)
    emask = np.concatenate(all_mask)
    # build local id space: seeds first, then unique others
    uniq, inv = np.unique(np.concatenate([seeds, src, dst]), return_inverse=True)
    # remap with seeds pinned to [0, n_seeds)
    seed_pos = np.searchsorted(uniq, seeds)
    perm = np.full(len(uniq), -1, np.int64)
    perm[seed_pos] = np.arange(len(seeds))
    rest = np.setdiff1d(np.arange(len(uniq)), seed_pos)
    perm[rest] = len(seeds) + np.arange(len(rest))
    local = perm[inv]
    seeds_l = local[:len(seeds)]
    src_l = local[len(seeds):len(seeds) + len(src)]
    dst_l = local[len(seeds) + len(src):]
    n_used = len(uniq)

    node_ids = np.zeros(max_n, np.int64)
    node_mask = np.zeros(max_n, np.float32)
    inv_order = np.empty(len(uniq), np.int64)
    inv_order[perm] = np.arange(len(uniq))
    node_ids[:n_used] = uniq[inv_order]
    node_mask[:n_used] = 1.0

    def pad_e(a, fill=0):
        out = np.full(max_e, fill, a.dtype)
        out[:len(a)] = a
        return out

    return SampledSubgraph(
        node_ids=node_ids, node_mask=node_mask,
        src=pad_e(src_l.astype(np.int32)), dst=pad_e(dst_l.astype(np.int32)),
        edge_mask=pad_e(emask.astype(np.float32)),
        seed_local=seeds_l.astype(np.int32))
