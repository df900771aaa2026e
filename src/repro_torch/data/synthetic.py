"""Synthetic data, the reference's generators draw for draw: the same seeds
give the same arrays.

``multimodal_pairs``: procedural, *learnable* multimodal pairs. One latent z
per item; each modality observes a fixed random projection of z plus
modality noise, so items differ in SNR and hence in optimal exit.
``clustered_sphere``: the blob-mixture embedding corpus of the IVF tests.
``lm_tokens``: order-2 Markov token streams for LM training.
``criteo_like``: DLRM's dense and zipf-sparse features with a learnable
label. ``sbm_graph``: a homophilous stochastic-block-model graph (GNN).
``seq_recsys``: behaviour sequences from latent user/item factors (BST,
SASRec, DIEN).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.configs.base import MEMConfig, RecsysConfig

_ARGMAX_ROWS = 16  # items per chunk of the (n, T, vocab) text projection


@dataclasses.dataclass
class MultimodalData:
    """Arrays per modality, aligned by item index; plus difficulty (noise)."""
    items: Dict[str, np.ndarray]
    difficulty: np.ndarray  # (N,) in [0,1]; higher = needs deeper exit
    latent: np.ndarray


def multimodal_pairs(seed: int, n: int, cfg: MEMConfig, d_latent: int = 16,
                     noise_lo: float = 0.05, noise_hi: float = 1.2,
                     world_seed: int = 1234) -> MultimodalData:
    """``world_seed`` fixes the modality observation models (projections) so
    different data splits (seeds) are drawn from the same world."""
    world = np.random.default_rng(world_seed)
    rng = np.random.default_rng(seed + 1)
    z = rng.standard_normal((n, d_latent)).astype(np.float32)
    difficulty = rng.uniform(0, 1, n).astype(np.float32)
    noise_scale = noise_lo + (noise_hi - noise_lo) * difficulty
    items: Dict[str, np.ndarray] = {}
    for t in cfg.towers:
        W = world.standard_normal((d_latent, t.n_tokens, t.d_input or 1)).astype(np.float32)
        obs = np.einsum("nz,ztd->ntd", z, W)
        if t.modality == "text" and t.vocab:
            # discrete text: low-noise "caption" tokenization
            obs = obs + 0.1 * rng.standard_normal(obs.shape).astype(np.float32)
            Wv = world.standard_normal((obs.shape[-1], t.vocab)).astype(np.float32)
            # argmax over the vocab in item chunks: at a 49k vocab the whole
            # (n, T, vocab) product would take gigabytes; each entry is the
            # same product either way
            items[t.modality] = np.concatenate(
                [np.argmax(obs[i:i + _ARGMAX_ROWS] @ Wv, axis=-1)
                 for i in range(0, n, _ARGMAX_ROWS)]).astype(np.int32)
        else:
            obs = obs + noise_scale[:, None, None] * rng.standard_normal(
                obs.shape).astype(np.float32)
            items[t.modality] = obs.astype(np.float32)
    return MultimodalData(items=items, difficulty=difficulty, latent=z)


def clustered_sphere(rng: np.random.Generator, n: int,
                     n_centers: Optional[int] = None, dim: int = 256, *,
                     spread: float = 0.12,
                     centers: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Blob mixture on the unit sphere: unit-norm centers plus per-component
    noise ``spread``. Keep the noise norm ``spread * sqrt(dim)`` below the
    ~sqrt(2) distance between centers (e.g. ``spread = 0.03`` at dim 1024),
    or the "clusters" are effectively uniform. Pass ``centers`` to draw more
    points (e.g. queries) from an existing mixture. Returns ((n, dim)
    unit-norm fp32 points, the centers)."""
    if centers is None:
        centers = rng.standard_normal((n_centers, dim)).astype(np.float32)
        centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    dim = centers.shape[1]
    x = centers[rng.integers(0, len(centers), n)] + \
        spread * rng.standard_normal((n, dim)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x.astype(np.float32), centers


def lm_tokens(seed: int, n_seqs: int, seq_len: int, vocab: int,
              order: int = 2) -> np.ndarray:
    """(n_seqs, seq_len) int32 tokens: each context of the last two
    tokens prefers ~8 next tokens, with 10 % uniform noise."""
    rng = np.random.default_rng(seed)
    n_ctx = min(4096, vocab * vocab)
    pref = rng.integers(0, vocab, size=(n_ctx, 8))
    toks = np.empty((n_seqs, seq_len), np.int32)
    toks[:, :order] = rng.integers(0, vocab, size=(n_seqs, order))
    for t in range(order, seq_len):
        ctx = (toks[:, t - 1] * 31 + toks[:, t - 2] * 17) % n_ctx
        choice = rng.integers(0, 8, size=n_seqs)
        noise = rng.random(n_seqs) < 0.1
        nxt = pref[ctx, choice]
        nxt = np.where(noise, rng.integers(0, vocab, size=n_seqs), nxt)
        toks[:, t] = nxt
    return toks


# ---------------------------------------------------------------------------
# Criteo-like (DLRM)
# ---------------------------------------------------------------------------


def criteo_like(seed: int, n: int, cfg: RecsysConfig) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    dense = rng.standard_normal((n, cfg.n_dense)).astype(np.float32)
    sparse = np.stack(
        [np.minimum(rng.zipf(1.3, size=n) - 1, v - 1)
         for v in cfg.table_vocabs], axis=1).astype(np.int32)
    w_d = rng.standard_normal(cfg.n_dense).astype(np.float32)
    field_w = rng.standard_normal((len(cfg.table_vocabs), 64)).astype(np.float32)
    id_hash = ((sparse.astype(np.int64) * 2654435761) % 97) / 97.0 - 0.5
    score = dense @ w_d + (id_hash * field_w[:, 0][None, :]).sum(-1)
    label = (score + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    return {"dense": dense, "sparse": sparse, "label": label}


# ---------------------------------------------------------------------------
# SBM graphs (GNN)
# ---------------------------------------------------------------------------


def sbm_graph(seed: int, n_nodes: int, n_classes: int, d_feat: int,
              avg_degree: float = 8.0, homophily: float = 0.85
              ) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, n_classes, n_nodes).astype(np.int32)
    n_edges = int(n_nodes * avg_degree)
    src = rng.integers(0, n_nodes, n_edges * 2)
    dst = np.empty_like(src)
    same = rng.random(len(src)) < homophily
    # same-class partner: pick random node of same class via sorted buckets
    order = np.argsort(labels, kind="stable")
    class_start = np.searchsorted(labels[order], np.arange(n_classes))
    class_end = np.append(class_start[1:], n_nodes)
    cls = labels[src]
    lo, hi = class_start[cls], class_end[cls]
    same_pick = order[(lo + rng.integers(0, np.maximum(hi - lo, 1)))
                      % np.maximum(hi, 1)]
    rand_pick = rng.integers(0, n_nodes, len(src))
    dst = np.where(same, same_pick, rand_pick).astype(np.int64)
    keep = src != dst
    src, dst = src[keep][:n_edges], dst[keep][:n_edges]
    # symmetric
    src2 = np.concatenate([src, dst])
    dst2 = np.concatenate([dst, src])
    centers = rng.standard_normal((n_classes, d_feat)).astype(np.float32)
    feat = centers[labels] + 1.5 * rng.standard_normal((n_nodes, d_feat)).astype(np.float32)
    return {"node_feat": feat, "src": src2.astype(np.int32),
            "dst": dst2.astype(np.int32), "labels": labels}


# ---------------------------------------------------------------------------
# RecSys sequences (BST / SASRec / DIEN)
# ---------------------------------------------------------------------------


def seq_recsys(seed: int, n: int, cfg: RecsysConfig,
               n_factors: int = 8) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng(seed)
    V, S = cfg.item_vocab, cfg.seq_len
    item_f = rng.standard_normal((V, n_factors)).astype(np.float32)
    user_f = rng.standard_normal((n, n_factors)).astype(np.float32)
    # history: items with high user affinity (sampled via gumbel top-S trick
    # over a candidate pool to stay O(n * pool))
    pool = rng.integers(0, V, size=(n, 4 * S))
    aff = np.einsum("nf,npf->np", user_f, item_f[pool])
    g = rng.gumbel(size=aff.shape)
    idx = np.argsort(-(aff + g), axis=1)[:, :S]
    hist = np.take_along_axis(pool, idx, axis=1).astype(np.int32)
    target = rng.integers(0, V, size=n).astype(np.int32)
    t_aff = np.einsum("nf,nf->n", user_f, item_f[target])
    label = (t_aff + 0.5 * rng.standard_normal(n) > 0).astype(np.float32)
    out = {"hist": hist, "target": target, "label": label}
    if cfg.kind == "bst":
        from repro_torch.models.recsys import BST_OTHER_DIM
        out["other"] = rng.standard_normal((n, BST_OTHER_DIM)).astype(np.float32)
    if cfg.kind == "sasrec":
        out["pos"] = np.roll(hist, -1, axis=1).astype(np.int32)
        out["neg"] = rng.integers(0, V, size=(n, S)).astype(np.int32)
    if cfg.kind == "dien":
        n_cate = max(cfg.item_vocab // 100, 16)
        out["hist_cate"] = (hist % n_cate).astype(np.int32)
        out["target_cate"] = (target % n_cate).astype(np.int32)
    return out
