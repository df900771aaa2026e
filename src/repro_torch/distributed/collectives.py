"""Collectives of the port's single-process multi-device paths.

A collective over a mesh axis of N entries takes one tree (or tensor) an
entry, in the axis's order, each on its entry's device, and returns one an
entry, on that entry's device. Sums run in entry order on the first entry's
device, so the same inputs give the same bits on the CPU and on a card.

* ``psum_scatter_tree``: ZeRO-2-style gradient sync, a reduce-scatter of
  every leaf along its leading dim (entry s keeps its 1/N of the summed
  rows).
* ``compressed_psum``: an int8-quantized all-reduce with per-row scales
  and error feedback (the residual is carried to the next step).
* ``flash_decode_seqparallel``: decode attention with the KV cache split
  along the sequence; each shard computes partial (max, sum, o) and the
  three are combined, never the cache.
* ``topk_allgather_merge``: the distributed retrieval merge. Each shard of
  the device bank scans its own rows and contributes a (Q, k_loc)
  candidate set; the sets are gathered in shard order on the first shard's
  device (the wire moves the k winners, never the bank or the score
  matrix) and re-ranked to the global (Q, k).
"""
from __future__ import annotations

import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.quantize import dequantize_int8, quantize_int8
from repro_torch.distributed.mesh_utils import Mesh, tree_map


def _sum_in_order(xs: Sequence[torch.Tensor]) -> torch.Tensor:
    """x_0 + x_1 + ... + x_{N-1}, left to right, on x_0's device."""
    acc = xs[0].clone()
    for x in xs[1:]:
        acc.add_(x.to(acc.device))
    return acc


def _per_entry(fn: Callable, trees: Sequence[Any], *more) -> List[Any]:
    """Apply ``fn(*leaves of every entry)`` -> one output an entry, leaf by
    leaf, and split the result into one tree an entry."""
    per_leaf = tree_map(fn, trees[0], *trees[1:], *more)
    return [tree_map(lambda out: out[s], per_leaf) for s in range(len(trees))]


def psum_scatter_tree(trees: Sequence[Any]) -> List[Any]:
    """Reduce-scatter every leaf along its leading dim over the N entries
    of ``trees``: entry s gets rows [s·n/N, (s+1)·n/N) of the sum (the
    reference's ``tiled=True``); a 0-d leaf, or one whose leading dim N does
    not divide, gets the whole sum on every entry."""
    n = len(trees)

    def f(*gs):
        total = _sum_in_order(gs)
        if total.ndim == 0 or total.shape[0] % n:
            return [total.to(g.device, copy=True) for g in gs]
        rows = total.shape[0] // n
        return [total[s * rows:(s + 1) * rows].to(g.device, copy=True)
                for s, g in enumerate(gs)]
    return _per_entry(f, trees)


def compressed_psum(trees: Sequence[Any],
                    error_states: Optional[Sequence[Any]] = None
                    ) -> Tuple[List[Any], List[Any]]:
    """Int8 all-reduce with error feedback over the N entries of ``trees``.
    Returns (summed, errors), one tree an entry each, shaped as the leaves.

    Each entry quantizes g + e (e its error state, or none) to int8 per row
    of ``flat`` ((1, -1) for a leaf of ndim <= 1, else (shape[0], -1)); the
    dequantized locals are summed in entry order; the new error is flat
    minus the entry's dequantized local."""
    n = len(trees)
    if error_states is None:
        error_states = [tree_map(lambda _: None, t) for t in trees]

    def f(*args):
        gs, es = args[:n], args[n:]
        locs, errs = [], []
        for g, e in zip(gs, es):
            g32 = g.float() + (0.0 if e is None else e)
            flat = g32.reshape(1, -1) if g32.ndim <= 1 else \
                g32.reshape(g32.shape[0], -1)
            local = dequantize_int8(*quantize_int8(flat))
            errs.append((flat - local).reshape(g32.shape))
            locs.append(local)
        summed = _sum_in_order(locs).reshape(gs[0].shape)
        return [(summed.to(g.device, copy=True), err)
                for g, err in zip(gs, errs)]

    per_entry = _per_entry(f, trees, *error_states)
    summed = [tree_map(lambda o: o[0], t) for t in per_entry]
    errors = [tree_map(lambda o: o[1], t) for t in per_entry]
    return summed, errors


def flash_decode_seqparallel(mesh: Mesh, axis: str) -> Callable:
    """Returns fn(q (B, H, D), k_pieces, v_pieces, lengths (B,)) -> one
    (B, H, D) output an entry along ``axis`` (in q's dtype, on the entry's
    device): exact attention of each query over the cache whose S is split
    into ``mesh.shape[axis]`` equal pieces (B, S_loc, KV, D), entry s
    holding positions [s·S_loc, (s+1)·S_loc).

    The reference's arithmetic: each shard's partial (max, sum, o) in f32,
    masked scores -1e30 (a shard with no valid key gives exp(0) weights,
    which corr = exp(m - m_g) zeroes; a row with no valid key at all comes
    out as the mean of V), combined as max, Σ l·corr and Σ o·corr in entry
    order, o / max(l, 1e-30)."""
    n_shards = mesh.shape[axis]

    def partial_attn(q, k, v, lengths, shard_id):
        B, H, D = q.shape
        S, KV = k.shape[1], k.shape[2]
        qg = q.reshape(B, KV, H // KV, D).float()
        s = torch.einsum("bkgd,bjkd->bkgj", qg, k.float()) * (1.0 / math.sqrt(D))
        pos = shard_id * S + torch.arange(S, device=k.device)[None, :]
        valid = pos < lengths[:, None]
        s = torch.where(valid[:, None, None, :], s, -1e30)
        m = torch.amax(s, dim=-1)                    # (B, KV, G)
        p = torch.exp(s - m[..., None])
        l = torch.sum(p, dim=-1)
        o = torch.einsum("bkgj,bjkd->bkgd", p, v.float())
        return m, l, o

    def fn(q, k_pieces, v_pieces, lengths):
        if len(k_pieces) != n_shards or len(v_pieces) != n_shards:
            raise ValueError(f"{len(k_pieces)} K and {len(v_pieces)} V "
                             f"pieces for the {n_shards} entries of "
                             f"{axis!r}")
        if len({k.shape[1] for k in k_pieces}) != 1:
            raise ValueError("the cache's pieces must split S evenly")
        parts = [partial_attn(q.to(k.device), k, v, lengths.to(k.device), s)
                 for s, (k, v) in enumerate(zip(k_pieces, v_pieces))]
        dev = k_pieces[0].device
        ms = [m.to(dev) for m, _, _ in parts]
        m_g = ms[0]
        for m in ms[1:]:
            m_g = torch.maximum(m_g, m)
        corr = [torch.exp(m - m_g) for m in ms]
        l_g = _sum_in_order([l.to(dev) * c for (_, l, _), c in zip(parts, corr)])
        o_g = _sum_in_order([o.to(dev) * c[..., None]
                             for (_, _, o), c in zip(parts, corr)])
        out = o_g / torch.clamp_min(l_g[..., None], 1e-30)
        B, KV, G, D = out.shape
        out = out.reshape(B, KV * G, D).to(q.dtype)
        return [out.to(k.device, copy=True) for k in k_pieces]

    return fn


def topk_allgather_merge(scores: Sequence[torch.Tensor],
                         ids: Sequence[torch.Tensor], k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k sets: ``scores[s]`` / ``ids[s]`` are shard s's
    (Q, k_loc) best scores, descending, and their GLOBAL ids. Returns the
    global (Q, k) best on the first shard's device, descending. The
    concatenation is in shard order and the sort stable, so of equal
    scores the one from the lower shard (the lower global row) comes
    first, as the top-k over one unsharded bank orders them."""
    dev = scores[0].device
    all_s = torch.cat([s.to(dev) for s in scores], dim=1)
    all_i = torch.cat([i.to(dev) for i in ids], dim=1)
    top_s, sel = torch.sort(all_s, dim=1, descending=True, stable=True)
    return top_s[:, :k], torch.gather(all_i, 1, sel[:, :k])
