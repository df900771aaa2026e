"""Exit-label supervision (paper §3.2, "data-aware coarse-grained embedding
granularity").

The ground-truth exit for sample x is the *earliest* exit i whose coarse
embedding C_x^i retrieves x's own fine-grained embedding F_x from the corpus
(top-1 self-retrieval). Samples that never succeed get the final exit.
"""
from __future__ import annotations

from typing import Tuple

import torch


def self_retrieval_success(exit_embs: torch.Tensor,
                           fine_embs: torch.Tensor) -> torch.Tensor:
    """exit_embs (n_exits, N, E) coarse; fine_embs (N, E).
    Returns (n_exits, N) bool: does C_x^i's nearest fine embedding == F_x?"""
    sims = torch.einsum("ine,me->inm", exit_embs.float(), fine_embs.float())
    nearest = torch.argmax(sims, dim=-1)  # first maximum, like jnp.argmax
    return nearest == torch.arange(exit_embs.shape[1],
                                   device=exit_embs.device)[None, :]


def optimal_exit_labels(exit_embs: torch.Tensor,
                        fine_embs: torch.Tensor) -> torch.Tensor:
    """(N,) int32 index into the exit list: earliest self-retrieving exit."""
    success = self_retrieval_success(exit_embs, fine_embs)  # (n_exits, N)
    n_exits = exit_embs.shape[0]
    first = torch.argmax(success.to(torch.int8), dim=0)  # first True (or 0)
    any_ok = success.any(dim=0)
    return torch.where(any_ok, first,
                       torch.full_like(first, n_exits - 1)).to(torch.int32)


def exit_histogram(labels: torch.Tensor, n_exits: int) -> torch.Tensor:
    return torch.bincount(labels.long(), minlength=n_exits)[:n_exits]


def mean_exit_depth(labels: torch.Tensor, exits: Tuple[int, ...]) -> torch.Tensor:
    depths = torch.tensor(exits, dtype=torch.float32, device=labels.device)
    return depths[labels.long()].mean()


def retrieval_at_k(query_embs: torch.Tensor, corpus_embs: torch.Tensor,
                   targets: torch.Tensor, k: int = 1) -> torch.Tensor:
    """R@k: the fraction of queries whose target is among the top-k corpus
    matches (ties to the lower index, as ``jax.lax.top_k``).
    query_embs (Q, E); corpus_embs (M, E); targets (Q,) int."""
    sims = query_embs.float() @ corpus_embs.float().T
    idx = torch.sort(sims, dim=-1, descending=True, stable=True).indices
    hit = (idx[:, :k] == targets.long()[:, None]).any(dim=-1)
    return hit.float().mean()
