"""Collectives of the port's single-process multi-device paths.

* ``topk_allgather_merge``: the distributed retrieval merge. Each shard of
  the device bank scans its own rows and contributes a (Q, k_loc)
  candidate set; the sets are gathered in shard order on the first shard's
  device (the wire moves the k winners, never the bank or the score
  matrix) and re-ranked to the global (Q, k).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


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
