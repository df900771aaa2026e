"""The pre-exit predictor (RECALL §3.2) in plain torch: an MLP d -> hidden
-> n_exits on the L2-normalized pooled state after the superficial layers,
tanh-approximated GELU between, in the port's layout (``w0``, ``b0``,
``w1``, ``b1``; float32). ``exit_labels`` and ``fit`` make the predictor
the benchmark hands to the program: labels that map each calibration
photo's difficulty to an exit by a monotone rule whose mean is a stated
depth, and a full-batch Adam fit to them.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from bench.reference.layers import l2_normalize
from bench.reference.precision import matmul


def logits(p: Dict, feats: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    x = feats.float()
    x = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True),
                            1e-6)
    x = matmul(x, p["w0"], prec) + p["b0"].float()
    x = torch.nn.functional.gelu(x, approximate="tanh")
    return matmul(x, p["w1"], prec) + p["b1"].float()


def exit_labels(difficulty: np.ndarray, exits: Sequence[int],
                mean_depth: float) -> np.ndarray:
    """Exit index per item: items ranked by difficulty take the exits in
    order, exit j a share proportional to exp(lam * j), with lam set so
    that the mean exit depth is ``mean_depth``."""
    exits = np.asarray(exits, np.float64)
    j = np.arange(len(exits))

    def mean_for(lam):
        w = np.exp(lam * (j - j.mean()))
        return float((w / w.sum()) @ exits)

    lo, hi = -20.0, 20.0
    for _ in range(100):
        mid = (lo + hi) / 2
        lo, hi = (mid, hi) if mean_for(mid) < mean_depth else (lo, mid)
    w = np.exp(lo * (j - j.mean()))
    cum = np.cumsum(w / w.sum())
    n = len(difficulty)
    rank = np.empty(n, np.int64)
    rank[np.argsort(difficulty, kind="stable")] = np.arange(n)
    q = (rank + 0.5) / n
    return np.minimum(np.searchsorted(cum, q), len(exits) - 1)


def fit(feats: torch.Tensor, labels: torch.Tensor, *, hidden: int,
        n_exits: int, seed: int, steps: int = 400, lr: float = 3e-3,
        betas=(0.9, 0.999), eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """Full-batch Adam on the cross-entropy of ``labels``, written out
    (``torch.optim`` loads the compiler stack on its first step, seconds
    of set-up); weights drawn from ``seed`` on the features' device."""
    dev = feats.device
    g = torch.Generator(device=dev).manual_seed(int(seed))
    d = feats.shape[-1]
    p = {"w0": torch.randn(d, hidden, generator=g, device=dev) / d ** 0.5,
         "b0": torch.zeros(hidden, device=dev),
         "w1": torch.randn(hidden, n_exits, generator=g, device=dev)
         / hidden ** 0.5,
         "b1": torch.zeros(n_exits, device=dev)}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    s = {k: torch.zeros_like(v) for k, v in p.items()}
    x = l2_normalize(feats.float()).detach()
    y = labels.long()
    b1, b2 = betas
    for t in range(1, steps + 1):
        with torch.enable_grad():
            leaves = {k: v.requires_grad_(True) for k, v in p.items()}
            loss = torch.nn.functional.cross_entropy(logits(leaves, x), y)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                den = (s[k] / (1 - b2 ** t)).sqrt_().add_(eps)
                p[k] = (v.detach() - lr * (m[k] / (1 - b1 ** t)) / den)
    return {k: v.detach() for k, v in p.items()}
