"""Data-aware pre-exit predictor (paper §3.2).

A lightweight MLP reads the *superficial embedding* (pooled hidden state
after the first N layers) and predicts the sample's exit bucket before the
rest of the model runs, turning ragged per-sample exits into statically
schedulable exit groups. Trained self-supervised from ``core.exits`` labels
with torch autograd and the port's AdamW.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models.layers import Schema
from repro_torch.optim.adamw import AdamW


def predictor_schema(d_in: int, hidden: int, n_exits: int) -> Schema:
    return L.mlp_schema((d_in, hidden, n_exits))


def predictor_init(gen: torch.Generator, d_in: int, hidden: int,
                   n_exits: int, device="cuda"):
    return L.init_params(gen, predictor_schema(d_in, hidden, n_exits),
                         device=device)


def predictor_logits(params: Schema, feats: torch.Tensor) -> torch.Tensor:
    x = feats.float()
    x = x / torch.clamp_min(torch.linalg.norm(x, dim=-1, keepdim=True), 1e-6)
    return L.mlp_apply(params, x, act=L.gelu)


def predict_exit(params: Schema, feats: torch.Tensor, *, bias: int = 0,
                 n_exits: int = 0) -> torch.Tensor:
    """(N,) predicted exit bucket. ``bias`` shifts predictions later (safer
    exits at the cost of compute)."""
    with torch.no_grad():
        pred = torch.argmax(predictor_logits(params, feats), dim=-1)
    if bias:
        pred = torch.clamp(pred + bias, 0, n_exits - 1)
    return pred.to(torch.int32)


def _loss(params, feats, labels, label_smooth: float = 0.05):
    logits = predictor_logits(params, feats)
    n = logits.shape[-1]
    onehot = torch.nn.functional.one_hot(labels.long(), n).float()
    soft = onehot * (1 - label_smooth) + label_smooth / n
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.sum(soft * logp, dim=-1))


def train_predictor(gen: Optional[torch.Generator], feats: torch.Tensor,
                    labels: torch.Tensor, *, hidden: int = 256, n_exits: int,
                    steps: int = 200, lr: float = 3e-3, batch: int = 256,
                    params: Optional[Schema] = None) -> Tuple[Schema, Dict]:
    """Few-iteration supervised fit (cheap by construction, paper §3.2).
    Starts from ``params`` when given (e.g. carried across from the
    reference), else from a fresh init drawn from ``gen``. Batches are drawn
    by ``np.random.default_rng(0)``, as in the reference."""
    device = feats.device
    if params is None:
        params = predictor_init(gen, feats.shape[-1], hidden, n_exits,
                                device=device)
    opt = AdamW(lr=lr, weight_decay=1e-4, clip_norm=1.0)
    state = opt.init(params)
    n = feats.shape[0]
    feats = feats.detach()
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, n, size=min(batch, n)),
                              device=device)
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = _loss(leaves, feats[idx], labels[idx])
        grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                     list(leaves.values()))))
        params, state, _ = opt.update(grads, state, leaves)
        params = {k: v.detach() for k, v in params.items()}
        losses.append(float(loss.detach()))

    pred = predict_exit(params, feats)
    lab = labels.to(pred.dtype)
    acc = float((pred == lab).float().mean())
    # "within one bucket" accuracy — near misses matter for the average layer
    near = float(((pred - lab).abs() <= 1).float().mean())
    return params, {"loss": losses[-1], "acc": acc, "acc_within1": near,
                    "n_params": L.count_params(params)}
