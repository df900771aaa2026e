"""Plain reference of a Qwen2 decoder's prefill (arXiv:2407.10671): token
embedding, pre-norm layers (RMSNorm; QKV projections with biases, RoPE on
q and k, causal grouped-query attention; SwiGLU), as the port's prefill
runs it with RECALL's exits: after every exit layer the mean over the
prompt of the hidden state goes through the shared exit head. No logits:
the prefill step computes none. Float32; ``prec`` lowers the products
for the control.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from bench.reference import layers as RL


def prefill(params: Dict, tokens: torch.Tensor, *, n_layers: int,
            eps: float, rope_theta: float, exits: Sequence[int],
            on_kv: Callable[[int, torch.Tensor, torch.Tensor], None],
            prec: str = "fp32") -> torch.Tensor:
    """Run the prompt ``tokens`` (B, S); ``on_kv(layer, k, v)`` gets each
    layer's (B, S, KV, hd) keys (after RoPE) and values as they come.
    Returns the exit embeddings (n_exits, B, E)."""
    table = params["embed"]
    x = table.float()[tokens.long().clamp(0, table.shape[0] - 1)]
    pooled = []
    for i in range(n_layers):
        kv = []
        x = RL.layer(params["layers"], i, x, eps=eps, causal=True,
                     prec=prec, rope_theta=rope_theta, kv_out=kv)
        on_kv(i, *kv[0])
        del kv
        if i + 1 in exits:
            pooled.append(x.mean(dim=1))
    return RL.exit_embedding(params, torch.stack(pooled), eps, prec)
