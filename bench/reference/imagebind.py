"""Plain reference of an ImageBind-style encoder tower (arXiv:2305.05665),
as the recall-imagebind configuration runs it: a stub frontend (patch
features through ``proj_in``, or caption tokens through ``tok_emb``), a
CLS token and learned positions, then pre-norm bidirectional layers
(RMSNorm, multi-head attention, SwiGLU); the pooled state of a layer is
its CLS row, and an exit at depth e embeds the CLS row after layer e
through the shared exit head. Float32 throughout (a bfloat16 weight is
widened exactly); ``prec`` lowers the products for the controls.
"""
from __future__ import annotations

from typing import Dict, Iterable, Optional

import torch

from bench.reference import layers as RL
from bench.reference.precision import matmul


def frontend(tp: Dict, inputs: torch.Tensor, prec: str = "fp32"
             ) -> torch.Tensor:
    """(B, T, d_in) features or (B, T) token ids -> (B, T + 1, d)."""
    if "tok_emb" in tp:
        table = tp["tok_emb"]
        x = table.float()[inputs.long().clamp(0, table.shape[0] - 1)]
    else:
        B, T, d_in = inputs.shape
        x = matmul(inputs.reshape(B * T, d_in), tp["proj_in"], prec
                   ).reshape(B, T, -1)
    B, _, d = x.shape
    cls = tp["cls"].float()[None].expand(B, 1, d)
    x = torch.cat([cls, x], dim=1)
    return x + tp["pos"].float()[None, :x.shape[1]]


def run_layers(tp: Dict, x: torch.Tensor, start: int, end: int, *,
               n_heads: int, eps: float, prec: str = "fp32"
               ) -> Iterable[torch.Tensor]:
    """Yield the hidden state after each of layers [start, end)."""
    lp = tp["layers"]
    for i in range(start, end):
        x = RL.layer(lp, i, x, eps=eps, causal=False, prec=prec)
        yield x


def tower(tp: Dict, inputs: Optional[torch.Tensor], *, n_heads: int,
          eps: float, end: int, start: int = 0,
          h: Optional[torch.Tensor] = None, prec: str = "fp32",
          keep_h: Iterable[int] = ()) -> Dict:
    """Layers [start, end) from ``inputs`` (start 0) or from the hidden
    state ``h`` after layer ``start``: {"cls": (end - start, B, d) the CLS
    row after each layer, "h": {layer: (B, S, d)} the states after the
    layers in ``keep_h``, "last": the state after layer end}."""
    x = frontend(tp, inputs, prec) if h is None else h.float()
    keep = set(keep_h)
    cls, hs = [], {}
    for i, x in enumerate(run_layers(tp, x, start, end, n_heads=n_heads,
                                     eps=eps, prec=prec), start + 1):
        cls.append(x[:, 0])
        if i in keep:
            hs[i] = x
    return {"cls": torch.stack(cls) if cls else None, "h": hs, "last": x}


def exit_layers(n_layers: int, interval: int) -> tuple:
    """1-indexed exit depths: every ``interval`` layers and the last."""
    exits = list(range(interval, n_layers, interval))
    if not exits or exits[-1] != n_layers:
        exits.append(n_layers)
    return tuple(exits)
