"""Transformer encoder stack with Recall exits (the reference's encoder path).

Layer parameters are *stacked* (leading ``n_layers`` dim, the reference's
layout); ``forward_hidden`` runs layers ``[layer_start, layer_end)`` as a
Python loop over that dim, which is how coarse (early-exited) encoding and
live-encoder refinement (paper §3.4) reuse one weight set. Attention goes
through the flash kernel's dispatch and both norms through the rmsnorm
kernel's; the QKV, O and SwiGLU projections are plain ``torch.matmul``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig, RecallConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema


def lm_schema(cfg: LMConfig, recall: RecallConfig, *,
              embed_out: int = 1024) -> Schema:
    """Encoder schema (the reference's ``lm_schema`` without an lm_head)."""
    Ld = (cfg.n_layers,)
    layer: Schema = {
        "norm1": L.rmsnorm_schema(cfg.d_model, Ld),
        "norm2": L.rmsnorm_schema(cfg.d_model, Ld),
        "attn": L.attn_schema(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim, cfg.qkv_bias, layer_dims=Ld),
        "mlp": L.swiglu_schema(cfg.d_model, cfg.d_ff, layer_dims=Ld),
    }
    return {
        "embed": L.embed_schema(cfg.vocab, cfg.d_model),
        "layers": layer,
        "final_norm": L.rmsnorm_schema(cfg.d_model),
        # Recall exit head: shared across exits, left untuned during healing.
        "exit_head": {
            "norm": L.rmsnorm_schema(cfg.d_model),
            "proj": ParamDef((cfg.d_model, embed_out), ("embed", "act_embed"),
                             "fan_in"),
        },
    }


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked-layer param dict."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def _proj_qkv(p: Schema, x: torch.Tensor):
    """x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd), contiguous."""
    B, S, d = x.shape
    out = []
    for name, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        w = p[name].to(x.dtype)                          # (d, H, hd)
        y = (x.reshape(B * S, d) @ w.reshape(d, -1)).view(B, S, *w.shape[1:])
        if bias in p:
            y = y + p[bias].to(x.dtype)
        out.append(y)
    return tuple(out)


def _attn_out(p: Schema, o: torch.Tensor) -> torch.Tensor:
    B, S, H, hd = o.shape
    wo = p["wo"].to(o.dtype)                             # (H, hd, d)
    return (o.reshape(B * S, H * hd) @ wo.reshape(H * hd, -1)).view(B, S, -1)


def _swiglu(p: Schema, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w_gate"].to(x.dtype)
    u = x @ p["w_up"].to(x.dtype)
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ p["w_down"].to(x.dtype)


def layer_full(pl_: Schema, x: torch.Tensor, cfg: LMConfig, *,
               window: int) -> torch.Tensor:
    """Self-attention layer over the full (own) sequence."""
    h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
    q, k, v = _proj_qkv(pl_["attn"], h)
    o = flash_attention(q, k, v, causal=cfg.causal, window=window)
    x = x + _attn_out(pl_["attn"], o)
    h2 = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
    return x + _swiglu(pl_["mlp"], h2)


def forward_hidden(params: Schema, cfg: LMConfig, recall: RecallConfig, *,
                   embeds: torch.Tensor,
                   layer_start: int = 0, layer_end: Optional[int] = None,
                   collect_pooled: bool = False, pool: str = "mean",
                   window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Run layers [layer_start, layer_end) on ``embeds`` (B, S, d). Returns
    {"h": (B, S, d) final hidden, "pooled": (L', B, d) per-layer pooled
    hidden (if collect_pooled)}."""
    if cfg.rope_theta > 0:
        raise NotImplementedError("RoPE belongs to the LM path, which is not "
                                  "ported yet: ROADMAP queue A, model zoo")
    if pool not in ("cls", "mean"):
        raise ValueError(f"pool={pool!r}")
    x = embeds
    layer_end = cfg.n_layers if layer_end is None else layer_end
    window = cfg.window if window is None else window
    pooled = []
    for i in range(layer_start, layer_end):
        x = layer_full(layer_slice(params["layers"], i), x, cfg,
                       window=window)
        if collect_pooled:
            p = x[:, 0] if pool == "cls" else x.float().mean(1).to(x.dtype)
            pooled.append(p)
    out = {"h": x}
    if collect_pooled:
        out["pooled"] = torch.stack(pooled) if pooled else \
            x.new_zeros((0,) + x.shape[:1] + x.shape[2:])
    return out


def exit_embedding(params: Schema, pooled: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """pooled (..., d) -> L2-normalized embedding (..., E) via the shared
    exit head, in fp32."""
    h = L.rmsnorm(pooled, params["exit_head"]["norm"], eps)
    e = h.float() @ params["exit_head"]["proj"].float()
    return L.l2_normalize(e)
