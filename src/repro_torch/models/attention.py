"""The LM stack's attention kinds, one picked per config by ``kind(cfg)``:
GQA (MHA included) and MLA. Each gives its parameter ``schema``, its
caches' ``cache_names`` and ``cache_row`` (a cache is (L, B, S,
*cache_row)), ``full``: the attention half of a full-sequence layer on
the normed (B, S, d) -> (y, the rows the layer loop writes into the
layer's caches), and ``decode``: the same half of a one-token step, the
new token's rows written into the layer's caches in place.

MLA (DeepSeek-V3's block, ``configs.base.MLALMConfig``) caches one
latent row a token, [c_kv | k_pe] after c_kv's norm and k_pe's RoPE,
written inside the layer. Prefill up-projects [k_nope | v] per head for
the flash forward at q/k 192, v 128; decode attends in the absorbed form.
No LoRA (``core/plora``'s targets are GQA-shaped), no window at decode,
no training (its flash backward raises on CUDA).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema
from repro_torch.tracing import span


def _cache_row(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """The cache row of each sequence's new token (the reference's
    ``dynamic_update_slice_in_dim``: a negative index counts from the end,
    then clamped)."""
    at = lengths.long() - 1
    return torch.clamp(torch.where(at < 0, at + S, at), 0, S - 1)


def _attn_out(p: Schema, o: torch.Tensor, lora: Optional[Dict] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    B, S, H, hd = o.shape
    wo = p["wo"].to(o.dtype)                             # (H, hd, d)
    o2 = o.reshape(B * S, H * hd)
    y = (o2 @ wo.reshape(H * hd, -1)).view(B, S, -1)
    if lora and "wo" in lora:
        y = y + L.lora_delta(o2, lora["wo"], lora_scale).view(B, S, -1)
    return y


def _proj_qkv(p: Schema, x: torch.Tensor,
              positions: Optional[torch.Tensor] = None,
              rope_theta: float = 0.0, lora: Optional[Dict] = None,
              lora_scale: float = 0.0):
    """x (B, S, d) -> q (B,S,H,hd), k/v (B,S,KV,hd), contiguous; RoPE at
    ``positions`` (B, S) when ``rope_theta`` > 0."""
    B, S, d = x.shape
    lora = lora or {}
    out = []
    for name, bias in (("wq", "bq"), ("wk", "bk"), ("wv", "bv")):
        w = p[name].to(x.dtype)                          # (d, H, hd)
        y = (x.reshape(B * S, d) @ w.reshape(d, -1)).view(B, S, *w.shape[1:])
        if name in lora:
            y = y + L.lora_delta(x, lora[name], lora_scale)
        if bias in p:
            y = y + p[bias].to(x.dtype)
        out.append(y)
    q, k, v = out
    if rope_theta > 0:
        q = L.apply_rope(q, positions, rope_theta)
        k = L.apply_rope(k, positions, rope_theta)
    return q, k, v


class GQA:
    """Grouped-query attention; k and v cached per kv head."""

    cache_names = ("k_cache", "v_cache")

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        self.cache_row = (cfg.n_kv_heads, cfg.head_dim)

    def schema(self, layer_dims: Tuple[int, ...]) -> Schema:
        c = self.cfg
        return L.attn_schema(c.d_model, c.n_heads, c.n_kv_heads, c.head_dim,
                             c.qkv_bias, layer_dims=layer_dims)

    def full(self, p, h, positions, *, window, lora, lora_scale, cache):
        """-> (y, (k, v)): k and v are this layer's cache rows, written by
        the layer loop (outside a remat recompute)."""
        q, k, v = _proj_qkv(p, h, positions, self.cfg.rope_theta, lora,
                            lora_scale)
        o = flash_attention(q, k, v, causal=self.cfg.causal, window=window)
        return _attn_out(p, o, lora, lora_scale), (k, v)

    def decode(self, p, h, lengths, cache, *, window, lora, lora_scale):
        k_cache, v_cache = cache                         # (B, S, KV, hd)
        B, S = k_cache.shape[:2]
        positions = (lengths - 1)[:, None]
        q, k_new, v_new = _proj_qkv(p, h, positions, self.cfg.rope_theta,
                                    lora, lora_scale)
        rows = torch.arange(B, device=h.device)
        at = _cache_row(lengths, S)
        k_cache[rows, at] = k_new[:, 0]
        v_cache[rows, at] = v_new[:, 0]
        o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                             window=window)
        return _attn_out(p, o[:, None], lora, lora_scale)


def rope_deepseek(x: torch.Tensor, positions: torch.Tensor,
                  theta: float) -> torch.Tensor:
    """RoPE on x (..., S, heads, rope) as DeepSeek-V3's modeling file
    applies it: the rope dims read as interleaved pairs (even, odd),
    de-interleaved to [evens | odds], then rotated rotate-half
    (``apply_rope``). q's and k's rope parts take the same permutation,
    so the scores are those of the pairs rotated in place; the cache keeps
    k_pe in the de-interleaved layout."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    return L.apply_rope(x, positions, theta)


def _mla_q(p: Schema, x2: torch.Tensor, positions: torch.Tensor,
           cfg: LMConfig, B: int, S: int) -> torch.Tensor:
    """q (B, S, H, nope + rope) of x2 (B * S, d), RoPE on the rope part."""
    m = cfg.mla
    w = p["wq"].to(x2.dtype)
    q = (x2 @ w.reshape(w.shape[0], -1)).view(B, S, cfg.n_heads,
                                              m.qk_head_dim)
    q_pe = rope_deepseek(q[..., m.qk_nope_head_dim:], positions,
                         cfg.rope_theta)
    return torch.cat([q[..., :m.qk_nope_head_dim], q_pe], dim=-1)


def _mla_latent(p: Schema, x2: torch.Tensor, positions: torch.Tensor,
                cfg: LMConfig, B: int, S: int):
    """(c_kv (B, S, r) after its RMSNorm, k_pe (B, S, rope) after RoPE)."""
    m = cfg.mla
    ckv = (x2 @ p["w_kv_a"].to(x2.dtype)).view(B, S, m.latent_dim)
    c = L.rmsnorm(ckv[..., :m.kv_lora_rank].contiguous(), p["kv_norm"],
                  m.latent_norm_eps)
    k_pe = rope_deepseek(ckv[..., m.kv_lora_rank:][:, :, None], positions,
                         cfg.rope_theta)[:, :, 0]
    return c, k_pe


class MLA:
    """Multi-head latent attention; one latent row cached a token."""

    cache_names = ("latent_cache",)

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        self.cache_row = (cfg.mla.latent_dim,)

    def schema(self, Ld: Tuple[int, ...]) -> Schema:
        """``wq`` (d, H, nope + rope), ``w_kv_a`` (d, kv_lora_rank +
        rope), ``kv_norm`` (kv_lora_rank,), ``w_kv_b`` (kv_lora_rank, H,
        nope + v), ``wo`` (H, v, d)."""
        m, d, H = self.cfg.mla, self.cfg.d_model, self.cfg.n_heads
        la = tuple("layer" for _ in Ld)
        return {
            "wq": ParamDef(Ld + (d, H, m.qk_head_dim),
                           la + ("embed", "heads", "head_dim"), "fan_in"),
            "w_kv_a": ParamDef(Ld + (d, m.latent_dim),
                               la + ("embed", "kv_latent"), "fan_in"),
            "kv_norm": ParamDef(Ld + (m.kv_lora_rank,), la + ("kv_latent",),
                                "ones"),
            "w_kv_b": ParamDef(Ld + (m.kv_lora_rank, H,
                                     m.qk_nope_head_dim + m.v_head_dim),
                               la + ("kv_latent", "heads", "head_dim"),
                               "fan_in"),
            "wo": ParamDef(Ld + (H, m.v_head_dim, d),
                           la + ("heads", "head_dim", "embed"), "fan_in"),
        }

    def full(self, p, h, positions, *, window, lora, lora_scale, cache):
        """-> (y, ()): the tokens' [c_kv | k_pe] go into ``cache[0]`` (B,
        S' >= S, r + rope) at [:, :S], when given, between the down and the
        up projection; flash's scale is 1/sqrt(nope + rope)."""
        if lora:
            raise NotImplementedError("LoRA on an MLA layer")
        cfg, m = self.cfg, self.cfg.mla
        B, S, d = h.shape
        x2 = h.reshape(B * S, d)
        with span("mla.q"):
            q = _mla_q(p, x2, positions, cfg, B, S)
        with span("mla.kv_down"):
            c, k_pe = _mla_latent(p, x2, positions, cfg, B, S)
        if cache is not None:
            with span("mla.latent_write"):
                cache[0][:, :S, :m.kv_lora_rank] = c
                cache[0][:, :S, m.kv_lora_rank:] = k_pe
        with span("mla.kv_up"):
            w = p["w_kv_b"].to(h.dtype)
            kv = (c.reshape(B * S, -1) @ w.reshape(w.shape[0], -1)).view(
                B, S, cfg.n_heads, -1)
            nope = m.qk_nope_head_dim
            k = torch.cat([kv[..., :nope],
                           k_pe[:, :, None].expand(B, S, cfg.n_heads, -1)],
                          dim=-1)
            v = kv[..., nope:].contiguous()
        o = flash_attention(q, k, v, causal=cfg.causal, window=window)
        return _attn_out(p, o), ()

    def decode(self, p, h, lengths, cache, *, window, lora, lora_scale):
        """Attention over the first ``lengths`` latent rows in the absorbed
        form, in fp32: q_lat = q_nope W_UK (r wide), scores q_lat·c_kv +
        q_pe·k_pe at 1/sqrt(nope + rope), o = (p c_kv) W_UV, then W_o."""
        if lora:
            raise NotImplementedError("LoRA on an MLA layer")
        if window:
            raise NotImplementedError("MLA decode with a sliding window")
        cfg, m, (latent,) = self.cfg, self.cfg.mla, cache
        B, S = latent.shape[:2]
        r, nope = m.kv_lora_rank, m.qk_nope_head_dim
        positions = (lengths - 1)[:, None]
        h2 = h.reshape(B, -1)
        with span("mla.q"):
            q = _mla_q(p, h2, positions, cfg, B, 1)[:, 0].float()
        with span("mla.kv_down"):
            c, k_pe = _mla_latent(p, h2, positions, cfg, B, 1)
        with span("mla.latent_write"):
            rows = torch.arange(B, device=h.device)
            latent[rows, _cache_row(lengths, S)] = torch.cat(
                [c[:, 0], k_pe[:, 0]], -1).to(latent.dtype)
        with span("mla.kv_up"):
            w = p["w_kv_b"].float()                      # (r, H, nope + v)
            q_lat = torch.einsum("bhn,rhn->bhr", q[..., :nope],
                                 w[..., :nope])
            lat = latent.float()
            s = (torch.einsum("bhr,bsr->bhs", q_lat, lat[..., :r])
                 + torch.einsum("bhe,bse->bhs", q[..., nope:],
                                lat[..., r:])) * m.qk_head_dim ** -0.5
            live = torch.arange(S, device=h.device)[None, :] \
                < lengths.long()[:, None]
            s = s.masked_fill(~live[:, None, :], float("-inf"))
            o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, -1),
                                 lat[..., :r])
            o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., nope:])
        return _attn_out(p, o.to(h.dtype)[:, None])


def kind(cfg: LMConfig) -> Union[GQA, MLA]:
    """The config's attention kind: MLA for an ``MLALMConfig``, else GQA."""
    return MLA(cfg) if cfg.mla is not None else GQA(cfg)
