"""The LM stack's attention kinds: GQA (MHA included), MLA and KDA. A
config's layers take one kind (``kind(cfg)``: GQA or MLA), or, in a
hybrid (``configs.base.HybridLMConfig``), KDA at its ``kda_layers`` and
MLA at the rest: ``layer_stack(cfg, i)`` names layer i's parameter stack
and its position there. Each kind gives its parameter ``schema``, its
caches' ``cache_names`` and ``new_caches``, ``full``: the attention half
of a full-sequence layer on the normed (B, S, d) -> (y, the rows the layer
loop writes into the layer's caches), and ``decode``: the same half of a
one-token step, the layer's caches updated in place. GQA's and MLA's
caches are a row a token, (L, B, S, *cache_row); KDA's a state a
sequence.

MLA (DeepSeek-V3's block, ``configs.base.MLALMConfig``) caches one
latent row a token, [c_kv | k_pe] after c_kv's norm and k_pe's RoPE,
written inside the layer. Prefill up-projects [k_nope | v] per head for
the flash forward at q/k 192, v 128; decode attends in the absorbed form.
No LoRA (``core/plora``'s targets are GQA-shaped), no window at decode,
no training (its flash backward raises on CUDA). ``MLAConfig.nope``
(Kimi Linear's MLA layers) applies no RoPE.

KDA (Kimi Delta Attention, ``configs.base.KDAConfig``) caches a
sequence's recurrent state, (B, H, dk, dv) fp32 a layer, and the last
``conv_size - 1`` rows of the pre-convolution [q | k | v] projections.
Prefill runs the recurrence through ``kernels/kda`` (the chunked
kernel); decode is one plain fp32 step. The state assumes every
sequence of the batch advances together: a decode step appends one
token to each.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.kda.ops import kda_chunk
from repro_torch.models import layers as L
from repro_torch.models.layers import ParamDef, Schema
from repro_torch.tracing import span


def _cache_row(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """The cache row of each sequence's new token (the reference's
    ``dynamic_update_slice_in_dim``: a negative index counts from the end,
    then clamped)."""
    at = lengths.long() - 1
    return torch.clamp(torch.where(at < 0, at + S, at), 0, S - 1)


def _row_caches(att, n_layers: int, B: int, S: int, device):
    """A row-a-token kind's caches (n_layers, B, S, *its cache row), one
    per name in its ``cache_names``, zeroed, in the config's dtype."""
    return tuple(torch.zeros((n_layers, B, S) + att.cache_row,
                             dtype=L.torch_dtype(att.cfg.dtype),
                             device=device)
                 for _ in att.cache_names)


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

    def new_caches(self, n_layers: int, B: int, S: int, device):
        return _row_caches(self, n_layers, B, S, device)

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
    if m.nope:
        return q
    q_pe = rope_deepseek(q[..., m.qk_nope_head_dim:], positions,
                         cfg.rope_theta)
    return torch.cat([q[..., :m.qk_nope_head_dim], q_pe], dim=-1)


def _mla_latent(p: Schema, x2: torch.Tensor, positions: torch.Tensor,
                cfg: LMConfig, B: int, S: int):
    """(c_kv (B, S, r) after its RMSNorm, k_pe (B, S, rope) after RoPE, or
    as it is under ``nope``)."""
    m = cfg.mla
    ckv = (x2 @ p["w_kv_a"].to(x2.dtype)).view(B, S, m.latent_dim)
    c = L.rmsnorm(ckv[..., :m.kv_lora_rank].contiguous(), p["kv_norm"],
                  m.latent_norm_eps)
    if m.nope:
        return c, ckv[..., m.kv_lora_rank:]
    k_pe = rope_deepseek(ckv[..., m.kv_lora_rank:][:, :, None], positions,
                         cfg.rope_theta)[:, :, 0]
    return c, k_pe


class MLA:
    """Multi-head latent attention; one latent row cached a token."""

    cache_names = ("latent_cache",)

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        self.cache_row = (cfg.mla.latent_dim,)

    def new_caches(self, n_layers: int, B: int, S: int, device):
        return _row_caches(self, n_layers, B, S, device)

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


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SiLU of the causal depthwise convolution of x (B, S, C) with w (K,
    C), summed in fp32, zeros before the first token: y_t = sum_j w[j]
    x_{t - K + 1 + j} (the last tap on the token itself). A sequence at a
    time, so that each tap's multiply-add runs on contiguous rows."""
    wf = w.float()
    K, S = wf.shape[0], x.shape[1]
    y = x.float() * wf[K - 1]
    for j in range(1, min(K, S)):
        for b in range(x.shape[0]):
            y[b, j:].addcmul_(x[b, :-j], wf[K - 1 - j])
    return F.silu(y, inplace=True)


def _l2norm_heads(x: torch.Tensor, H: int) -> torch.Tensor:
    """x (..., H * d) fp32 -> (..., H, d), each head L2-normed (eps 1e-6
    inside the root, as the modeling file's)."""
    x = x.view(*x.shape[:-1], H, -1)
    return x * torch.rsqrt((x * x).sum(-1, keepdim=True) + 1e-6)


class KDA:
    """Kimi Delta Attention; a recurrent state and a conv tail cached a
    sequence."""

    cache_names = ("kda_state", "conv_state")

    def __init__(self, cfg: LMConfig):
        self.cfg = cfg
        self.k = cfg.kda

    def new_caches(self, n_layers: int, B: int, S: int, device):
        """(state (n, B, H, dk, dv) fp32, conv tail (n, B, conv_size - 1,
        3 H d) in the config's dtype), zeroed; S (the row caches' length)
        does not size them."""
        k = self.k
        return (torch.zeros((n_layers, B, k.n_heads, k.head_dim,
                             k.head_dim), dtype=torch.float32, device=device),
                torch.zeros((n_layers, B, k.conv_size - 1, 3 * k.width),
                            dtype=L.torch_dtype(self.cfg.dtype),
                            device=device))

    def schema(self, Ld: Tuple[int, ...]) -> Schema:
        """``wq``/``wk``/``wv`` (d, H, dk), ``conv_q``/``conv_k``/``conv_v``
        (conv_size, H, dk), ``w_fa`` (d, rank), ``w_fb`` (rank, H, dk),
        ``dt_bias`` (H, dk), ``a_log`` (H,), ``w_b`` (d, H), ``w_ga`` (d,
        rank), ``w_gb`` (rank, H, dv), ``b_g`` (H, dv), ``o_norm`` (dv,),
        ``wo`` (H, dv, d)."""
        k, d = self.k, self.cfg.d_model
        H, hd, r = k.n_heads, k.head_dim, k.gate_rank
        la = tuple("layer" for _ in Ld)
        heads = ("heads", "head_dim")

        def proj(shape, axes, init="fan_in"):
            return ParamDef(Ld + shape, la + axes, init)
        return {
            "wq": proj((d, H, hd), ("embed",) + heads),
            "wk": proj((d, H, hd), ("embed",) + heads),
            "wv": proj((d, H, hd), ("embed",) + heads),
            "conv_q": proj((k.conv_size, H, hd), ("conv",) + heads),
            "conv_k": proj((k.conv_size, H, hd), ("conv",) + heads),
            "conv_v": proj((k.conv_size, H, hd), ("conv",) + heads),
            "w_fa": proj((d, r), ("embed", "kda_rank")),
            "w_fb": proj((r, H, hd), ("kda_rank",) + heads),
            "dt_bias": proj((H, hd), heads, "zeros"),
            "a_log": proj((H,), ("heads",), "zeros"),
            "w_b": proj((d, H), ("embed", "heads")),
            "w_ga": proj((d, r), ("embed", "kda_rank")),
            "w_gb": proj((r, H, hd), ("kda_rank",) + heads),
            "b_g": proj((H, hd), heads, "zeros"),
            "o_norm": proj((hd,), ("head_dim",), "ones"),
            "wo": proj((H, hd, d), heads + ("embed",)),
        }

    def _proj(self, p: Schema, x2: torch.Tensor) -> torch.Tensor:
        """[q | k | v] (N, 3 H d) before the convolutions."""
        return torch.cat([x2 @ p[n].to(x2.dtype).reshape(x2.shape[1], -1)
                          for n in ("wq", "wk", "wv")], dim=-1)

    def _conv_w(self, p: Schema) -> torch.Tensor:
        return torch.cat([p[n].reshape(self.k.conv_size, -1)
                          for n in ("conv_q", "conv_k", "conv_v")], dim=-1)

    def _qkv(self, y: torch.Tensor, dtype):
        """The convolutions' SiLU outputs (..., 3 H d) fp32 -> q, k
        L2-normed and v, (..., H, d) each in ``dtype``."""
        H = self.k.n_heads
        q, k, v = y.split(self.k.width, dim=-1)
        return (_l2norm_heads(q, H).to(dtype), _l2norm_heads(k, H).to(dtype),
                v.reshape(*v.shape[:-1], H, -1).to(dtype))

    def _gates(self, p: Schema, x2: torch.Tensor):
        """(g (N, H, dk) fp32 the log-decay, beta (N, H) fp32)."""
        k = self.k
        f = (x2 @ p["w_fa"].to(x2.dtype)) @ \
            p["w_fb"].to(x2.dtype).reshape(k.gate_rank, -1)
        f = f.float().view(-1, k.n_heads, k.head_dim) + p["dt_bias"].float()
        g = -torch.exp(p["a_log"].float())[:, None] * F.softplus(f)
        beta = torch.sigmoid((x2 @ p["w_b"].to(x2.dtype)).float())
        return g, beta

    def _out(self, p: Schema, x2: torch.Tensor, o: torch.Tensor
             ) -> torch.Tensor:
        """o (N, H, dv) RMS-normed per head, gated by sigmoid(x W_ga W_gb +
        b_g) in fp32, then W_o -> (N, d) in x's dtype."""
        k = self.k
        gate = (x2 @ p["w_ga"].to(x2.dtype)) @ \
            p["w_gb"].to(x2.dtype).reshape(k.gate_rank, -1)
        gate = gate.float().view(-1, k.n_heads, k.head_dim) + p["b_g"].float()
        on = L.rmsnorm(o.to(x2.dtype).contiguous(), p["o_norm"], k.norm_eps)
        o = (on.float() * torch.sigmoid(gate)).to(x2.dtype)
        return o.reshape(o.shape[0], -1) @ \
            p["wo"].to(x2.dtype).reshape(k.width, -1)

    def full(self, p, h, positions, *, window, lora, lora_scale, cache):
        """-> (y, ()): with ``cache`` (state (B, H, dk, dv), conv tail (B,
        conv_size - 1, 3 H d)) the prompt's final state and its last
        pre-convolution rows are written there."""
        if lora:
            raise NotImplementedError("LoRA on a KDA layer")
        k = self.k
        B, S, d = h.shape
        x2 = h.reshape(B * S, d)
        with span("kda.proj"):
            pre = self._proj(p, x2).view(B, S, -1)
        with span("kda.conv"):
            q, kk, v = self._qkv(_causal_conv(pre, self._conv_w(p)), h.dtype)
        with span("kda.gate"):
            g, beta = self._gates(p, x2)
        with span("kda.chunk"):
            o, state = kda_chunk(q, kk, v, g.view(B, S, *g.shape[1:]),
                                 beta.view(B, S, -1).contiguous(),
                                 scale=k.head_dim ** -0.5)
        if cache is not None:
            with span("kda.state_write"):
                cache[0].copy_(state)
                n = min(S, k.conv_size - 1)
                cache[1].zero_()
                cache[1][:, k.conv_size - 1 - n:] = pre[:, S - n:]
        with span("kda.out"):
            y = self._out(p, x2, o.reshape(B * S, k.n_heads, -1))
        return y.view(B, S, d), ()

    def decode(self, p, h, lengths, cache, *, window, lora, lora_scale):
        """One token a sequence, in fp32: the conv tail and the new row
        through the convolutions, then S = Diag(exp g) S, S += beta k (v -
        S^T k)^T, o = S^T q / sqrt(dk); the state and the tail updated in
        place."""
        if lora:
            raise NotImplementedError("LoRA on a KDA layer")
        k = self.k
        state, tail = cache
        B, d = h.shape[0], h.shape[-1]
        x2 = h.reshape(B, d)
        with span("kda.proj"):
            pre = self._proj(p, x2)
        with span("kda.conv"):
            win = torch.cat([tail, pre[:, None].to(tail.dtype)], dim=1)
            y = F.silu((win.float() * self._conv_w(p).float()).sum(1))
            q, kk, v = (t.float() for t in self._qkv(y, h.dtype))
        with span("kda.gate"):
            g, beta = self._gates(p, x2)
        with span("kda.chunk"):
            s = state * torch.exp(g)[..., None]
            pred = torch.einsum("bhk,bhkv->bhv", kk, s)
            s = s + torch.einsum("bhk,bhv->bhkv", beta[..., None] * kk,
                                 v - pred)
            o = torch.einsum("bhk,bhkv->bhv", q * k.head_dim ** -0.5, s)
        with span("kda.state_write"):
            state.copy_(s)
            tail.copy_(win[:, 1:])
        with span("kda.out"):
            y = self._out(p, x2, o)
        return y.view(B, 1, d)


def kind(cfg: LMConfig) -> Union[GQA, MLA]:
    """The config's attention kind: MLA for an ``MLALMConfig`` (a hybrid's
    full-attention layers too), else GQA."""
    return MLA(cfg) if cfg.mla is not None else GQA(cfg)


def stacks(cfg: LMConfig) -> Dict[str, Union[GQA, MLA, KDA]]:
    """Parameter stack name -> its kind: ``attn`` (``kind(cfg)``), and
    ``kda`` in a hybrid."""
    out = {"attn": kind(cfg)}
    if cfg.kda is not None:
        out["kda"] = KDA(cfg)
    return out


def stack_sizes(cfg: LMConfig, n_layers: Optional[int] = None
                ) -> Dict[str, int]:
    """Layers in each stack of the first ``n_layers`` (all by default)."""
    n = cfg.n_layers if n_layers is None else n_layers
    n_kda = sum(1 for i in cfg.kda_layers if i < n)
    return {"attn": n - n_kda, **({"kda": n_kda} if cfg.kda else {})}


def layer_stack(cfg: LMConfig, i: int) -> Tuple[str, int]:
    """(stack name, position in it) of layer i's attention."""
    if i in cfg.kda_layers:
        return "kda", sum(1 for j in cfg.kda_layers if j < i)
    return "attn", i - sum(1 for j in cfg.kda_layers if j < i)


def cache_names(cfg: LMConfig) -> Tuple[str, ...]:
    """The caches of the config's stacks, in stack order."""
    return tuple(n for att in stacks(cfg).values() for n in att.cache_names)


def new_caches(cfg: LMConfig, n_layers: int, B: int, S: int,
               device) -> Tuple[torch.Tensor, ...]:
    """Every stack's zeroed caches for its layers among ``n_layers``, in
    ``cache_names`` order."""
    sizes = stack_sizes(cfg, n_layers)
    return tuple(c for name, att in stacks(cfg).items()
                 for c in att.new_caches(sizes[name], B, S, device))


def layer_caches(cfg: LMConfig, caches: Tuple[torch.Tensor, ...], i: int
                 ) -> Tuple[torch.Tensor, ...]:
    """Layer i's slices of ``caches`` (``cache_names`` order, stacked over
    the layers from 0)."""
    if cfg.kda is None:
        return tuple(c[i] for c in caches)
    name, j = layer_stack(cfg, i)
    at = 0
    for n, att in stacks(cfg).items():
        if n == name:
            return tuple(c[j] for c in caches[at:at + len(att.cache_names)])
        at += len(att.cache_names)
    raise KeyError(name)
