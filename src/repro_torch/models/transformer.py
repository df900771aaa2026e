"""Transformer stack (decoder LM / bidirectional encoder) with Recall exits.

Layer parameters are *stacked* (leading ``n_layers`` dim, the reference's
layout); ``forward_hidden`` runs layers ``[layer_start, layer_end)`` as a
Python loop over that dim, which is how coarse (early-exited) encoding and
live-encoder refinement (paper §3.4) reuse one weight set. The LM serving
path is ``prefill`` (a prompt batch into a preallocated, padded KV cache,
with the exit embeddings) and ``decode_step`` (one greedy token against
that cache, written in place).

Attention goes through the flash kernel's dispatch at prefill and the
decode kernel's at decode, the norms through the rmsnorm kernel's and MoE
layers through the grouped expert GEMM's (``models/moe.py``); the QKV, O,
SwiGLU, router and logits projections are plain ``torch.matmul``.

Training: ``lm_loss`` is the chunked cross-entropy (``chunked_xent``)
on the final norm's output through the LM head, plus the MoE layers' aux
loss; ``forward_hidden(remat=True)`` recomputes each layer in the
backward (``torch.utils.checkpoint``, the reference's per-layer
``jax.checkpoint`` that saves nothing), so a layer's flash and RMSNorm
forward kernels launch twice a step. The embedding table's gradient is
summed in float32 in a fixed order (``layers.embed_lookup``).

MLA configs (``configs.base.MLALMConfig``, DeepSeek-V3's block) take
another attention half and cache: ``_mla_qkv`` projects q (H, nope + rope)
and the latent [c_kv | k_pe], RMS-norms c_kv, applies RoPE to q's rope
part and to the one k_pe head (DeepSeek-V3's layout: the modeling file
reads a rope part as interleaved pairs and rotates it rotate-half, so
``rope_deepseek`` de-interleaves, even dims then odd, before
``apply_rope``), up-projects [k_nope | v] per head and runs the flash
forward at q/k 192, v 128 (scale 1/sqrt(192)). Prefill writes the
latent cache (L, B, S_cache, kv_lora_rank + rope): c_kv after its norm,
k_pe after RoPE. ``decode_step_mla`` attends in the absorbed form, plain
torch in fp32: q_nope·W_UK into the latent, scores against c_kv plus
q_pe·k_pe, the output through W_UV and W_o. The first ``first_k_dense``
layers are dense SwiGLUs, the rest DeepSeek-V3 MoE layers
(``moe.moe_apply_dropless``); their stacks are ``layers.mlp`` and
``layers.moe`` (``layer_params`` slices a layer). No LoRA and no training
on MLA (its flash backward raises on CUDA).

LoRA deltas (paper §3.3 P-LoRA) ride along as an optional stacked tree
(``core/plora.py``'s layout, sliced per layer like the params): on the
targets ``wq``/``wk``/``wv``/``wo``/``w_gate``/``w_up``/``w_down`` each
projection adds ``scale * ((x @ a) @ b)`` in x's dtype
(``layers.lora_delta``), where the reference adds it (the ``w_down`` delta,
in ``layers.swiglu``, reads the post-activation ``h``); the LoRA products
are plain ``torch.matmul`` too. ``lora=None`` or ``{}`` adds
nothing. Flash attention and RMSNorm are differentiable (their backward
kernels), so a loss on ``forward_hidden`` trains the LoRA on the card.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import LMConfig, RecallConfig
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models.layers import ParamDef, Schema
from repro_torch.tracing import span


def mla_schema(cfg: LMConfig, layer_dims: Tuple[int, ...] = ()) -> Schema:
    """MLA's projections: ``wq`` (d, H, nope + rope), ``w_kv_a`` (d,
    kv_lora_rank + rope), ``kv_norm`` (kv_lora_rank,), ``w_kv_b``
    (kv_lora_rank, H, nope + v), ``wo`` (H, v, d)."""
    m, d, H = cfg.mla, cfg.d_model, cfg.n_heads
    Ld = layer_dims
    la = tuple("layer" for _ in Ld)
    return {
        "wq": ParamDef(Ld + (d, H, m.qk_head_dim),
                       la + ("embed", "heads", "head_dim"), "fan_in"),
        "w_kv_a": ParamDef(Ld + (d, m.latent_dim), la + ("embed", "kv_latent"),
                           "fan_in"),
        "kv_norm": ParamDef(Ld + (m.kv_lora_rank,), la + ("kv_latent",),
                            "ones"),
        "w_kv_b": ParamDef(Ld + (m.kv_lora_rank, H,
                                 m.qk_nope_head_dim + m.v_head_dim),
                           la + ("kv_latent", "heads", "head_dim"), "fan_in"),
        "wo": ParamDef(Ld + (H, m.v_head_dim, d),
                       la + ("heads", "head_dim", "embed"), "fan_in"),
    }


def lm_schema(cfg: LMConfig, recall: RecallConfig, *, embed_out: int = 1024,
              with_lm_head: bool = True) -> Schema:
    Ld = (cfg.n_layers,)
    layer: Schema = {
        "norm1": L.rmsnorm_schema(cfg.d_model, Ld),
        "norm2": L.rmsnorm_schema(cfg.d_model, Ld),
    }
    if cfg.mla is not None:
        k = cfg.first_k_dense
        layer["attn"] = mla_schema(cfg, Ld)
        if k:
            layer["mlp"] = L.swiglu_schema(cfg.d_model, cfg.d_ff,
                                           layer_dims=(k,))
        layer["moe"] = MOE.moe_schema(cfg.d_model, cfg.moe,
                                      layer_dims=(cfg.n_layers - k,),
                                      router=cfg.router)
    else:
        layer["attn"] = L.attn_schema(cfg.d_model, cfg.n_heads,
                                      cfg.n_kv_heads, cfg.head_dim,
                                      cfg.qkv_bias, layer_dims=Ld)
        if cfg.moe is not None:
            layer["moe"] = MOE.moe_schema(cfg.d_model, cfg.moe,
                                          layer_dims=Ld)
        else:
            layer["mlp"] = L.swiglu_schema(cfg.d_model, cfg.d_ff,
                                           layer_dims=Ld)
    s: Schema = {
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
    if with_lm_head and not cfg.tie_embeddings:
        s["lm_head"] = ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                                "fan_in")
    return s


def lm_init(gen: torch.Generator, cfg: LMConfig, recall: RecallConfig, *,
            device="cuda", **kw):
    """Random LM params from ``gen`` (a generator on ``device``), in the
    config's dtype."""
    return L.init_params(gen, lm_schema(cfg, recall, **kw),
                         dtype=L.torch_dtype(cfg.dtype), device=device)


def lm_specs(cfg: LMConfig, recall: RecallConfig, **kw):
    return L.param_specs(lm_schema(cfg, recall, **kw))


def lm_abstract(cfg: LMConfig, recall: RecallConfig, **kw):
    return L.abstract_params(lm_schema(cfg, recall, **kw), dtype=cfg.dtype)


def layer_slice(tree, i: int):
    """Layer ``i`` of a stacked-layer param dict."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: layer_slice(v, i) for k, v in tree.items()}


def layer_params(layers: Schema, i: int, cfg: LMConfig) -> Schema:
    """Layer ``i``'s params: ``layer_slice``, but for a config with dense
    first layers (``first_k_dense``), whose ``mlp`` stack holds those and
    ``moe`` stack the rest, the one of the two the layer has."""
    k = cfg.first_k_dense
    if not k:
        return layer_slice(layers, i)
    out = {n: layer_slice(v, i) for n, v in layers.items()
           if n not in ("mlp", "moe")}
    if i < k:
        out["mlp"] = layer_slice(layers["mlp"], i)
    else:
        out["moe"] = layer_slice(layers["moe"], i - k)
    return out


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


def _mla_qkv(p: Schema, h: torch.Tensor, positions: torch.Tensor,
             cfg: LMConfig, latent_out: Optional[torch.Tensor] = None):
    """MLA's q (B,S,H,nope+rope), k (B,S,H,nope+rope), v (B,S,H,v) of h
    (B, S, d); ``latent_out`` (B, S', r + rope), S' >= S, takes the
    tokens' [c_kv | k_pe] at [:, :S]."""
    m = cfg.mla
    B, S, d = h.shape
    x2 = h.reshape(B * S, d)
    with span("mla.q"):
        q = _mla_q(p, x2, positions, cfg, B, S)
    with span("mla.kv_down"):
        c, k_pe = _mla_latent(p, x2, positions, cfg, B, S)
    if latent_out is not None:
        with span("mla.latent_write"):
            latent_out[:, :S, :m.kv_lora_rank] = c
            latent_out[:, :S, m.kv_lora_rank:] = k_pe
    with span("mla.kv_up"):
        w = p["w_kv_b"].to(h.dtype)
        kv = (c.reshape(B * S, -1) @ w.reshape(w.shape[0], -1)).view(
            B, S, cfg.n_heads, -1)
        nope = m.qk_nope_head_dim
        k = torch.cat([kv[..., :nope],
                       k_pe[:, :, None].expand(B, S, cfg.n_heads, -1)],
                      dim=-1)
        v = kv[..., nope:].contiguous()
    return q, k, v


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


def _attn_out(p: Schema, o: torch.Tensor, lora: Optional[Dict] = None,
              lora_scale: float = 0.0) -> torch.Tensor:
    B, S, H, hd = o.shape
    wo = p["wo"].to(o.dtype)                             # (H, hd, d)
    o2 = o.reshape(B * S, H * hd)
    y = (o2 @ wo.reshape(H * hd, -1)).view(B, S, -1)
    if lora and "wo" in lora:
        y = y + L.lora_delta(o2, lora["wo"], lora_scale).view(B, S, -1)
    return y


def _ffn(pl_: Schema, h: torch.Tensor, cfg: LMConfig,
         lora: Optional[Dict] = None, lora_scale: float = 0.0):
    """(y, aux): the MoE layer (aux its loss; LoRA has no MoE target; a
    ``router`` config's layer is dropless, aux 0) or the dense SwiGLU (aux
    None)."""
    if "moe" in pl_:
        if cfg.router is not None:
            return MOE.moe_apply_dropless(pl_["moe"], h, cfg.moe, cfg.router)
        return MOE.moe_apply(pl_["moe"], h, cfg.moe)
    return L.swiglu(pl_["mlp"], h, lora, lora_scale), None


def layer_full(pl_: Schema, x: torch.Tensor, cfg: LMConfig,
               positions: Optional[torch.Tensor], *, window: int,
               lora: Optional[Dict] = None, lora_scale: float = 0.0,
               latent_out: Optional[torch.Tensor] = None):
    """Self-attention layer over the full (own) sequence -> (x, (k, v),
    aux or None). ``lora`` is this layer's slice. An MLA layer writes its
    latent rows into ``latent_out`` (when given) and returns (k, v) as
    the flash forward took them."""
    with span("layer.attn"):
        h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
        if cfg.mla is not None:     # flash's scale: 1/sqrt(nope + rope)
            q, k, v = _mla_qkv(pl_["attn"], h, positions, cfg, latent_out)
        else:
            q, k, v = _proj_qkv(pl_["attn"], h, positions, cfg.rope_theta,
                                lora, lora_scale)
        o = flash_attention(q, k, v, causal=cfg.causal, window=window)
        x = x + _attn_out(pl_["attn"], o, lora, lora_scale)
    with span("layer.mlp"):
        h2 = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
        y, aux = _ffn(pl_, h2, cfg, lora, lora_scale)
        x = x + y
    return x, (k, v), aux


def _cache_row(lengths: torch.Tensor, S: int) -> torch.Tensor:
    """The cache row of each sequence's new token (the reference's
    ``dynamic_update_slice_in_dim``: a negative index counts from the end,
    then clamped)."""
    at = lengths.long() - 1
    return torch.clamp(torch.where(at < 0, at + S, at), 0, S - 1)


def layer_decode(pl_: Schema, x: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, lengths: torch.Tensor, cfg: LMConfig,
                 *, window: int, lora: Optional[Dict] = None,
                 lora_scale: float = 0.0):
    """One-token step. x (B,1,d); k/v_cache (B,S,KV,hd) of this layer;
    lengths (B,) int32 is the sequence length *including* the new token
    (the query sits at lengths-1). The new token's k/v are written into the
    caches in place at lengths-1, placed as the reference's
    ``dynamic_update_slice_in_dim`` places it: a negative index counts from
    the end, then the index is clamped to [0, S-1]. Returns (x, aux or
    None)."""
    B, S = k_cache.shape[:2]
    h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
    positions = (lengths - 1)[:, None]
    q, k_new, v_new = _proj_qkv(pl_["attn"], h, positions, cfg.rope_theta,
                                lora, lora_scale)
    rows = torch.arange(B, device=x.device)
    at = _cache_row(lengths, S)
    k_cache[rows, at] = k_new[:, 0]
    v_cache[rows, at] = v_new[:, 0]
    o = decode_attention(q[:, 0].contiguous(), k_cache, v_cache, lengths,
                         window=window)
    x = x + _attn_out(pl_["attn"], o[:, None], lora, lora_scale)
    h2 = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
    y, aux = _ffn(pl_, h2, cfg, lora, lora_scale)
    return x + y, aux


def forward_hidden(params: Schema, cfg: LMConfig, recall: RecallConfig, *,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   lora=None,
                   layer_start: int = 0, layer_end: Optional[int] = None,
                   collect_pooled: bool = False, pool: str = "mean",
                   return_kv: bool = False,
                   kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   remat: bool = False,
                   window: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Run layers [layer_start, layer_end) on ``embeds`` (B, S, d) or on
    the embedding rows of ``tokens`` (B, S). Returns {"h": (B, S, d) final
    hidden, "aux": f32 scalar (the MoE layers' aux loss), "pooled":
    (L', B, d) per-layer pooled hidden (if collect_pooled; ``mask`` (B, S)
    makes the mean pool a masked mean), "kv": (k, v) caches of shape
    (L', B, S', KV, hd) (if return_kv; an MLA config's is one latent cache
    (L', B, S', kv_lora_rank + rope))}. With ``kv_cache`` the layers' k/v
    are written into those caches at [i - layer_start, :, :S] (S' >= S; a
    prefill into a preallocated padded cache); without it caches of exactly
    S are allocated. ``lora`` (stacked over all n_layers) adds its deltas at
    scale ``recall.lora_alpha / recall.lora_rank``. ``remat`` keeps no
    layer's activations for the backward but its input, and runs the layer
    again there."""
    if pool not in ("cls", "mean"):
        raise ValueError(f"pool={pool!r}")
    if embeds is None:
        with span("lm.embed"):
            embeds = L.embed_lookup(params["embed"], tokens).to(
                L.torch_dtype(cfg.dtype))
    x = embeds
    B, S, _ = x.shape
    positions = None
    if cfg.rope_theta > 0:
        positions = torch.arange(S, device=x.device)[None, :].expand(B, S)
    layer_end = cfg.n_layers if layer_end is None else layer_end
    window = cfg.window if window is None else window
    mla = cfg.mla is not None
    if return_kv and kv_cache is None:
        if mla:
            kv_cache = x.new_empty((layer_end - layer_start, B, S,
                                    cfg.mla.latent_dim))
        else:
            shape = (layer_end - layer_start, B, S, cfg.n_kv_heads,
                     cfg.head_dim)
            kv_cache = (x.new_empty(shape), x.new_empty(shape))
    lora_scale = recall.lora_alpha / recall.lora_rank
    pooled, aux = [], None
    for i in range(layer_start, layer_end):
        lat = kv_cache[i - layer_start] if mla and return_kv else None
        run = lambda x_, p_, l_: layer_full(p_, x_, cfg, positions,
                                            window=window, lora=l_,
                                            lora_scale=lora_scale,
                                            latent_out=lat)
        p_i = layer_params(params["layers"], i, cfg)
        l_i = layer_slice(lora, i) if lora else None
        if remat and torch.is_grad_enabled():
            x, (k, v), aux_l = torch.utils.checkpoint.checkpoint(
                run, x, p_i, l_i, use_reentrant=False,
                preserve_rng_state=False)
        else:
            x, (k, v), aux_l = run(x, p_i, l_i)
        if aux_l is not None:
            aux = aux_l if aux is None else aux + aux_l
        if return_kv and not mla:
            with span("layer.kv_write"):
                kv_cache[0][i - layer_start, :, :S] = k
                kv_cache[1][i - layer_start, :, :S] = v
        if collect_pooled:
            with span("layer.pool"):
                if pool == "cls":
                    p = x[:, 0]
                elif mask is not None:
                    m = mask[..., None].float()
                    p = ((x.float() * m).sum(1)
                         / torch.clamp_min(m.sum(1), 1.0)).to(x.dtype)
                else:
                    p = x.float().mean(1).to(x.dtype)
            pooled.append(p)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    out = {"h": x, "aux": aux}
    if collect_pooled:
        out["pooled"] = torch.stack(pooled) if pooled else \
            x.new_zeros((0,) + x.shape[:1] + x.shape[2:])
    if return_kv:
        out["kv"] = kv_cache
    return out


def exit_embedding(params: Schema, pooled: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """pooled (..., d) -> L2-normalized embedding (..., E) via the shared
    exit head, in fp32."""
    with span("layer.exit_head"):
        h = L.rmsnorm(pooled, params["exit_head"]["norm"], eps)
        e = h.float() @ params["exit_head"]["proj"].float()
        return L.l2_normalize(e)


# ---------------------------------------------------------------------------
# LM exit API (paper §3.4): every exit at once, one exit, resume from a cache
# ---------------------------------------------------------------------------


def encode_exits(params: Schema, cfg: LMConfig, recall: RecallConfig,
                 tokens=None, embeds=None, mask=None, lora=None,
                 **fw_kw) -> Dict:
    """Embed at every exit granularity in one full-depth pass: {"exit_embs":
    (n_exits, B, E), "exits": the exit layers, "pooled": (L, B, d) every
    layer's pooled state, "h": (B, S, d), "aux"}. The exit head runs once
    over the stacked (n_exits * B, d) pooled rows."""
    out = forward_hidden(params, cfg, recall, tokens=tokens, embeds=embeds,
                         mask=mask, lora=lora, collect_pooled=True, **fw_kw)
    exits = recall.exit_layers(cfg.n_layers)
    idx = torch.tensor([e - 1 for e in exits], device=out["h"].device)
    embs = exit_embedding(params, out["pooled"][idx], cfg.norm_eps)
    return {"exit_embs": embs, "exits": exits, "pooled": out["pooled"],
            "h": out["h"], "aux": out["aux"]}


def encode_at(params: Schema, cfg: LMConfig, recall: RecallConfig, e: int,
              tokens=None, embeds=None, mask=None, lora=None,
              **fw_kw) -> Dict:
    """The coarse embedding at exit depth ``e``, running only layers
    [0, e): {"emb": (B, E), "h": (B, S, d) the layer-e activations a store
    caches, "pooled_last": (B, d)}."""
    out = forward_hidden(params, cfg, recall, tokens=tokens, embeds=embeds,
                         mask=mask, lora=lora, layer_end=e,
                         collect_pooled=True, **fw_kw)
    emb = exit_embedding(params, out["pooled"][-1], cfg.norm_eps)
    return {"emb": emb, "h": out["h"], "pooled_last": out["pooled"][-1]}


def refine_from(params: Schema, cfg: LMConfig, recall: RecallConfig,
                h_cached: torch.Tensor, start: int, mask=None, lora=None,
                **fw_kw) -> Dict:
    """Live-encoder refinement (§3.4): continue from cached layer-``start``
    activations to the full-depth embedding: {"emb": (B, E), "h"}. The
    layers run on the same inputs as a full pass, so ``h`` and the last
    pooled state equal ``encode_exits``' bit for bit."""
    out = forward_hidden(params, cfg, recall, embeds=h_cached, mask=mask,
                         lora=lora, layer_start=start, collect_pooled=True,
                         **fw_kw)
    emb = exit_embedding(params, out["pooled"][-1], cfg.norm_eps)
    return {"emb": emb, "h": out["h"]}


# ---------------------------------------------------------------------------
# LM loss and serving steps
# ---------------------------------------------------------------------------


def lm_head(params: Schema, cfg: LMConfig) -> torch.Tensor:
    """The (d, V) logits head: the embedding table's transpose when tied."""
    if cfg.tie_embeddings or "lm_head" not in params:
        return params["embed"].T
    return params["lm_head"]


def chunked_xent(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 chunk: int = 1024) -> torch.Tensor:
    """Mean token cross-entropy of ``h`` (B, S, D) through ``head`` (D, V)
    without the whole (B, S, V) logits: S in chunks of ``chunk`` (which
    must divide it), each chunk's logits made in h's dtype, then taken to
    float32. ``mask`` (B, S) weights the tokens (the mean is over its
    sum)."""
    B, S, D = h.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S {S}")
    head = head.to(h.dtype)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    cnt = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, S, chunk):
        logits = (h[:, c:c + chunk] @ head).float()        # (B, c, V)
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1,
                          labels[:, c:c + chunk].long()[..., None])[..., 0]
        if mask is None:
            tot = tot + (lse - ll).sum()
            cnt = cnt + lse.numel()
        else:
            m = mask[:, c:c + chunk].float()
            tot = tot + ((lse - ll) * m).sum()
            cnt = cnt + m.sum()
    return tot / torch.clamp_min(cnt, 1.0)


def lm_loss(params: Schema, cfg: LMConfig, recall: RecallConfig,
            tokens: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None, *, chunk: int = 1024,
            lora=None, remat: bool = False, window: Optional[int] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(xent + the MoE aux loss, {"xent", "aux"}) of next-token
    ``labels`` (B, S) for ``tokens`` (B, S)."""
    out = forward_hidden(params, cfg, recall, tokens=tokens, mask=mask,
                         lora=lora, remat=remat, window=window)
    h = L.rmsnorm(out["h"], params["final_norm"], cfg.norm_eps)
    loss = chunked_xent(h, lm_head(params, cfg), labels, mask, chunk=chunk)
    return loss + out["aux"], {"xent": loss, "aux": out["aux"]}


def prefill(params: Schema, cfg: LMConfig, recall: RecallConfig,
            tokens: torch.Tensor, pad_to: Optional[int] = None, **fw_kw):
    """Prefill: the KV caches (L, B, max(S, pad_to), KV, hd), zero past S,
    the final hidden, the exit embeddings (n_exits, B, E) and the aux loss.
    The caches are allocated once at their padded size and each layer's k/v
    written into them (the reference stacks, then pads). An MLA config
    returns one ``latent_cache`` (L, B, max(S, pad_to), kv_lora_rank +
    rope) instead of ``k_cache`` and ``v_cache``."""
    B, S = tokens.shape
    S_cache = max(S, pad_to or 0)
    dt = L.torch_dtype(cfg.dtype)
    with span("lm.caches"):
        if cfg.mla is not None:
            caches = torch.zeros((cfg.n_layers, B, S_cache,
                                  cfg.mla.latent_dim), dtype=dt,
                                 device=tokens.device)
            kv = {"latent_cache": caches}
        else:
            shape = (cfg.n_layers, B, S_cache, cfg.n_kv_heads, cfg.head_dim)
            caches = (torch.zeros(shape, dtype=dt, device=tokens.device),
                      torch.zeros(shape, dtype=dt, device=tokens.device))
            kv = {"k_cache": caches[0], "v_cache": caches[1]}
    out = forward_hidden(params, cfg, recall, tokens=tokens, return_kv=True,
                         kv_cache=caches, collect_pooled=True, **fw_kw)
    exits = recall.exit_layers(cfg.n_layers)
    idx = torch.tensor([e - 1 for e in exits], device=tokens.device)
    embs = exit_embedding(params, out["pooled"][idx], cfg.norm_eps)
    return {**kv, "h": out["h"], "exit_embs": embs, "aux": out["aux"]}


def decode_step(params: Schema, cfg: LMConfig, recall: RecallConfig,
                token: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *, lora=None,
                window: Optional[int] = None):
    """token (B,); caches (L,B,S,KV,hd); lengths (B,) incl. the new token.
    Returns (logits (B,V) f32, k_cache, v_cache): the caches are the same
    tensors, the new token's k/v written in place. ``lora`` adds its deltas
    at the scale of the default ``RecallConfig()``, not ``recall``'s, as the
    reference's ``decode_step`` does."""
    lora_scale = RecallConfig().lora_alpha / RecallConfig().lora_rank
    with span("lm.embed"):
        x = L.embed_lookup(params["embed"], token[:, None]).to(
            L.torch_dtype(cfg.dtype))
    window = cfg.window if window is None else window
    lengths = lengths.to(torch.int32)
    for i in range(cfg.n_layers):
        x, _ = layer_decode(layer_params(params["layers"], i, cfg), x,
                            k_cache[i],
                            v_cache[i], lengths, cfg, window=window,
                            lora=layer_slice(lora, i) if lora else None,
                            lora_scale=lora_scale)
    h = L.rmsnorm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return h.float() @ lm_head(params, cfg).float(), k_cache, v_cache


def layer_decode_mla(pl_: Schema, x: torch.Tensor, latent: torch.Tensor,
                     lengths: torch.Tensor, cfg: LMConfig):
    """One-token MLA step. x (B, 1, d); latent (B, S, r + rope) of this
    layer, the new token's [c_kv | k_pe] written in place at lengths - 1;
    attention over the first ``lengths`` rows in the absorbed form, in
    fp32: q_lat = q_nope W_UK (r wide), scores q_lat·c_kv + q_pe·k_pe at
    1/sqrt(nope + rope), o = (p c_kv) W_UV, then W_o. Returns (x, aux)."""
    m = cfg.mla
    B, S = latent.shape[:2]
    r, nope = m.kv_lora_rank, m.qk_nope_head_dim
    with span("layer.attn"):
        h = L.rmsnorm(x, pl_["norm1"], cfg.norm_eps)
        positions = (lengths - 1)[:, None]
        p = pl_["attn"]
        h2 = h.reshape(B, -1)
        with span("mla.q"):
            q = _mla_q(p, h2, positions, cfg, B, 1)[:, 0].float()
        with span("mla.kv_down"):
            c, k_pe = _mla_latent(p, h2, positions, cfg, B, 1)
        with span("mla.latent_write"):
            rows = torch.arange(B, device=x.device)
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
            live = torch.arange(S, device=x.device)[None, :] \
                < lengths.long()[:, None]
            s = s.masked_fill(~live[:, None, :], float("-inf"))
            o_lat = torch.einsum("bhs,bsr->bhr", torch.softmax(s, -1),
                                 lat[..., :r])
            o = torch.einsum("bhr,rhv->bhv", o_lat, w[..., nope:])
        x = x + _attn_out(p, o.to(x.dtype)[:, None])
    with span("layer.mlp"):
        h2 = L.rmsnorm(x, pl_["norm2"], cfg.norm_eps)
        y, aux = _ffn(pl_, h2, cfg)
    return x + y, aux


def decode_step_mla(params: Schema, cfg: LMConfig, recall: RecallConfig,
                    token: torch.Tensor, latent_cache: torch.Tensor,
                    lengths: torch.Tensor):
    """token (B,); latent_cache (L, B, S, r + rope); lengths (B,) incl.
    the new token. Returns (logits (B, V) f32, latent_cache), the cache
    written in place."""
    if cfg.window:
        raise NotImplementedError("MLA decode with a sliding window")
    with span("lm.embed"):
        x = L.embed_lookup(params["embed"], token[:, None]).to(
            L.torch_dtype(cfg.dtype))
    lengths = lengths.to(torch.int32)
    for i in range(cfg.n_layers):
        x, _ = layer_decode_mla(layer_params(params["layers"], i, cfg), x,
                                latent_cache[i], lengths, cfg)
    h = L.rmsnorm(x[:, 0], params["final_norm"], cfg.norm_eps)
    return h.float() @ lm_head(params, cfg).float(), latent_cache
